// Device code of the whole-KV attention over many small instances, shared
// by kernel B2 (windowed_attention.cu: (B, H, L, hd) operands at any
// strides) and kernel B11 (packed_heads_attention.cu: the head-packed (B, L,
// heads * hd) layout, heads read at a column offset). The design notes are
// in windowed_attention.cu: bf16 on the tensor cores (win_mma_kernel),
// float32 on FMAs (win_fma_kernel).
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int W_WARPS = 4;
constexpr int W_THREADS = 32 * W_WARPS;
// shared memory a block may take: two blocks (eight warps) an SM at least;
// registers are capped at 128 a thread for four
constexpr int W_SMEM_MAX = 113 * 1024;

// scores of the warp's 16 query rows against the nj * 8 keys of a chunk
// (k rows in shared memory, stride LDS), times scale; keys at or past
// kv_len at -1e30
template <int KT, int LDS>
__device__ __forceinline__ void chunk_scores(float (&s)[8][4],
                                             const uint32_t (&qa)[KT][4],
                                             const bf16* k_s, int nj, int c0,
                                             int kv_len, float scale) {
  const int lane = threadIdx.x & 31;
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      if (2 * jj < nj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, k_s + (16 * jj + b_row) * LDS + 16 * kt + b_col);
        mma_bf16(s[2 * jj], qa[kt], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qa[kt], kf[2], kf[3]);
      }
    }
  }
  const bool edge = c0 + 8 * nj > kv_len;
  const int c = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] *= scale;
      if (edge && c0 + 8 * j + 2 * c + (e & 1) >= kv_len) s[j][e] = -1e30f;
    }
}

// HD: the head size (a multiple of 8). One warp owns a 16-row query tile of
// one instance. Block mode (Lq > 16): a block takes up to four row tiles of
// one instance and its warps share the instance's k / v chunks. Warp mode
// (Lq <= 16): each warp takes a whole instance, rows padded to 16, with its
// own chunks. Keys stream in chunks of KC (a multiple of 16, at most 64),
// nbuf (1 or 2) buffers of k and v each.
template <int HD>
__global__ void __launch_bounds__(W_THREADS, 4)
win_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out, int H,
               int n_inst, int Lq, int kv_len, float scale, Strides st,
               int vshift, int KC, int nbuf, int row_blocks, bool warp_mode) {
  constexpr int NT = HD / 8;
  constexpr int KT = (HD + 15) / 16;
  constexpr int LDS = 16 * KT + 8;  // odd 16-byte units: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // W_WARPS x 16 x LDS
  bf16* kv_s = q_s + W_WARPS * 16 * LDS;
  const int slot = nbuf * 2 * KC * LDS;  // the k / v buffers of one team

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;

  // columns [HD, 16 KT) are read by q . k but never loaded
  constexpr int PAD = 16 * KT - HD;
  if constexpr (PAD > 0) {
    const int rows = W_WARPS * 16 + (warp_mode ? W_WARPS : 1) * slot / LDS;
    for (int i = tid; i < rows * PAD; i += W_THREADS)
      q_s[(i / PAD) * LDS + HD + i % PAD] = __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  int inst, row0, team_tid, team_n;
  bf16* kv_t;
  if (warp_mode) {
    inst = blockIdx.x * W_WARPS + warp;
    if (inst >= n_inst) return;  // no block-wide barrier follows
    row0 = 0;
    team_tid = lane;
    team_n = 32;
    kv_t = kv_s + warp * slot;
  } else {
    inst = blockIdx.x / row_blocks;
    row0 = 16 * ((blockIdx.x % row_blocks) * W_WARPS + warp);
    team_tid = tid;
    team_n = W_THREADS;
    kv_t = kv_s;
  }
  const bool rows_here = row0 < Lq;
  const int b = inst / H, h = inst % H;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  bf16* q_w = q_s + warp * 16 * LDS;
  load_rows(q_w, LDS, qb, st.ql, row0, 16, Lq, HD, vshift, lane, 32);

  // steps: pass 1 over the chunks (k), then pass 2 (k and v); one chunk
  // holds every key when n_chunks == 1, and pass 2 then loads v alone
  const int n_chunks = (kv_len + KC - 1) / KC;
  const int steps = 2 * n_chunks;
  // the last chunk holds the keys left, rounded up to 16
  auto chunk_rows = [&](int c0) {
    return min(KC, (kv_len - c0 + 15) / 16 * 16);
  };
  auto issue = [&](int s) {
    const int pass2 = s >= n_chunks;
    const int c0 = (s - pass2 * n_chunks) * KC;
    const int rows = chunk_rows(c0);
    bf16* kbuf = kv_t + (nbuf == 1 ? 0 : (s & 1)) * 2 * KC * LDS;
    if (!(pass2 && n_chunks == 1))
      load_rows(kbuf, LDS, kb, st.kl, c0, rows, kv_len, HD, vshift, team_tid,
                team_n);
    if (pass2)
      load_rows(kbuf + KC * LDS, LDS, vb, st.vl, c0, rows, kv_len, HD, vshift,
                team_tid, team_n);
    cp_async_commit();
  };
  auto team_sync = [&]() {
    if (warp_mode)
      __syncwarp();
    else
      __syncthreads();
  };

  uint32_t qa[KT][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // pass 1 keeps each lane's running max and sum over its own columns; the
  // quad that shares a row combines them before pass 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);

  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    team_sync();
    if (s == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        ldmatrix_x4(qa[kt], q_w + a_row * LDS + 16 * kt + a_col);
    }
    const int pass2 = s >= n_chunks;
    const int c0 = (s - pass2 * n_chunks) * KC;
    const int nj = chunk_rows(c0) / 8;  // n8 key tiles, even
    const bf16* kbuf = kv_t + (nbuf == 1 ? 0 : (s & 1)) * 2 * KC * LDS;
    if (rows_here) {
      float sc[8][4];
      chunk_scores<KT, LDS>(sc, qa, kbuf, nj, c0, kv_len, scale);
      if (!pass2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = m[hh];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nj) mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
            if (j < nj)
              sum += expf(sc[j][2 * hh] - mx) + expf(sc[j][2 * hh + 1] - mx);
          l[hh] = l[hh] * expf(m[hh] - mx) + sum;
          m[hh] = mx;
        }
      } else {
        if (s == n_chunks) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float mx = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            float sum = l[hh] * expf(m[hh] - mx);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            m[hh] = mx;
            l[hh] = sum;
            rl[hh] = 1.f / sum;
          }
        }
        // the reference's rounding point: normalized, then rounded
        const bf16* vbuf = kbuf + KC * LDS;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (2 * kk < nj) {
            uint32_t pa[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int hh = r & 1;
              const float* pr = &sc[2 * kk + (r >> 1)][2 * hh];
              pa[r] = pack_bf16(
                  div_by_sum(expf(pr[0] - m[hh]), l[hh], rl[hh]),
                  div_by_sum(expf(pr[1] - m[hh]), l[hh], rl[hh]));
            }
            const bf16* vrow = vbuf + (16 * kk + a_row) * LDS;
#pragma unroll
            for (int np = 0; np < NT / 2; ++np) {
              uint32_t vf[4];
              ldmatrix_x4_trans(vf, vrow + 16 * np + a_col);
              mma_bf16(o[2 * np], pa, vf[0], vf[1]);
              mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
            }
            if (NT & 1) {
              uint32_t vf[2];
              ldmatrix_x2_trans(vf, vrow + 8 * (NT - 1));
              mma_bf16(o[NT - 1], pa, vf[0], vf[1]);
            }
          }
        }
      }
    }
    team_sync();  // this step's buffer is refilled two steps on
  }

  if (!rows_here) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + 8 * hh;
    if (row >= Lq) continue;
    bf16* orow = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * c) =
          __floats2bfloat162_rn(o[n][2 * hh], o[n][2 * hh + 1]);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int Lq, int kv_len,
                       float scale, const Strides& st, cudaStream_t stream) {
  constexpr int LDS = 16 * ((HD + 15) / 16) + 8;
  const int n_inst = B * H;
  const bool warp_mode = Lq <= 16;
  const int teams = warp_mode ? W_WARPS : 1;
  int KC = kv_len < 64 ? (kv_len + 15) / 16 * 16 : 64;
  int nbuf;
  size_t smem;
  for (;;) {
    nbuf = kv_len > KC ? 2 : 1;
    smem = sizeof(bf16) * (W_WARPS * 16 + teams * nbuf * 2 * KC) * LDS;
    if (smem <= (size_t)W_SMEM_MAX || KC == 16) break;
    KC = (KC / 2 + 15) / 16 * 16;
  }
  const void* ptrs[3] = {q, k, v};
  const long long in_strides[9] = {st.qb, st.qh, st.ql, st.kb, st.kh,
                                   st.kl, st.vb, st.vh, st.vl};
  const int vshift = vector_shift(ptrs, 3, in_strides, 9, HD);
  const int row_blocks = ((Lq + 15) / 16 + W_WARPS - 1) / W_WARPS;
  const long long grid = warp_mode ? (n_inst + W_WARPS - 1) / W_WARPS
                                   : (long long)n_inst * row_blocks;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      win_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  win_mma_kernel<HD><<<(unsigned)grid, W_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, n_inst, Lq,
      kv_len, scale, st, vshift, KC, nbuf, row_blocks, warp_mode);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int THREADS = 128;
constexpr int KC_MAX = 64;
constexpr int SMEM_BUDGET = 96 * 1024;

// four consecutive elements, as one 16-byte read where aligned
__device__ __forceinline__ float4 load4(const float* p, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], p[1], p[2], p[3]);
}

template <int HD>
__device__ __forceinline__ float dot_row(const float (&qr)[HD],
                                         const float* __restrict__ kr) {
  const float4* k4 = reinterpret_cast<const float4*>(kr);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) {
    const float4 kk = k4[i];
    a0 = fmaf(qr[4 * i], kk.x, a0);
    a1 = fmaf(qr[4 * i + 1], kk.y, a1);
    a2 = fmaf(qr[4 * i + 2], kk.z, a2);
    a3 = fmaf(qr[4 * i + 3], kk.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// rows [c0, c0 + nk) of g_n instances starting at inst0 -> dst, four
// elements per read
template <int HD>
__device__ __forceinline__ void load_chunk(const float* __restrict__ src,
                                           float* __restrict__ dst, int inst0,
                                           int g_n, int H, int c0, int nk,
                                           int IS, long long sb, long long sh,
                                           long long sl, bool vec) {
  constexpr int HD4 = HD / 4;
  const int per = nk * HD4;
  for (int i = threadIdx.x; i < g_n * per; i += THREADS) {
    const int g = i / per, rem = i - g * per;
    const int j = rem / HD4, e = (rem - j * HD4) * 4;
    const int in = inst0 + g;
    const float* row = src + (in / H) * sb + (in % H) * sh + (c0 + j) * sl;
    *reinterpret_cast<float4*>(dst + g * IS + j * HD + e) = load4(row + e, vec);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
win_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int H,
               int n_inst, int Lq, int kv_len, float scale, int G, int KC,
               int R, int chunks, Strides st, bool vec) {
  const int IS = KC * HD + 4;  // one instance's chunk in shared memory
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // G x IS
  float* v_s = k_s + G * IS;                      // G x IS

  const int tid = threadIdx.x;
  const int g = tid / R;
  const int chunk = blockIdx.x % chunks;
  const int inst0 = (blockIdx.x / chunks) * G;
  const int g_n = min(G, n_inst - inst0);
  const int inst = inst0 + g;
  const int row = chunk * R + tid % R;
  const bool active = g < g_n && row < Lq;
  const int b = active ? inst / H : 0;
  const int h = active ? inst % H : 0;

  float qr[HD];
  const float* qrow = q + b * st.qb + h * st.qh + row * st.ql;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = active ? load4(qrow + d, vec)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    qr[d] = x.x;
    qr[d + 1] = x.y;
    qr[d + 2] = x.z;
    qr[d + 3] = x.w;
  }

  // pass 1: row max and sum of exp over the keys < kv_len (keys past it
  // would get exp(-1e30 - m) = 0)
  float m = -INFINITY, l = 0.f;
  for (int c0 = 0; c0 < kv_len; c0 += KC) {
    const int nk = min(KC, kv_len - c0);
    __syncthreads();
    load_chunk<HD>(k, k_s, inst0, g_n, H, c0, nk, IS, st.kb, st.kh, st.kl,
                   vec);
    __syncthreads();
    if (active) {
      const float* kg = k_s + g * IS;
      for (int j = 0; j < nk; ++j) {
        const float s = dot_row<HD>(qr, kg + j * HD) * scale;
        const float mn = fmaxf(m, s);
        l = l * expf(m - mn) + expf(s - mn);
        m = mn;
      }
    }
  }

  // pass 2: normalized weights times v
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int c0 = 0; c0 < kv_len; c0 += KC) {
    const int nk = min(KC, kv_len - c0);
    __syncthreads();
    // one chunk holds all keys: pass 1 left it in shared memory
    if (kv_len > KC)
      load_chunk<HD>(k, k_s, inst0, g_n, H, c0, nk, IS, st.kb, st.kh, st.kl,
                     vec);
    load_chunk<HD>(v, v_s, inst0, g_n, H, c0, nk, IS, st.vb, st.vh, st.vl,
                   vec);
    __syncthreads();
    if (active) {
      const float* kg = k_s + g * IS;
      const float* vg = v_s + g * IS;
      for (int j = 0; j < nk; ++j) {
        const float s = dot_row<HD>(qr, kg + j * HD) * scale;
        const float p = expf(s - m) / l;
        const float4* v4 = reinterpret_cast<const float4*>(vg + j * HD);
#pragma unroll
        for (int i = 0; i < HD / 4; ++i) {
          const float4 vv = v4[i];
          acc[4 * i] = fmaf(p, vv.x, acc[4 * i]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
    }
  }
  if (active) {
    float* o = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = acc[d];
  }
}

template <int HD>
cudaError_t launch_fma(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int Lq, int kv_len,
                       float scale, const Strides& st, cudaStream_t stream) {
  const int n_inst = B * H;
  const int KC = kv_len < KC_MAX ? kv_len : KC_MAX;
  const int per_inst = 2 * (KC * HD + 4) * (int)sizeof(float);
  int R, G, chunks;
  if (Lq <= THREADS) {
    R = Lq;
    G = THREADS / Lq;
    const int fit = SMEM_BUDGET / per_inst;
    G = G < fit ? G : (fit > 1 ? fit : 1);
    G = G < n_inst ? G : n_inst;
    chunks = 1;
  } else {
    R = THREADS;
    G = 1;
    chunks = (Lq + THREADS - 1) / THREADS;
  }
  // four elements a read: 16-byte reads where pointers and strides allow
  const void* ptrs[3] = {q, k, v};
  const long long in_strides[9] = {st.qb, st.qh, st.ql, st.kb, st.kh,
                                   st.kl, st.vb, st.vh, st.vl};
  bool vec = true;
  for (int i = 0; i < 3; ++i)
    vec = vec && reinterpret_cast<uintptr_t>(ptrs[i]) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && in_strides[i] % 4 == 0;
  const size_t smem = (size_t)G * per_inst;
  cudaError_t err = cudaFuncSetAttribute(
      win_fma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n_inst + G - 1) / G * chunks;
  win_fma_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, n_inst, Lq,
      kv_len, scale, G, KC, R, chunks, st, vec);
  return cudaGetLastError();
}

// dtype 0 = float32 (FMA design), 1 = bfloat16 (tensor cores); hd one of
// WINDOWED_HEAD_DIMS
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Lq, int hd, int kv_len, float scale,
                     int dtype, const Strides& st, cudaStream_t s) {
#define OVO_WIN_HD(N)                                                       \
  case N:                                                                   \
    return dtype == 0                                                       \
        ? launch_fma<N>(q, k, v, out, B, H, Lq, kv_len, scale, st, s)       \
        : launch_mma<N>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    OVO_WIN_HD(16) OVO_WIN_HD(32) OVO_WIN_HD(48) OVO_WIN_HD(56)
    OVO_WIN_HD(64) OVO_WIN_HD(72) OVO_WIN_HD(80) OVO_WIN_HD(96)
    OVO_WIN_HD(112) OVO_WIN_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef OVO_WIN_HD
}

}  // namespace
