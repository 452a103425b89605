// Streaming-softmax attention over (B, H, L, D) for long sequences.
//
// Replaces: ovo_tpu/ops/attention.py flash_attention / _flash_kernel (the
// Pallas TPU kernel the Hiera global-attention blocks run through).
//
// What it computes, per (batch b, head h), exactly as _flash_kernel does:
//   q'  = q * scale in f32 (before the dot, as the reference);
//   s   = q' . k in f32, keys >= kv_len set to -1e30;
//   out = (sum_j exp(s_j - m) v_j) / max(sum_j exp(s_j - m), 1e-30) with an
//         f32 running max m, running sum and accumulator; the weights stay in
//         f32 (the reference never rounds them), the output is rounded once.
//
// What bounds it on an H100: at the Hiera-L global shape (1 x 8 heads,
// L = 4096, hd = 72, bf16) one launch needs 4 L^2 hd H = 38.7 GFLOP and moves
// 4 x 4.7 MB, so the tensor cores (989 TF/s bf16) bound it at ~39 us: it is
// bound by operations.
//
// bf16 design (tensor cores, FlashAttention-2's layout): one block of eight
// warps per (b*h, 128-query tile); each warp owns 16 query rows, whose q
// fragments it keeps in registers. Registers are capped at 128 a thread, so
// two blocks share an SM: at the Hiera-L shape the 256 blocks take the 132
// SMs in one wave (four warps to a block ran slower: two waves, and each k /
// v tile feeds half as many rows). 64-key tiles of k and v stream through
// shared memory as bf16, double-buffered with cp.async (16 bytes a copy
// where every pointer and stride allows, else 8, 4 or 2), so the next tile
// loads while the warps multiply the current one. S = q . k runs on
// mma.sync m16n8k16 (bf16 in, f32 out) and is then multiplied by scale:
// that is the reference's (q * scale) . k up to f32 rounding, since a bf16
// x bf16 product is exact in f32. Row max and sum reduce over the quad of
// lanes that holds a row; the accumulator is rescaled by alpha as in the
// reference. The weights are not rounded to bf16: each is split into
// p_hi = bf16(p) and p_lo = bf16(p - p_hi), and p . v accumulates p_hi . v
// + p_lo . v on two mma (about 16 bits of each weight, against bf16's 8;
// the score C fragments are the p . v A fragments, lane for lane). Head
// sizes that are not multiples of 16 (72) are zero-padded in shared memory
// to the next 16 for q . k; p . v covers ceil(hd / 8) n8 tiles. Shared rows
// are padded by 8 elements (an odd number of 16-byte units), so ldmatrix's
// eight row reads hit eight distinct bank groups. Tiles wholly past kv_len
// are skipped (the reference gives their keys exp(-1e30 - m) = 0), and keys
// are masked in the last tile only. The first design (f32 FMAs on the CUDA
// cores, 4 x 4 micro-tiles per thread) took 2.155 ms at the Hiera-L shape.
//
// float32 keeps that FMA design (the f32 route of tests and of f32
// towers): one block of 256 threads per (b*h, 64-query tile), the scaled q
// tile and 64-key k / v tiles in shared memory as f32, each thread a 4x4
// score micro-tile and 4 rows x ceil(hd/16) column groups of the output.
//
// Any (b, h, l) strides with a unit last stride are taken, so head-split
// views of a packed projection and token-major outputs need no copy.
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

constexpr int MMA_WARPS = 8;
constexpr int MMA_THREADS = 32 * MMA_WARPS;
constexpr int MBQ = 16 * MMA_WARPS;  // query rows per block
constexpr int MBK = 64;              // keys per tile

using bf16 = __nv_bfloat16;

// NT = ceil(hd / 8) n8 tiles of the output; q . k runs over KT = ceil(hd /
// 16) k16 steps
template <int NT>
__global__ void __launch_bounds__(MMA_THREADS, 2)
flash_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out, int H,
                 int Lq, int hd, int kv_len, float scale, Strides st,
                 int vshift, bool out_pairs) {
  constexpr int KT = (NT + 1) / 2;
  constexpr int LDS = 16 * KT + 8;  // shared row stride, elements
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // MBQ x LDS
  bf16* k_s = q_s + MBQ * LDS;                    // 2 x MBK x LDS
  bf16* v_s = k_s + 2 * MBK * LDS;                // 2 x MBK x LDS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int q0 = blockIdx.x * MBQ;
  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;

  // columns [hd, 16 KT) are read by the products but never loaded
  const int pad = 16 * KT - hd;
  for (int i = tid; i < (MBQ + 4 * MBK) * pad; i += MMA_THREADS)
    q_s[(i / pad) * LDS + hd + i % pad] = __float2bfloat16_rn(0.f);

  const int n_tiles = (kv_len + MBK - 1) / MBK;
  load_rows(q_s, LDS, qb, st.ql, q0, MBQ, Lq, hd, vshift, tid, MMA_THREADS);
  load_rows(k_s, LDS, kb, st.kl, 0, MBK, kv_len, hd, vshift, tid,
            MMA_THREADS);
  load_rows(v_s, LDS, vb, st.vl, 0, MBK, kv_len, hd, vshift, tid,
            MMA_THREADS);
  cp_async_commit();

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  uint32_t qa[KT][4];
  // ldmatrix row addresses: A (q) and transposed B (v) take matrix i / 8 at
  // row offset 8 ((i / 8) % 2), column offset 8 (i / 16); non-transposed B
  // (k) the other way round
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      load_rows(k_s + nb * MBK * LDS, LDS, kb, st.kl, (t + 1) * MBK, MBK,
                kv_len, hd, vshift, tid, MMA_THREADS);
      load_rows(v_s + nb * MBK * LDS, LDS, vb, st.vl, (t + 1) * MBK, MBK,
                kv_len, hd, vshift, tid, MMA_THREADS);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        ldmatrix_x4(qa[kt], q_s + (16 * warp + a_row) * LDS + 16 * kt + a_col);
    }
    const bf16* kt_s = k_s + (t & 1) * MBK * LDS;
    const bf16* vt_s = v_s + (t & 1) * MBK * LDS;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt_s + (16 * jj + b_row) * LDS + 16 * kt + b_col);
        mma_bf16(s[2 * jj], qa[kt], kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], qa[kt], kf[2], kf[3]);
      }
    }
    const int k0 = t * MBK;
    const bool edge = k0 + MBK > kv_len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale;
        if (edge && k0 + 8 * j + 2 * c + (e & 1) >= kv_len) s[j][e] = -1e30f;
      }

    // online softmax; rows g (hh = 0) and g + 8 (hh = 1) of the warp's 16
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m[hh] - mx);
      m[hh] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][2 * hh] = expf(s[j][2 * hh] - mx);
        s[j][2 * hh + 1] = expf(s[j][2 * hh + 1] - mx);
        rs += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      // this lane's share of the row sum; the quad's shares add at the end
      l[hh] = l[hh] * alpha + rs;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // p . v over 16 keys at a time, p = p_hi + p_lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* pr = &s[2 * kk + (r >> 1)][2 * (r & 1)];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(pr[0], pr[1]);
        ph[r] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[r] = pack_bf16(pr[0] - __low2float(hi), pr[1] - __high2float(hi));
      }
      const bf16* vrow = vt_s + (16 * kk + a_row) * LDS;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + 16 * np + a_col);
        mma_bf16(o[2 * np], ph, vf[0], vf[1]);
        mma_bf16(o[2 * np], pl, vf[0], vf[1]);
        mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);
      }
      if (NT & 1) {
        uint32_t vf[2];
        ldmatrix_x2_trans(vf, vrow + 8 * (NT - 1));
        mma_bf16(o[NT - 1], ph, vf[0], vf[1]);
        mma_bf16(o[NT - 1], pl, vf[0], vf[1]);
      }
    }
    __syncthreads();  // this tile's buffers are refilled two tiles on
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + 16 * warp + g + 8 * hh;
    if (row >= Lq) continue;
    const float den = fmaxf(l[hh], 1e-30f);
    bf16* orow = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * n + 2 * c;
      const float x0 = o[n][2 * hh] / den, x1 = o[n][2 * hh + 1] / den;
      if (out_pairs) {
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int NT>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       void* out, int B, int H, int Lq, int hd, int kv_len,
                       float scale, const Strides& st, int vshift,
                       bool out_pairs, cudaStream_t stream) {
  constexpr int LDS = 16 * ((NT + 1) / 2) + 8;
  const size_t smem = sizeof(bf16) * (MBQ + 4 * MBK) * LDS;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + MBQ - 1) / MBQ, B * H);
  flash_mma_kernel<NT><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, Lq, hd,
      kv_len, scale, st, vshift, out_pairs);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Lq, int hd, int kv_len,
                         float scale, const Strides& st, cudaStream_t s) {
  const void* ptrs[3] = {q, k, v};
  const long long in_strides[9] = {st.qb, st.qh, st.ql, st.kb, st.kh,
                                   st.kl, st.vb, st.vh, st.vl};
  const int vshift = vector_shift(ptrs, 3, in_strides, 9, hd);
  // bf16 pairs are written as one 4-byte store where every pair is aligned
  const bool out_pairs = hd % 2 == 0 && st.ob % 2 == 0 && st.oh % 2 == 0 &&
                         st.ol % 2 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 4 == 0;
#define OVO_FLASH_NT(N)                                                    \
  case N:                                                                  \
    return launch_mma<N>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st,    \
                         vshift, out_pairs, s);
  switch ((hd + 7) / 8) {
    OVO_FLASH_NT(1) OVO_FLASH_NT(2) OVO_FLASH_NT(3) OVO_FLASH_NT(4)
    OVO_FLASH_NT(5) OVO_FLASH_NT(6) OVO_FLASH_NT(7) OVO_FLASH_NT(8)
    OVO_FLASH_NT(9) OVO_FLASH_NT(10) OVO_FLASH_NT(11) OVO_FLASH_NT(12)
    OVO_FLASH_NT(13) OVO_FLASH_NT(14) OVO_FLASH_NT(15) OVO_FLASH_NT(16)
    default: return cudaErrorInvalidValue;
  }
#undef OVO_FLASH_NT
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDP = BK + 4;
constexpr int THREADS = 256;

template <int NC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int H,
             int Lq, int Lk, int hd, int kv_len, float scale, Strides st) {
  constexpr int LDV = 16 * NC;
  const int LD = hd + 1;
  extern __shared__ float smem[];
  float* q_s = smem;           // BQ x LD
  float* k_s = q_s + BQ * LD;  // BK x LD
  float* v_s = k_s + BK * LD;  // BK x LDV (columns >= hd zero)
  float* p_s = v_s + BK * LDV; // BQ x LDP

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3
  const int cl = tid & 15;  // key / column lane

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd, t = q0 + r;
    q_s[r * LD + d] = t < Lq ? qb[t * st.ql + d] * scale : 0.f;
  }

  float m_i[4], l_i[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV, d = i % LDV, t = k0 + r;
      const bool ok = t < Lk && d < hd;
      if (d < hd) k_s[r * LD + d] = ok ? kb[t * st.kl + d] : 0.f;
      v_s[r * LDV + d] = ok ? vb[t * st.vl + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < hd; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(4 * rg + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m_i[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (k0 + cl + 16 * j >= kv_len) s[i][j] = -1e30f;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m_i[i] - mx);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - mx);
        rsum += p;
        p_s[(4 * rg + i) * LDP + cl + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[i] = l_i[i] * alpha + rsum;
      m_i[i] = mx;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[kk * LDV + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= Lq) continue;
    const float den = fmaxf(l_i[i], 1e-30f);
    float* o = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cl + 16 * c;
      if (col < hd) o[col] = acc[i][c] / den;
    }
  }
}

template <int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, int hd, int kv_len,
                   float scale, const Strides& st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (hd + 1) + BK * (hd + 1) +
                                       BK * 16 * NC + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_kernel<NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Lq, Lk, hd,
      kv_len, scale, st);
  return cudaGetLastError();
}

cudaError_t dispatch_fma(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Lq, int Lk, int hd,
                         int kv_len, float scale, const Strides& st,
                         cudaStream_t s) {
  switch ((hd + 15) / 16) {
    case 1: return launch<1>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 2: return launch<2>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 3: return launch<3>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 4: return launch<4>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 5: return launch<5>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 6: return launch<6>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 7: return launch<7>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 8: return launch<8>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 values, (batch, head, row) strides of q, k, v and out in
// elements; the last dimension of each is contiguous. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_flash_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Lq, int Lk,
                                   int hd, int kv_len, float scale, int dtype,
                                   const long long* strides, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || hd < 1 || hd > 128 || kv_len < 1 ||
      kv_len > Lk)
    return (int)cudaErrorInvalidValue;
  const long long* a = strides;
  const Strides st = {a[0], a[1], a[2], a[3], a[4],  a[5],
                      a[6], a[7], a[8], a[9], a[10], a[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_fma(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale,
                             st, s);
  if (dtype == 1)
    return (int)dispatch_mma(q, k, v, out, B, H, Lq, hd, kv_len, scale, st,
                             s);
  return (int)cudaErrorInvalidValue;
}
