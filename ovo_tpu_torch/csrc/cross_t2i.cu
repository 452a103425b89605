// Token -> image cross attention with the image-side k / v projections
// folded in (the SAM decoder's token-to-image attention).
//
// Replaces: ovo_tpu/ops/attention.py cross_t2i_from_keys -> _crossq_proj_call
// / _crossq_proj_kernel (a Pallas TPU kernel).
//
// What it computes, for prompt b, head h (dh = D / heads lanes) and token t,
// with keys (L, dk) the raw image stream and Wk, Wv (dk, D):
//   qk[c]  = sum_j q[t, h*dh+j] Wk[c, h*dh+j], rounded to the dtype;
//   s[l]   = (qk . keys[l] + q[t, h-block] . pe_k[l, h-block]) * scale (f32);
//   p      = exp(s - m) / sum over l, with the row's max m, in f32, rounded
//            to the dtype (normalized, then rounded: the reference's order);
//   pk[c]  = sum_l p[l] keys[l, c] in f32, rounded to the dtype;
//   out[t, h*dh+j] = sum_c pk[c] Wv[c, h*dh+j] + bv[h*dh+j], rounded.
// That is softmax(q (keys Wk + pe_k)^T) (keys Wv + bv) with the image-side
// projections never formed, the reference's algebra.
//
// What bounds it on an H100: at the AMG shape (256 prompts, 8 heads x 8
// tokens, L = 4096, dk = 256, D = 128, bf16) a launch needs 71 GFLOP
// (72 us at 989 TF/s) and reads 537 MB of per-prompt keys (160 us at
// 3.35 TB/s): bytes bound it. With batch-1 keys (the first two-way layer)
// it reads 2 MB and is bound by its operations.
//
// bf16 (t2i_mma_kernel), on the tensor cores. One block of eight warps per
// prompt; a prompt's rows r = h * T + t (up to 64: four m16 row tiles) share
// one stream of its keys, which serve as both the keys and the values of
// this attention (width dk). Warp w owns row tile w % 4 and half w / 4 of
// each chunk's keys (scores) and of pk's columns (p . keys).
//  - Prologue: a block-diagonal copy of the prompt's q in shared memory (row
//    r holds q[t] in head h's columns, zeros elsewhere), then qk = q_bd Wk^T
//    on mma.sync into shared memory as bf16.
//  - Scores: s = [qk | q_bd] . [keys | pe_k]^T, one mma.sync m16n8k16
//    product over K = dk + the columns of the row tile's heads (the other
//    heads' blocks of q_bd are zero and skipped); a reordered f32 sum of
//    the reference's two dots.
//  - Two passes over 64-key chunks, because the reference rounds the
//    normalized weight: pass 1 keeps each row's running max and sum; pass 2
//    recomputes the scores, writes p = bf16(exp(s - m) / l) to shared
//    memory, and accumulates pk = p . keys (ldmatrix.trans on the same keys
//    tile) in f32 registers. Chunks of keys and pe_k arrive by cp.async,
//    double-buffered, 16 bytes a copy where pointer and strides allow (8,
//    4, 2 otherwise, chosen at launch). Keys past L are zero-filled and get
//    -1e30.
//  - Epilogue: pk rounded to bf16 in shared memory, then pk . Wv on
//    mma.sync over the n8 column tiles of the row tile's heads, + bv in
//    f32, rounded.
// pk's second pass re-reads the keys: ~1.07 GB a launch at per-prompt keys
// (a 0.32 ms floor), since 132 blocks in flight hold ~260 MB of keys, more
// than the 50 MB L2.
//
// float32 (t2i_kernel) keeps the first design, f32 FMAs on the CUDA cores:
// one block of 256 threads per prompt, 32-key tiles of keys and pe_k in
// shared memory as f32, 4 rows x 2 keys of the score tile and 4 rows x 16
// columns of pk a thread, an online softmax (in f32 the weight's rounding
// is the identity), pk normalized at the end and Wv applied per head.
// The first design ran bf16 too, at 4.241 ms (per-prompt keys) and 4.054
// (shared) at the AMG shape, and computed another function there: its
// weights never rounded.
// Batch-1 keys or queries are read through a batch stride of 0: the
// (B, L, dk) broadcast is never formed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RMAX = 64;  // heads * tokens
constexpr int BK = 32;
constexpr int LDP = BK + 4;
constexpr int NCOL = 16;  // column groups of 16: dk <= 256

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f<T>(from_f<T>(x)); }

// four consecutive elements (16-byte aligned for f32, 8-byte for bf16)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p);
template <>
__device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
t2i_kernel(const T* __restrict__ q, const T* __restrict__ keys,
           const T* __restrict__ wk, const T* __restrict__ wv,
           const T* __restrict__ pek, const float* __restrict__ bv,
           T* __restrict__ out, int NT, int heads, int L, int dk, int D,
           float scale, long long q_sb, long long k_sb) {
  const int dh = D / heads;
  const int R = heads * NT;  // row r = h * NT + t
  const int LDQ = dk + 4, LDK = dk + 4, LDE = D + 1, dk4 = dk / 4;
  extern __shared__ float4 smem4[];
  float* qk_s = reinterpret_cast<float*>(smem4);               // RMAX x LDQ (later pk)
  float* kt_s = qk_s + RMAX * LDQ;  // BK x LDK
  float* pe_s = kt_s + BK * LDK;    // BK x LDE
  float* q_s = pe_s + BK * LDE;     // NT x D
  float* p_s = q_s + NT * D;        // RMAX x LDP

  const int b = blockIdx.x;
  const T* qb = q + b * q_sb;
  const T* kb = keys + b * k_sb;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3
  const int cl = tid & 15;  // key / column lane
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < NT * D; i += THREADS) q_s[i] = to_f<T>(qb[i]);
  __syncthreads();
  for (int i = tid; i < RMAX * dk; i += THREADS) {
    const int r = i / dk, c = i % dk;
    float a = 0.f;
    if (r < R) {
      const int h = r / NT, t = r % NT;
      const float* qr = q_s + t * D + h * dh;
      const T* w = wk + c * D + h * dh;
      for (int j = 0; j < dh; ++j) a = fmaf(qr[j], to_f<T>(w[j]), a);
      a = rnd<T>(a);
    }
    qk_s[r * LDQ + c] = a;
  }

  float m_i[4], l_i[4], acc[4][NCOL];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCOL; ++c) acc[i][c] = 0.f;
  }
  const int ncol = dk / 16;

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous tile consumed (and qk written)
    for (int i = tid; i < BK * dk4; i += THREADS) {
      const int r = i / dk4, c = (i % dk4) * 4, t = k0 + r;
      *reinterpret_cast<float4*>(kt_s + r * LDK + c) =
          t < L ? load4<T>(kb + (long long)t * dk + c) : zero;
    }
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D, t = k0 + r;
      pe_s[r * LDE + c] = t < L ? to_f<T>(pek[t * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    const float4* k0p = reinterpret_cast<const float4*>(kt_s + cl * LDK);
    const float4* k1p =
        reinterpret_cast<const float4*>(kt_s + (cl + 16) * LDK);
    const float4* qp = reinterpret_cast<const float4*>(qk_s + 4 * rg * LDQ);
#pragma unroll 4
    for (int d4 = 0; d4 < dk4; ++d4) {
      const float4 k0v = k0p[d4], k1v = k1p[d4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qa = qp[i * (LDQ / 4) + d4];
        s[i][0] = dot4(qa, k0v, s[i][0]);
        s[i][1] = dot4(qa, k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * rg + i;
      float e0 = 0.f, e1 = 0.f;
      if (r < R) {
        const int h = r / NT, t = r % NT;
        const float* qr = q_s + t * D + h * dh;
        const float* p0 = pe_s + cl * LDE + h * dh;
        const float* p1 = pe_s + (cl + 16) * LDE + h * dh;
        for (int j = 0; j < dh; ++j) {
          e0 = fmaf(qr[j], p0[j], e0);
          e1 = fmaf(qr[j], p1[j], e1);
        }
      }
      s[i][0] = k0 + cl < L ? (s[i][0] + e0) * scale : -INFINITY;
      s[i][1] = k0 + cl + 16 < L ? (s[i][1] + e1) * scale : -INFINITY;
      float mx = fmaxf(m_i[i], fmaxf(s[i][0], s[i][1]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = expf(m_i[i] - mx);
      const float pa = expf(s[i][0] - mx), pb = expf(s[i][1] - mx);
      p_s[r * LDP + cl] = pa;
      p_s[r * LDP + cl + 16] = pb;
      float rsum = pa + pb;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[i] = l_i[i] * alpha + rsum;
      m_i[i] = mx;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        if (c < ncol) {
          const float kv = kt_s[kk * LDK + cl + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], kv, acc[i][c]);
        }
      }
    }
  }

  // pk = p.keys normalized and rounded, over the qk rows (no longer read)
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * rg + i;
#pragma unroll
    for (int c = 0; c < NCOL; ++c)
      if (c < ncol) qk_s[r * LDQ + cl + 16 * c] = rnd<T>(acc[i][c] / l_i[i]);
  }
  __syncthreads();

  T* ob = out + (long long)b * NT * D;
  for (int i = tid; i < R * dh; i += THREADS) {
    const int r = i / dh, j = i % dh;
    const int h = r / NT, t = r % NT;
    const float* pk = qk_s + r * LDQ;
    const T* w = wv + h * dh + j;
    float a = 0.f;
    for (int c = 0; c < dk; ++c) a = fmaf(pk[c], to_f<T>(w[c * D]), a);
    ob[t * D + h * dh + j] = from_f<T>(a + bv[h * dh + j]);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* keys, const void* wk,
                   const void* wv, const void* pek, const float* bv,
                   void* out, int B, int NT, int heads, int L, int dk, int D,
                   float scale, long long q_sb, long long k_sb,
                   cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (RMAX * (dk + 4) + BK * (dk + 4) + BK * (D + 1) +
                       NT * D + RMAX * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      t2i_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  t2i_kernel<T><<<B, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(keys),
      static_cast<const T*>(wk), static_cast<const T*>(wv),
      static_cast<const T*>(pek), bv, static_cast<T*>(out), NT, heads, L, dk,
      D, scale, q_sb, k_sb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int KC = 64;          // keys a chunk
constexpr int LDPB = KC + 8;    // p rows: odd 16-byte units
constexpr int DMAX = 256;       // D (rounded up to 16) at most

struct T2iArgs {
  const bf16* q;      // (B or 1, NT, D)
  const bf16* keys;   // (B or 1, L, dk)
  const bf16* wk;     // (dk, D)
  const bf16* wv;     // (dk, D)
  const bf16* pek;    // (L, D)
  const float* bv;    // (D,)
  bf16* out;          // (B, NT, D)
  int NT, heads, L, dk, D, DP;
  float scale;
  long long q_sb, k_sb;
  int vs_k, vs_pe;    // copy widths (vector_shift) of keys and pe_k
};

// DKC, DC, HC, NTC: dk, D, heads and tokens fixed at compile time (0: read
// at run time). The SAM decoder's widths (256, 128, 8, 8) get their own
// instantiation, whose loops lose their run-time guards.
template <int DKC, int DC, int HC, int NTC>
__global__ void __launch_bounds__(M_THREADS, 1) t2i_mma_kernel(T2iArgs a) {
  const int dk = DKC ? DKC : a.dk, D = DC ? DC : a.D;
  const int DP = DC ? (DC + 15) / 16 * 16 : a.DP, NT = NTC ? NTC : a.NT;
  const int heads = HC ? HC : a.heads;
  const int dh = D / heads, R = heads * NT;
  const int LDK = dk + 8, LDE = DP + 8;  // odd 16-byte units: ldmatrix rows
                                         // fall in distinct banks
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ml_s = reinterpret_cast<float*>(smem_raw);   // 2 halves x 64 x (m, l)
  bf16* qk_s = reinterpret_cast<bf16*>(ml_s + 2 * RMAX * 2);  // 64 x LDK
  bf16* qb_s = qk_s + RMAX * LDK;                     // 64 x LDE
  bf16* p_s = qb_s + RMAX * LDE;                      // 64 x LDPB
  bf16* buf = p_s + RMAX * LDPB;  // 2 x (KC x LDK keys, KC x LDE pe_k)
  const int stage = KC * (LDK + LDE);

  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int rt = warp & 3, kh = warp >> 2;  // row tile; key / column half
  const int r0 = 16 * rt;
  const bool active = r0 < R;
  // the heads of this row tile and the k16 column chunks of q_bd they fill
  const int h_lo = r0 / NT, h_hi = (active ? min(r0 + 15, R - 1) : r0) / NT;
  const int kc_lo = h_lo * dh / 16, kc_hi = ((h_hi + 1) * dh + 15) / 16;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  const bf16* qb = a.q + b * a.q_sb;
  const bf16* kb = a.keys + b * a.k_sb;
  const bf16 zero = __float2bfloat16_rn(0.f);

  // block-diagonal q; pe_k's pad columns [D, DP) of both stages read as 0
  for (int i = tid; i < RMAX * DP; i += M_THREADS) {
    const int r = i / DP, d = i % DP;
    bf16 v = zero;
    if (r < R && d < D && d / dh == r / NT) v = qb[(r % NT) * D + d];
    qb_s[r * LDE + d] = v;
  }
  for (int i = tid; i < 2 * KC * (DP - D); i += M_THREADS) {
    const int r = i / (DP - D), d = D + i % (DP - D);
    buf[(r / KC) * stage + KC * LDK + (r % KC) * LDE + d] = zero;
  }
  __syncthreads();

  // qk = q_bd Wk^T (rows of this tile, columns of this half), rounded
  const int ncol = dk / 16;  // n8 tiles of a column half
  const int col0 = kh * (dk / 2);
  if (active) {
    float acc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    for (int kc = kc_lo; kc < kc_hi; ++kc) {
      uint32_t qa[4];
      ldmatrix_x4(qa, qb_s + (r0 + a_row) * LDE + 16 * kc + a_col);
      const int d0 = 16 * kc + 2 * c;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n < ncol) {
          const bf16* w = a.wk + (size_t)(col0 + 8 * n + g) * D;
          auto at = [&](int d) { return d < D ? w[d] : zero; };
          const uint32_t b0 = pack2(at(d0), at(d0 + 1));
          const uint32_t b1 = pack2(at(d0 + 8), at(d0 + 9));
          mma_bf16(acc[n], qa, b0, b1);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n < ncol) {
        bf16* o = qk_s + (r0 + g) * LDK + col0 + 8 * n + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(acc[n][0], acc[n][1]);
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * LDK) =
            __floats2bfloat162_rn(acc[n][2], acc[n][3]);
      }
    }
  }

  // steps: pass 1 over the chunks, then pass 2, each loading keys and pe_k
  const int n_chunks = (a.L + KC - 1) / KC;
  const int steps = 2 * n_chunks;
  auto issue = [&](int s) {
    const int k0 = (s % n_chunks) * KC;
    bf16* kbuf = buf + (s & 1) * stage;
    load_rows(kbuf, LDK, kb, dk, k0, KC, a.L, dk, a.vs_k, tid, M_THREADS);
    load_rows(kbuf + KC * LDK, LDE, a.pek, D, k0, KC, a.L, D, a.vs_pe, tid,
              M_THREADS);
    cp_async_commit();
  };

  float pk[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) pk[n][0] = pk[n][1] = pk[n][2] = pk[n][3] = 0.f;
  // pass 1 keeps each lane's running max and sum over its own columns of
  // rows g and g + 8; the quad, then the two halves, combine them
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];

  issue(0);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool pass2 = s >= n_chunks;
    const int k0 = (s % n_chunks) * KC;
    const bf16* kbuf = buf + (s & 1) * stage;
    const bf16* pbuf = kbuf + KC * LDK;
    if (active) {
      if (s == n_chunks) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* o = ml_s + ((1 - kh) * RMAX + r0 + g + 8 * hh) * 2;
          const float mo = o[0], lo = o[1];
          const float mx = fmaxf(m[hh], mo);
          l[hh] = l[hh] * expf(m[hh] - mx) + lo * expf(mo - mx);
          m[hh] = mx;
          rl[hh] = 1.f / l[hh];
        }
      }
      // scores of the 16 rows x this half's 32 keys
      float sc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const bf16* krow = kbuf + (32 * kh + b_row) * LDK + b_col;
      for (int kt = 0; kt < dk / 16; ++kt) {
        uint32_t qa[4], kf[2][4];
        ldmatrix_x4(qa, qk_s + (r0 + a_row) * LDK + 16 * kt + a_col);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldmatrix_x4(kf[jj], krow + 16 * jj * LDK + 16 * kt);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16(sc[2 * jj], qa, kf[jj][0], kf[jj][1]);
          mma_bf16(sc[2 * jj + 1], qa, kf[jj][2], kf[jj][3]);
        }
      }
      const bf16* prow = pbuf + (32 * kh + b_row) * LDE + b_col;
      for (int kc = kc_lo; kc < kc_hi; ++kc) {
        uint32_t qa[4], kf[2][4];
        ldmatrix_x4(qa, qb_s + (r0 + a_row) * LDE + 16 * kc + a_col);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          ldmatrix_x4(kf[jj], prow + 16 * jj * LDE + 16 * kc);
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          mma_bf16(sc[2 * jj], qa, kf[jj][0], kf[jj][1]);
          mma_bf16(sc[2 * jj + 1], qa, kf[jj][2], kf[jj][3]);
        }
      }
      const int key0 = k0 + 32 * kh + 2 * c;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= a.scale;
          if (key0 + 8 * j + (e & 1) >= a.L) sc[j][e] = -1e30f;
        }

      if (!pass2) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float mx = m[hh];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sum += expf(sc[j][2 * hh] - mx) + expf(sc[j][2 * hh + 1] - mx);
          l[hh] = l[hh] * expf(m[hh] - mx) + sum;
          m[hh] = mx;
        }
        if (s == n_chunks - 1) {
          // the quad's lanes share rows g and g + 8
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float mx = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            float sum = l[hh] * expf(m[hh] - mx);
            sum += __shfl_xor_sync(0xffffffffu, sum, 1);
            sum += __shfl_xor_sync(0xffffffffu, sum, 2);
            m[hh] = mx;
            l[hh] = sum;
            if (c == 0) {
              float* o = ml_s + (kh * RMAX + r0 + g + 8 * hh) * 2;
              o[0] = mx;
              o[1] = sum;
            }
          }
        }
      } else {
        // the reference's rounding point: normalized, then rounded
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const float p0 =
                div_by_sum(expf(sc[j][2 * hh] - m[hh]), l[hh], rl[hh]);
            const float p1 =
                div_by_sum(expf(sc[j][2 * hh + 1] - m[hh]), l[hh], rl[hh]);
            *reinterpret_cast<__nv_bfloat162*>(
                p_s + (r0 + g + 8 * hh) * LDPB + 32 * kh + 8 * j + 2 * c) =
                __floats2bfloat162_rn(p0, p1);
          }
      }
    }
    if (pass2) {
      __syncthreads();  // the whole chunk's p is in shared memory
      if (active) {
        // pk[rows, this half's columns] += p (16 x 64) . keys (64 x dk/2)
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk) {
          uint32_t pa[4];
          ldmatrix_x4(pa, p_s + (r0 + a_row) * LDPB + 16 * kk + a_col);
          const bf16* vrow = kbuf + (16 * kk + a_row) * LDK + col0;
          uint32_t vf[8][4];
#pragma unroll
          for (int np = 0; np < 8; ++np) {
            if (2 * np + 1 < ncol) {
              ldmatrix_x4_trans(vf[np], vrow + 16 * np + a_col);
            } else if (2 * np < ncol) {
              uint32_t v2[2];
              ldmatrix_x2_trans(v2, vrow + 16 * np);
              vf[np][0] = v2[0];
              vf[np][1] = v2[1];
            }
          }
#pragma unroll
          for (int np = 0; np < 8; ++np) {
            if (2 * np < ncol) mma_bf16(pk[2 * np], pa, vf[np][0], vf[np][1]);
            if (2 * np + 1 < ncol)
              mma_bf16(pk[2 * np + 1], pa, vf[np][2], vf[np][3]);
          }
        }
      }
    }
    __syncthreads();  // this step's buffer is refilled two steps on
  }

  // pk rounded to bf16, over the qk rows (no longer read)
  if (active) {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      if (n < ncol) {
        bf16* o = qk_s + (r0 + g) * LDK + col0 + 8 * n + 2 * c;
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(pk[n][0], pk[n][1]);
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * LDK) =
            __floats2bfloat162_rn(pk[n][2], pk[n][3]);
      }
    }
  }
  __syncthreads();
  if (!active) return;

  // out = pk Wv + bv over the n8 column tiles of this row tile's heads,
  // the tiles shared out between the two halves
  bf16* ob = a.out + (size_t)b * NT * D;
  const int nt_lo = h_lo * dh / 8, nt_hi = ((h_hi + 1) * dh + 7) / 8;
  for (int nt = nt_lo + kh; nt < nt_hi; nt += 2) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    const int col = 8 * nt + g;  // B's column (this lane's n)
    for (int kt = 0; kt < dk / 16; ++kt) {
      uint32_t pa[4];
      ldmatrix_x4(pa, qk_s + (r0 + a_row) * LDK + 16 * kt + a_col);
      const bf16* w = a.wv + (size_t)(16 * kt + 2 * c) * D + col;
      uint32_t b0 = 0u, b1 = 0u;
      if (col < D) {
        b0 = pack2(w[0], w[D]);
        b1 = pack2(w[8 * D], w[9 * D]);
      }
      mma_bf16(acc, pa, b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), d = 8 * nt + 2 * c + (e & 1);
      if (r < R && d < D && d / dh == r / NT)
        ob[(r % NT) * D + d] = __float2bfloat16_rn(acc[e] + a.bv[d]);
    }
  }
}

cudaError_t launch_mma(const void* q, const void* keys, const void* wk,
                       const void* wv, const void* pek, const float* bv,
                       void* out, int B, int NT, int heads, int L, int dk,
                       int D, float scale, long long q_sb, long long k_sb,
                       cudaStream_t stream) {
  T2iArgs a;
  a.q = static_cast<const bf16*>(q);
  a.keys = static_cast<const bf16*>(keys);
  a.wk = static_cast<const bf16*>(wk);
  a.wv = static_cast<const bf16*>(wv);
  a.pek = static_cast<const bf16*>(pek);
  a.bv = bv;
  a.out = static_cast<bf16*>(out);
  a.NT = NT;
  a.heads = heads;
  a.L = L;
  a.dk = dk;
  a.D = D;
  a.DP = (D + 15) / 16 * 16;
  a.scale = scale;
  a.q_sb = q_sb;
  a.k_sb = k_sb;
  if (a.DP > DMAX) return cudaErrorInvalidValue;
  const long long sk[2] = {dk, k_sb}, sp[1] = {D};
  a.vs_k = vector_shift(&keys, 1, sk, 2, dk);
  a.vs_pe = vector_shift(&pek, 1, sp, 1, D);
  const int LDK = dk + 8, LDE = a.DP + 8;
  const size_t smem = sizeof(float) * 2 * RMAX * 2 +
                      sizeof(bf16) * ((size_t)RMAX * (LDK + LDE + LDPB) +
                                      2 * (size_t)KC * (LDK + LDE));
  const bool sam = dk == 256 && D == 128 && heads == 8 && NT == 8;
  auto kernel = sam ? t2i_mma_kernel<256, 128, 8, 8> : t2i_mma_kernel<0, 0, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, M_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q (B or 1, NT, D), keys (B or 1, L, dk), each batch read at q_sb / k_sb
// elements (0 = shared); wk, wv (dk, D); pek (L, D); bv (D,) f32;
// out (B, NT, D). Needs heads * NT <= 64, dk % 16 == 0, dk <= 256; in
// bf16 also D <= 256. Any alignment: the copy width follows the pointers.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_cross_t2i(const void* q, const void* keys, const void* wk,
                             const void* wv, const void* pek, const void* bv,
                             void* out, int B, int NT, int heads, int L,
                             int dk, int D, float scale, long long q_sb,
                             long long k_sb, int dtype, void* stream) {
  if (B < 1 || NT < 1 || heads < 1 || heads * NT > RMAX || L < 1 ||
      dk < 16 || dk > 16 * NCOL || dk % 16 || D % heads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bv);
  if (dtype == 0)
    return (int)launch<float>(q, keys, wk, wv, pek, b, out, B, NT, heads, L,
                              dk, D, scale, q_sb, k_sb, s);
  if (dtype == 1)
    return (int)launch_mma(q, keys, wk, wv, pek, b, out, B, NT, heads, L, dk,
                           D, scale, q_sb, k_sb, s);
  return (int)cudaErrorInvalidValue;
}
