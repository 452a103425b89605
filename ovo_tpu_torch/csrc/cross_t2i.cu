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
//   p      = softmax over l in f32;
//   pk[c]  = sum_l p[l] keys[l, c], rounded to the dtype;
//   out[t, h*dh+j] = sum_c pk[c] Wv[c, h*dh+j] + bv[h*dh+j], rounded.
// That is softmax(q (keys Wk + pe_k)^T) (keys Wv + bv) with the image-side
// projections never formed, the reference's algebra. The TPU kernel packs
// the heads block-diagonally to fill 128 lanes; here each (head, token) row
// is computed on its own. Like kernel B5, the weights stay in f32 until p.keys
// is normalized (the reference rounds p to the dtype first).
//
// What bounds it on an H100: at the AMG shape (256 prompts, 8 heads x 8
// tokens, L = 4096, dk = 256, D = 128, bf16) a launch needs 68.7 GFLOP
// (69 us at 989 TF/s) and reads 537 MB of per-prompt keys (160 us at
// 3.35 TB/s): bytes bound it. With batch-1 keys (the first two-way layer)
// it reads 2 MB and is FLOP-bound. This first version does its products with
// f32 FMAs on the CUDA cores, so FMA issue bounds it (~1 ms at 67 TF/s).
//
// Design: one block of 256 threads per prompt: all heads x tokens (up to 64
// rows) of a prompt share one read of its keys, which serve as both the keys
// and the values of this attention (width dk). The prologue forms qk for all
// rows in shared memory (f32, rows padded to dk+4 so that float4 reads of
// eight consecutive rows fall in distinct banks). 32-key tiles of the keys
// and of pe_k stream through shared memory; each thread owns 4 rows x 2 keys
// of the score tile (float4 reads along dk) and 4 rows x 16 columns of the
// (rows x dk) accumulator,
// with an online softmax whose row max / sum reduce over 16 lanes by
// shuffles. The epilogue normalizes, rounds pk into shared memory and applies
// Wv per head. Batch-1 keys or queries are read through a batch stride of 0:
// the (B, L, dk) broadcast is never formed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// q (B or 1, NT, D), keys (B or 1, L, dk), each batch read at q_sb / k_sb
// elements (0 = shared); wk, wv (dk, D); pek (L, D); bv (D,) f32;
// out (B, NT, D). Needs heads * NT <= 64, dk % 16 == 0, dk <= 256 and
// 16-byte aligned keys.
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
    return (int)launch<__nv_bfloat16>(q, keys, wk, wv, pek, b, out, B, NT,
                                      heads, L, dk, D, scale, q_sb, k_sb, s);
  return (int)cudaErrorInvalidValue;
}
