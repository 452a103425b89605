// Packed-qkv attention with in-kernel rotate-half RoPE, token-major output.
//
// Replaces: ovo_tpu/ops/attention.py rope_packed_attention / _rope_packed_kernel
// (the Pallas TPU kernel every PE-Core layer's self-attention runs through).
//
// What it computes, per (view b, head h):
//   q, k, v = columns [h*hd, (h+1)*hd) of the q, k and v sections of
//             qkv (B, L, 3D);
//   q, k   <- rotate-half RoPE in the working dtype, each product rounded to
//             the dtype in the op order of layers.apply_rope
//             (x1*c - x2*s, x1*s + x2*c);
//   s       = (q . k) * scale in f32, keys >= kv_len set to -1e30;
//   p       = exp(s - m) / l with the row's max m and sum l, rounded to the
//             dtype (the reference's rounding point: normalized, then
//             rounded; in f32 the rounding is the identity);
//   out     = p . v in f32, rounded once, written to out (B, L, D) at
//             columns [h*hd, (h+1)*hd).
//
// What bounds it on an H100: at the PE-Core path shape (7 views, L = 584,
// D = 1024, 16 heads of 64, bf16) one launch needs ~9.6 GFLOP and moves
// ~33 MB, so the tensor cores (989 TF/s) and HBM (3.35 TB/s) both bound it
// at ~10 us. This version does its products with f32 FMAs on the CUDA
// cores (67 TF/s peak, fed from shared memory), so it is bound by FMA issue
// and shared-memory bandwidth, far above that floor; the tensor cores are
// later work. The first design (one online-softmax pass that divided by the
// sum at the end, 0.626 ms at that shape) computed another function in bf16:
// its weights never rounded.
//
// Design: one block of 256 threads per (view*head, 64-query tile). The q tile
// is rotated once into shared memory (f32, padded rows: no bank conflicts).
// 64-key tiles stream through shared memory twice: pass 1 recomputes the
// scores of each tile and keeps only each row's running max and sum; pass 2
// recomputes them again, forms the normalized, rounded weights and
// accumulates p . v (B2's two-pass structure, kept here on FMAs). Each thread
// owns a 4x4 micro-tile of the 64x64 score tile (rows 4*(tid/16)+i, keys
// tid%16 + 16*j) and 4 rows x hd/16 columns of the output; row max and sum
// reduce over the 16 lanes of a half-warp with shuffles. Tiles wholly beyond
// kv_len are skipped in both passes: their keys would get exp(-1e30 - m) = 0
// exactly. kv_len >= 1 keeps every row's max finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDP = BK + 4;
constexpr int THREADS = 256;

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

// value rounded to the working dtype, carried as f32
template <typename T>
__device__ __forceinline__ float rnd(float x) { return to_f<T>(from_f<T>(x)); }

// element d of the rotate-half RoPE of one head row (hd values at x)
template <typename T>
__device__ __forceinline__ float rope_elem(const T* __restrict__ x, int d,
                                           int h2, const float* __restrict__ cs,
                                           const float* __restrict__ sn) {
  if (d < h2) {
    const float c = rnd<T>(cs[d]), s = rnd<T>(sn[d]);
    const float a = rnd<T>(__fmul_rn(to_f<T>(x[d]), c));
    const float b = rnd<T>(__fmul_rn(to_f<T>(x[d + h2]), s));
    return rnd<T>(__fsub_rn(a, b));
  }
  const int e = d - h2;
  const float c = rnd<T>(cs[e]), s = rnd<T>(sn[e]);
  const float a = rnd<T>(__fmul_rn(to_f<T>(x[e]), s));
  const float b = rnd<T>(__fmul_rn(to_f<T>(x[d]), c));
  return rnd<T>(__fadd_rn(a, b));
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
rope_attn_kernel(const T* __restrict__ qkv, const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, T* __restrict__ out, int L,
                 int D, int heads, int kv_len, float scale) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;
  constexpr int H2 = HD / 2;
  extern __shared__ float smem[];
  float* q_s = smem;             // BQ x LD
  float* k_s = q_s + BQ * LD;    // BK x LD
  float* v_s = k_s + BK * LD;    // BK x HD
  float* p_s = v_s + BK * HD;    // BQ x LDP

  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int q0 = blockIdx.x * BQ;
  const size_t rs = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * L * rs;
  const int qc = h * HD, kc = D + h * HD, vc = 2 * D + h * HD;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3
  const int cl = tid & 15;  // key / column lane

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, t = q0 + r;
    float val = 0.f;
    if (t < L)
      val = rope_elem<T>(base + t * rs + qc, d, H2, cos_t + (size_t)t * H2,
                         sin_t + (size_t)t * H2);
    q_s[r * LD + d] = val;
  }

  // k (rotated) and, in pass 2, v of one 64-key tile -> shared memory
  auto load_tile = [&](int k0, bool with_v) {
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < L) {
        kv = rope_elem<T>(base + t * rs + kc, d, H2, cos_t + (size_t)t * H2,
                          sin_t + (size_t)t * H2);
        if (with_v) vv = to_f<T>(base[t * rs + vc + d]);
      }
      k_s[r * LD + d] = kv;
      if (with_v) v_s[r * HD + d] = vv;
    }
  };
  // this thread's 4 x 4 scores of the tile, times scale; keys >= kv_len at
  // -1e30
  auto tile_scores = [&](float (&s)[4][4], int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(4 * rg + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = k_s[(cl + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        s[i][j] = k0 + cl + 16 * j < kv_len ? s[i][j] * scale : -1e30f;
  };

  // pass 1: each row's max and sum of exp over the keys < kv_len
  float m_i[4], l_i[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
  }
  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();  // previous tile fully consumed (and q tile written)
    load_tile(k0, false);
    __syncthreads();
    float s[4][4];
    tile_scores(s, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mx = fmaxf(m_i[i], mx);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) rsum += expf(s[i][j] - mx);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l_i[i] = l_i[i] * expf(m_i[i] - mx) + rsum;
      m_i[i] = mx;
    }
  }

  // pass 2: the normalized weights, rounded to the dtype, times v
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int k0 = 0; k0 < kv_len; k0 += BK) {
    __syncthreads();  // previous tile fully consumed
    load_tile(k0, true);
    __syncthreads();
    float s[4][4];
    tile_scores(s, k0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(4 * rg + i) * LDP + cl + 16 * j] =
            rnd<T>(expf(s[i][j] - m_i[i]) / l_i[i]);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p_s[(4 * rg + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vb = v_s[kk * HD + cl + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vb, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * rg + i;
    if (row >= L) continue;
    T* o = out + ((size_t)b * L + row) * D + h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[cl + 16 * c] = from_f<T>(acc[i][c]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const float* cos_t, const float* sin_t,
                   void* out, int B, int L, int D, int heads, int kv_len,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      rope_attn_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, B * heads);
  rope_attn_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qkv), cos_t, sin_t, static_cast<T*>(out), L, D,
      heads, kv_len, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int hd, const void* qkv, const float* c, const float* s,
                     void* out, int B, int L, int D, int heads, int kv_len,
                     float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 32: return launch<T, 32>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 48: return launch<T, 48>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 64: return launch<T, 64>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 80: return launch<T, 80>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 96: return launch<T, 96>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 112: return launch<T, 112>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    case 128: return launch<T, 128>(qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_rope_packed_attention(const void* qkv, const void* cos_t,
                                         const void* sin_t, void* out, int B,
                                         int L, int D, int heads, int kv_len,
                                         float scale, int dtype,
                                         void* stream) {
  if (heads <= 0 || D % heads != 0 || kv_len < 1 || kv_len > L)
    return (int)cudaErrorInvalidValue;
  const int hd = D / heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* c = static_cast<const float*>(cos_t);
  const float* s = static_cast<const float*>(sin_t);
  if (dtype == 0)
    return (int)dispatch<float>(hd, qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(hd, qkv, c, s, out, B, L, D, heads, kv_len, scale, st);
  return (int)cudaErrorInvalidValue;
}
