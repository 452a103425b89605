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
// FLOP-bound. This first version does its products with f32 FMAs on the CUDA
// cores (67 TF/s peak, fed from shared memory), so FMA issue and
// shared-memory traffic bound it far above that floor; mma.sync / wgmma on
// bf16 tiles is later work.
//
// Design: one block of 256 threads per (b*h, 64-query tile), the structure of
// kernel B5 (rope_packed_attention.cu) without the rotation. The scaled q
// tile sits in shared memory (f32, rows padded to hd+1 against bank
// conflicts); 64-key tiles of k and v stream through shared memory with an
// online softmax. Each thread owns a 4x4 micro-tile of the 64x64 score tile
// (rows 4*(tid/16)+i, keys tid%16 + 16*j) and 4 rows x NC column groups of
// 16 of the output; row max and sum reduce over the 16 lanes of a half-warp
// with shuffles. The head size is taken natively (hd = 72 is neither a power
// of two nor a multiple of 16): NC = ceil(hd/16) column groups, the v tile
// zero-padded to 16*NC columns, and only columns < hd written. Tiles wholly
// past kv_len are skipped: the reference gives their keys exp(-1e30 - m) = 0.
// Any (b, h, l) strides with a unit last stride are taken, so head-split
// views of a packed projection and token-major outputs need no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDP = BK + 4;
constexpr int THREADS = 256;

struct Strides {
  long long qb, qh, ql, kb, kh, kl, vb, vh, vl, ob, oh, ol;
};

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

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Lq,
             int Lk, int hd, int kv_len, float scale, Strides st) {
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
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3
  const int cl = tid & 15;  // key / column lane

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd, t = q0 + r;
    q_s[r * LD + d] = t < Lq ? to_f<T>(qb[t * st.ql + d]) * scale : 0.f;
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
      if (d < hd) k_s[r * LD + d] = ok ? to_f<T>(kb[t * st.kl + d]) : 0.f;
      v_s[r * LDV + d] = ok ? to_f<T>(vb[t * st.vl + d]) : 0.f;
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
    T* o = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cl + 16 * c;
      if (col < hd) o[col] = from_f<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, int hd, int kv_len,
                   float scale, const Strides& st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * (hd + 1) + BK * (hd + 1) +
                                       BK * 16 * NC + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Lq, Lk, hd, kv_len,
      scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Lq, int Lk, int hd, int kv_len,
                     float scale, const Strides& st, cudaStream_t s) {
  switch ((hd + 15) / 16) {
    case 1: return launch<T, 1>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 2: return launch<T, 2>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 3: return launch<T, 3>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 4: return launch<T, 4>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 5: return launch<T, 5>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 6: return launch<T, 6>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 7: return launch<T, 7>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 8: return launch<T, 8>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
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
    return (int)dispatch<float>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
