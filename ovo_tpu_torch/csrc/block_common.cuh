// Shared pieces of the whole-block kernels B12a (fused_attn_block.cu) and
// B12b (fused_mlp_block.cu): dtype helpers, the row LayerNorm and a tiled
// GEMM with the blocks' epilogues.
//
// The GEMM does its products as f32 FMAs on the CUDA cores, fed from shared
// memory: a 128 x 64 output tile per block of 256 threads, 8-deep k slices,
// each thread an 8 x 4 register micro-tile (rows ty + 16 i, columns
// tx + 16 j, so the shared-memory reads of a warp are broadcasts or
// consecutive). Inputs in bf16 are widened on load, so every product is exact
// and every sum f32, as the TPU kernels' preferred_element_type=f32 dots.
//
// The k axis is summed in groups: a group's partial sum starts at zero and is
// added to the running sum when the group ends -- the TPU kernels' order for
// the out-projection (one group per head, heads in order) and the MLP's proj
// (one group per hidden chunk). With one group the result is the plain sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ovo_block {

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

// ---------------------------------------------------------------------------
// LayerNorm over rows of D: f32 mean, then the f32 mean of squared
// deviations, (x - mu) * 1/sqrt(var + 1e-5), then * scale + bias, each op
// rounded on its own (no contraction), the result rounded to T. One warp per
// row, 8 rows per block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int M,
               int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += to_f<T>(xr[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / (float)D;
  float s2 = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = __fsub_rn(to_f<T>(xr[i]), mu);
    s2 = __fadd_rn(s2, __fmul_rn(d, d));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  const float rstd = 1.0f / sqrtf(__fadd_rn(s2 / (float)D, 1e-5f));
  T* orow = out + (size_t)row * D;
  for (int i = lane; i < D; i += 32) {
    const float y = __fmul_rn(__fsub_rn(to_f<T>(xr[i]), mu), rstd);
    orow[i] = from_f<T>(__fadd_rn(__fmul_rn(y, scale[i]), bias[i]));
  }
}

template <typename T>
cudaError_t launch_ln_rows(const void* x, const float* scale,
                           const float* bias, void* out, int M, int D,
                           cudaStream_t stream) {
  ln_rows_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), M, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM: C[m, n] = sum_k A[m, k] B[k, n], A (M, K) row-major with row stride
// lda; B addressed per column group, B[k, n] = Bw[(n / gn) * gs + n % gn +
// k * ldb] (a plain (K, N) row-major matrix: gn = N, gs = 0, ldb = N; the
// per-head qkv weights (heads, K, 3hd): gn = 3hd, gs = K * 3hd, ldb = 3hd).
// ---------------------------------------------------------------------------
enum Epilogue {
  EPI_F32_BIAS = 0,  // out f32 = C + bias
  EPI_ACT = 1,       // out T = act(C + bias)
  EPI_RESID = 2,     // out T = (resid + C) + bias
};
enum Act { ACT_GELU = 0, ACT_QUICK_GELU = 1 };

constexpr int GBM = 128, GBN = 64, GBK = 8, GTHREADS = 256;

template <typename T>
__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_QUICK_GELU)
    return __fmul_rn(v, 1.0f / (1.0f + expf(-__fmul_rn(1.702f, v))));
  if (sizeof(T) == 2) {  // bf16: tanh approximation (layers.gelu's rule)
    const float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
    const float inner = __fmul_rn(
        kBeta, __fadd_rn(v, __fmul_rn(kKappa, __fmul_rn(__fmul_rn(v, v), v))));
    return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(inner)));
  }
  return __fmul_rn(__fmul_rn(v, 0.5f),
                   __fadd_rn(1.0f, erff(__fmul_rn(v, 0.7071067811865476f))));
}

template <typename T, int EPI>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ Bw,
            int ldb, int gn, long long gs, int M, int N, int K, int group,
            const float* __restrict__ bias, const T* __restrict__ resid,
            void* __restrict__ out, int ldo, int act) {
  __shared__ float As[GBK][GBM];
  __shared__ float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  // this thread's B column (the same for both of its loads)
  const int bcol = tid & 63, bk = tid >> 6;  // bk in 0..3; rows bk, bk + 4
  const int bn = n0 + bcol;
  const long long bbase = bn < N ? (gs ? (long long)(bn / gn) * gs + bn % gn
                                       : (long long)bn)
                                 : -1;

  float acc[8][4], part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + GTHREADS * r;
      const int row = idx >> 3, kk = idx & 7;
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? to_f<T>(A[(size_t)m * lda + k]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kk = bk + 4 * r, k = k0 + kk;
      Bs[kk][bcol] = (bbase >= 0 && k < K)
                         ? to_f<T>(Bw[bbase + (long long)k * ldb])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    const int kn = k0 + GBK;
    if (kn % group == 0 || kn >= K) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float c = acc[i][j];
      if (EPI == EPI_F32_BIAS) {
        static_cast<float*>(out)[(size_t)m * ldo + n] = __fadd_rn(c, bias[n]);
      } else if (EPI == EPI_ACT) {
        static_cast<T*>(out)[(size_t)m * ldo + n] =
            from_f<T>(activate<T>(__fadd_rn(c, bias[n]), act));
      } else {
        const float r = to_f<T>(resid[(size_t)m * ldo + n]);
        static_cast<T*>(out)[(size_t)m * ldo + n] =
            from_f<T>(__fadd_rn(__fadd_rn(r, c), bias[n]));
      }
    }
  }
}

template <typename T, int EPI>
cudaError_t launch_gemm(const void* A, int lda, const void* Bw, int ldb,
                        int gn, long long gs, int M, int N, int K, int group,
                        const float* bias, const void* resid, void* out,
                        int ldo, int act, cudaStream_t stream) {
  if (group < GBK || group % GBK) return cudaErrorInvalidValue;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<T, EPI><<<grid, GTHREADS, 0, stream>>>(
      static_cast<const T*>(A), lda, static_cast<const T*>(Bw), ldb, gn, gs,
      M, N, K, group, bias, static_cast<const T*>(resid), out, ldo, act);
  return cudaGetLastError();
}

}  // namespace ovo_block
