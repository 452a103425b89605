// Row LayerNorm, with or without a residual added first, in one pass.
//
// Two entry points:
//   ovo_residual_layer_norm -- replaces ovo_tpu/ops/layer_norm.py
//     residual_layer_norm -> _res_ln_call / _res_ln_kernel (kernel B8): the
//     SAM decoder's image-side norm4 on its unfused and proj routes;
//   ovo_layer_norm_rows -- replaces ovo_tpu/ops/layer_norm.py
//     layer_norm_rows -> _ln_call / _ln_kernel (kernel B14): B8 without the
//     residual, over the last axis of any leading shape.
//
// What it computes, for each row of x (rows, C) (and of res (B or 1, L, C)
// for B8): v = x (+ res) in f32; mean = sum(v) / C; cen = v - mean; var =
// sum(cen^2) / C (two passes over registers, not E[v^2] - mean^2); out =
// cen * rsqrt(var + eps) * scale + bias in f32, rounded once to the dtype.
//
// What bounds it on an H100: bytes. At the 1280^2 AMG shape (256 prompts,
// L = 6400, C = 256, bf16) a B8 launch reads x and a per-prompt res (839 MB
// each) and writes 839 MB: 2.5 GB, 0.75 ms at 3.35 TB/s (0.50 ms with a
// batch-1 res, read once: 3.3 MB). B14 at PE-Core-L14-336's LayerNorm (7
// views x 584 rows, C 1024, bf16) moves 16.7 MB: 0.005 ms, far below the
// host-side cost of a launch. Both do ~10 operations per element.
//
// Design: one warp per row, eight rows per 256-thread block. Each lane
// loads four consecutive elements at a time (8 bytes in bf16, 16 in f32),
// lanes on consecutive addresses, and keeps its up to GROUPS x 4 values in
// registers, so x and res are read once and out written once: GROUPS = 8
// holds C <= 1024, GROUPS = 16 the wider rows B14 takes (Hiera-L's 1152,
// ViT-H-14's 1280; up to 2048). The two sums are warp shuffles. A batch-1
// res is read through a batch stride of 0: the (B, L, C) broadcast is never
// formed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// four-element groups per lane: C <= 4 * 32 * GROUPS
constexpr int NARROW = 8;   // C <= 1024
constexpr int WIDE = 16;    // C <= 2048

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

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// RES: add res (B8); without it (B14) res, L and r_sb are unused
template <typename T, bool RES, int GROUPS>
__global__ void __launch_bounds__(THREADS)
ln_kernel(const T* __restrict__ x, const T* __restrict__ res,
          const float* __restrict__ scale, const float* __restrict__ bias,
          T* __restrict__ out, long long rows, int L, int C, long long r_sb,
          float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const long long b = row / L;
  const long long l = row - b * L;
  const T* xr = x + row * C;
  const T* rr = RES ? res + b * r_sb + l * C : xr;
  T* orow = out + row * C;
  const int C4 = C / 4;

  float4 v[GROUPS];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int g = lane + 32 * i;
    v[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < C4) {
      const float4 a = load4<T>(xr + 4 * g);
      if (RES) {
        const float4 r = load4<T>(rr + 4 * g);
        v[i] = make_float4(a.x + r.x, a.y + r.y, a.z + r.z, a.w + r.w);
      } else {
        v[i] = a;
      }
      s += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
  }
  const float mean = warp_sum(s) / (float)C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    if (lane + 32 * i < C4) {
      v[i].x -= mean;
      v[i].y -= mean;
      v[i].z -= mean;
      v[i].w -= mean;
      q += (v[i].x * v[i].x + v[i].y * v[i].y) +
           (v[i].z * v[i].z + v[i].w * v[i].w);
    }
  }
  const float inv = rsqrtf(warp_sum(q) / (float)C + eps);
#pragma unroll
  for (int i = 0; i < GROUPS; ++i) {
    const int g = lane + 32 * i;
    if (g < C4) {
      const float4 sc = *reinterpret_cast<const float4*>(scale + 4 * g);
      const float4 bi = *reinterpret_cast<const float4*>(bias + 4 * g);
      store4<T>(orow + 4 * g,
                make_float4(v[i].x * inv * sc.x + bi.x,
                            v[i].y * inv * sc.y + bi.y,
                            v[i].z * inv * sc.z + bi.z,
                            v[i].w * inv * sc.w + bi.w));
    }
  }
}

template <typename T, bool RES>
cudaError_t launch(const void* x, const void* res, const float* scale,
                   const float* bias, void* out, long long rows, int L, int C,
                   long long r_sb, float eps, cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if (C <= 4 * 32 * NARROW)
    ln_kernel<T, RES, NARROW><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xt, rt, scale, bias, ot, rows, L, C, r_sb, eps);
  else
    ln_kernel<T, RES, WIDE><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xt, rt, scale, bias, ot, rows, L, C, r_sb, eps);
  return cudaGetLastError();
}

}  // namespace

// x (B, L, C); res (B or 1, L, C) read at r_sb elements per batch (0 =
// shared); scale, bias (C,) f32; out (B, L, C). Needs C % 4 == 0, C <= 1024
// and 16-byte aligned pointers. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int ovo_residual_layer_norm(const void* x, const void* res,
                                       const void* scale, const void* bias,
                                       void* out, int B, int L, int C,
                                       long long r_sb, float eps, int dtype,
                                       void* stream) {
  if (B < 1 || L < 1 || C < 4 || C % 4 || C > 4 * 32 * NARROW)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const long long rows = (long long)B * L;
  if (dtype == 0)
    return (int)launch<float, true>(x, res, g, b, out, rows, L, C, r_sb, eps,
                                    s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, true>(x, res, g, b, out, rows, L, C,
                                            r_sb, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x (rows, C); scale, bias (C,) f32; out (rows, C). Needs C % 4 == 0, C <=
// 2048 and 16-byte aligned pointers. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int ovo_layer_norm_rows(const void* x, const void* scale,
                                   const void* bias, void* out,
                                   long long rows, int C, float eps,
                                   int dtype, void* stream) {
  if (rows < 1 || C < 4 || C % 4 || C > 4 * 32 * WIDE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  if (dtype == 0)
    return (int)launch<float, false>(x, nullptr, g, b, out, rows, 1, C, 0,
                                     eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, false>(x, nullptr, g, b, out, rows, 1,
                                             C, 0, eps, s);
  return (int)cudaErrorInvalidValue;
}
