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
// views x 584 rows, C 1024, bf16) moves 16.7 MB: 0.005 ms, and 4.7 MB at
// Hiera-L's stage 4 (1024 x 1152): 0.0014 ms, far below the host-side cost
// of a launch. Both do ~10 operations per element.
//
// Design. ln_kernel (B8, and B14 at any other width): one warp per row,
// eight rows per 256-thread block. Each lane loads four consecutive
// elements at a time (8 bytes in bf16, 16 in f32), lanes on consecutive
// addresses, and keeps its up to GROUPS x 4 values in registers, so x and
// res are read once and out written once: GROUPS = 8 holds C <= 1024,
// GROUPS = 16 the wider rows B14 takes (up to 2048). The two sums are warp
// shuffles. A batch-1 res is read through a batch stride of 0: the (B, L,
// C) broadcast is never formed.
//
// ln_rows_kernel (B14 at the gated widths C = 1024 and 1152): C fixed at
// compile time, so the unrolled loops carry no guards. A lane's copies are
// 16 bytes of the wider of x's and scale's types (8 bf16 of x with bf16
// scale and bias; 4 elements, 16 bytes of f32 scale and 8 of bf16 x, with
// f32 ones), so every read and write is coalesced: 16-byte x copies with
// f32 scale would read scale and bias in half-used sectors, twice the L1
// traffic of the row. A row takes a whole warp where its copies split
// evenly over 32 lanes, else a half-warp (1152 in bf16 with bf16 scale:
// 144 copies, nine a lane), and its sums are balanced trees in the lane,
// then shuffles within those lanes. Blocks of 128 threads (four rows, or
// eight on half-warps) put 256 blocks on the 132 SMs at 1024 x 1152 with
// f32 scale and bias. B14 reads scale and bias in their own dtype (f32 or
// bf16), so the caller casts nothing; its rows need no division by L.
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

// RES: add res (B8); without it (B14) res, L and r_sb are unused. S: the
// type of scale and bias.
template <typename T, typename S, bool RES, int GROUPS>
__global__ void __launch_bounds__(THREADS)
ln_kernel(const T* __restrict__ x, const T* __restrict__ res,
          const S* __restrict__ scale, const S* __restrict__ bias,
          T* __restrict__ out, long long rows, int L, int C, long long r_sb,
          float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * C;
  const T* rr = xr;
  if (RES) {
    const long long b = row / L;
    rr = res + b * r_sb + (row - b * L) * C;
  }
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
      const float4 sc = load4<S>(scale + 4 * g);
      const float4 bi = load4<S>(bias + 4 * g);
      store4<T>(orow + 4 * g,
                make_float4(v[i].x * inv * sc.x + bi.x,
                            v[i].y * inv * sc.y + bi.y,
                            v[i].z * inv * sc.z + bi.z,
                            v[i].w * inv * sc.w + bi.w));
    }
  }
}

// N consecutive elements (N a multiple of 4; 4 N-byte aligned for f32, 2 N
// for bf16) as f32, and back
template <int N>
__device__ __forceinline__ void load_n(const float* p, float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + i);
    v[i] = a.x;
    v[i + 1] = a.y;
    v[i + 2] = a.z;
    v[i + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void load_n(const __nv_bfloat16* p,
                                       float (&v)[N]) {
  if constexpr (N % 8 != 0) {  // N == 4: one 8-byte load
    const float4 a = load4<__nv_bfloat16>(p);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = a.z;
    v[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[i + 2 * k] = __uint_as_float(w[k] << 16);
        v[i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
}
template <int N>
__device__ __forceinline__ void store_n(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int N>
__device__ __forceinline__ void store_n(__nv_bfloat16* p,
                                        const float (&v)[N]) {
  if constexpr (N % 8 != 0) {  // N == 4: one 8-byte store
    store4<__nv_bfloat16>(p, make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int i = 0; i < N; i += 8) {
      uint4 u;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h =
            __floats2bfloat162_rn(v[i + 2 * k], v[i + 2 * k + 1]);
        w[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(p + i) = u;
    }
  }
}

// v[0] + ... + v[N - 1] as a balanced tree of adds (a lane sums 32 to 72
// values)
template <int N>
__device__ __forceinline__ float tree_sum(const float* v) {
  if constexpr (N == 1)
    return v[0];
  else
    return tree_sum<N / 2>(v) + tree_sum<N - N / 2>(v + N / 2);
}

constexpr int ROWS_THREADS = 128;

// the elements of a lane's copies in ln_rows_kernel: 16 bytes of the wider
// of T and S, so that x, scale, bias and out are all read and written on
// consecutive addresses (bf16 x with f32 scale: 8 bytes of x, 16 of scale)
template <typename T, typename S>
__host__ __device__ constexpr int row_vec() {
  return 16 / (int)(sizeof(T) > sizeof(S) ? sizeof(T) : sizeof(S));
}

// the lanes a row of C elements takes: 32, or 16 where its copies do not
// split evenly over 32
template <typename T, typename S, int C>
__host__ __device__ constexpr int row_lanes() {
  return (C / row_vec<T, S>()) % 32 == 0 ? 32 : 16;
}

// B14 at a width C fixed at compile time: VEC elements a copy, a row on
// LANES lanes, NV copies a lane
template <typename T, typename S, int C>
__global__ void __launch_bounds__(ROWS_THREADS)
ln_rows_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               const S* __restrict__ bias, T* __restrict__ out,
               long long rows, float eps) {
  constexpr int VEC = row_vec<T, S>();
  constexpr int LANES = row_lanes<T, S, C>();
  static_assert(C % (VEC * LANES) == 0, "C must split evenly over the lanes");
  constexpr int NV = C / (VEC * LANES);
  const int lane = threadIdx.x % LANES;
  const long long row =
      (long long)blockIdx.x * (ROWS_THREADS / LANES) + threadIdx.x / LANES;
  if (row >= rows) return;
  // the row's lanes: the whole warp, or its half
  const unsigned mask =
      LANES == 32 ? 0xffffffffu : 0xffffu << (threadIdx.x & 16);
  const T* xr = x + row * C;
  float v[NV][VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j) load_n<VEC>(xr + (j * LANES + lane) * VEC, v[j]);
  float s = tree_sum<NV * VEC>(&v[0][0]);
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(mask, s, off);
  const float mean = s / (float)C;
  float sq[NV * VEC];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[j][e] -= mean;
      sq[j * VEC + e] = v[j][e] * v[j][e];
    }
  float q = tree_sum<NV * VEC>(sq);
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1)
    q += __shfl_xor_sync(mask, q, off);
  const float inv = rsqrtf(q / (float)C + eps);
  T* orow = out + row * C;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int col = (j * LANES + lane) * VEC;
    float sc[VEC], bi[VEC];
    load_n<VEC>(scale + col, sc);
    load_n<VEC>(bias + col, bi);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[j][e] = v[j][e] * inv * sc[e] + bi[e];
    store_n<VEC>(orow + col, v[j]);
  }
}

template <typename T, typename S, bool RES>
cudaError_t launch(const void* x, const void* res, const void* scale,
                   const void* bias, void* out, long long rows, int L, int C,
                   long long r_sb, float eps, cudaStream_t stream) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const S* g = static_cast<const S*>(scale);
  const S* b = static_cast<const S*>(bias);
  T* ot = static_cast<T*>(out);
  if (C <= 4 * 32 * NARROW)
    ln_kernel<T, S, RES, NARROW><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xt, rt, g, b, ot, rows, L, C, r_sb, eps);
  else
    ln_kernel<T, S, RES, WIDE><<<(unsigned)blocks, THREADS, 0, stream>>>(
        xt, rt, g, b, ot, rows, L, C, r_sb, eps);
  return cudaGetLastError();
}

template <typename T, typename S, int C>
cudaError_t launch_rows(const void* x, const void* scale, const void* bias,
                        void* out, long long rows, float eps,
                        cudaStream_t stream) {
  constexpr int per_block = ROWS_THREADS / row_lanes<T, S, C>();
  const long long blocks = (rows + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  ln_rows_kernel<T, S, C><<<(unsigned)blocks, ROWS_THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<const S*>(bias), static_cast<T*>(out), rows, eps);
  return cudaGetLastError();
}

// B14 by width: the gated widths fixed, every other through ln_kernel
template <typename T, typename S>
cudaError_t launch_ln_rows(const void* x, const void* scale, const void* bias,
                           void* out, long long rows, int C, float eps,
                           cudaStream_t stream) {
  if (C == 1024)
    return launch_rows<T, S, 1024>(x, scale, bias, out, rows, eps, stream);
  if (C == 1152)
    return launch_rows<T, S, 1152>(x, scale, bias, out, rows, eps, stream);
  return launch<T, S, false>(x, nullptr, scale, bias, out, rows, 1, C, 0, eps,
                             stream);
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
  const long long rows = (long long)B * L;
  if (dtype == 0)
    return (int)launch<float, float, true>(x, res, scale, bias, out, rows, L,
                                           C, r_sb, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, float, true>(x, res, scale, bias, out,
                                                   rows, L, C, r_sb, eps, s);
  return (int)cudaErrorInvalidValue;
}

// x (rows, C); scale, bias (C,) in sdtype; out (rows, C). Needs C % 4 == 0,
// C <= 2048 and 16-byte aligned pointers. dtype, sdtype: 0 = float32, 1 =
// bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_layer_norm_rows(const void* x, const void* scale,
                                   const void* bias, void* out,
                                   long long rows, int C, float eps,
                                   int dtype, int sdtype, void* stream) {
  if (rows < 1 || C < 4 || C % 4 || C > 4 * 32 * WIDE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  typedef __nv_bfloat16 bf16;
  if (dtype == 0 && sdtype == 0)
    return (int)launch_ln_rows<float, float>(x, scale, bias, out, rows, C,
                                             eps, s);
  if (dtype == 0 && sdtype == 1)
    return (int)launch_ln_rows<float, bf16>(x, scale, bias, out, rows, C, eps,
                                            s);
  if (dtype == 1 && sdtype == 0)
    return (int)launch_ln_rows<bf16, float>(x, scale, bias, out, rows, C, eps,
                                            s);
  if (dtype == 1 && sdtype == 1)
    return (int)launch_ln_rows<bf16, bf16>(x, scale, bias, out, rows, C, eps,
                                           s);
  return (int)cudaErrorInvalidValue;
}
