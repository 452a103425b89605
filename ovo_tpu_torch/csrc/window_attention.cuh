// Device code of the whole-KV attention over many small instances, shared
// by kernel B2 (windowed_attention.cu: (B, H, L, hd) operands at any
// strides) and kernel B11 (packed_heads_attention.cu: the head-packed (B, L,
// heads * hd) layout, heads read at a column offset). The design notes are
// in windowed_attention.cu.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int KC_MAX = 64;
constexpr int SMEM_BUDGET = 96 * 1024;

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

// rows [c0, c0 + nk) of g_n instances starting at inst0 -> dst (f32), four
// elements per read
template <typename T, int HD>
__device__ __forceinline__ void load_chunk(const T* __restrict__ src,
                                           float* __restrict__ dst, int inst0,
                                           int g_n, int H, int c0, int nk,
                                           int IS, long long sb, long long sh,
                                           long long sl) {
  constexpr int HD4 = HD / 4;
  const int per = nk * HD4;
  for (int i = threadIdx.x; i < g_n * per; i += THREADS) {
    const int g = i / per, rem = i - g * per;
    const int j = rem / HD4, e = (rem - j * HD4) * 4;
    const int in = inst0 + g;
    const T* row = src + (in / H) * sb + (in % H) * sh + (c0 + j) * sl;
    *reinterpret_cast<float4*>(dst + g * IS + j * HD + e) = load4<T>(row + e);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
win_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int H, int n_inst,
           int Lq, int kv_len, float scale, int G, int KC, int R, int chunks,
           Strides st) {
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
  const T* qrow = q + b * st.qb + h * st.qh + row * st.ql;
#pragma unroll
  for (int d = 0; d < HD; d += 4) {
    const float4 x = active ? load4<T>(qrow + d)
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
    load_chunk<T, HD>(k, k_s, inst0, g_n, H, c0, nk, IS, st.kb, st.kh, st.kl);
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

  // pass 2: normalized weights rounded to the dtype, times v
  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;
  for (int c0 = 0; c0 < kv_len; c0 += KC) {
    const int nk = min(KC, kv_len - c0);
    __syncthreads();
    // one chunk holds all keys: pass 1 left it in shared memory
    if (kv_len > KC)
      load_chunk<T, HD>(k, k_s, inst0, g_n, H, c0, nk, IS, st.kb, st.kh,
                        st.kl);
    load_chunk<T, HD>(v, v_s, inst0, g_n, H, c0, nk, IS, st.vb, st.vh, st.vl);
    __syncthreads();
    if (active) {
      const float* kg = k_s + g * IS;
      const float* vg = v_s + g * IS;
      for (int j = 0; j < nk; ++j) {
        const float s = dot_row<HD>(qr, kg + j * HD) * scale;
        const float p = rnd<T>(expf(s - m) / l);
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
    T* o = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[d] = from_f<T>(acc[d]);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int kv_len, float scale,
                   const Strides& st, cudaStream_t stream) {
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
  const size_t smem = (size_t)G * per_inst;
  cudaError_t err = cudaFuncSetAttribute(
      win_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int grid = (n_inst + G - 1) / G * chunks;
  win_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, n_inst, Lq, kv_len,
      scale, G, KC, R, chunks, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Lq, int hd, int kv_len, float scale,
                     const Strides& st, cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 32: return launch<T, 32>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 48: return launch<T, 48>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 56: return launch<T, 56>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 64: return launch<T, 64>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 72: return launch<T, 72>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 80: return launch<T, 80>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 96: return launch<T, 96>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 112: return launch<T, 112>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    case 128: return launch<T, 128>(q, k, v, out, B, H, Lq, kv_len, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

