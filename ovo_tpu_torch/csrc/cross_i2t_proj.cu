// Image -> token cross attention with the image-side q projection folded
// in: the SAM decoder's image-to-token attention on its proj route (the
// out-projection and norm4 follow outside, norm4 through kernel B8).
//
// Replaces: ovo_tpu/ops/attention.py cross_i2t_from_keys -> _crossk_proj_call
// / _crossk_proj_kernel (a Pallas TPU kernel). It is kernel B4
// (csrc/cross_i2t_tail.cu) without the out-projection, residual and
// LayerNorm.
//
// What it computes, for prompt b and image row l (keys[l] of width dk, the
// query side; Wq (dk, D); D = heads * dh), in the reference's types:
//   kq[h,t,c] = sum_j k_tok[t, h*dh+j] Wq[c, h*dh+j], rounded to the dtype;
//   s[h,t]    = (kq[h,t] . keys[l] + k_tok[t, h-block] . pe_q[l, h-block])
//               * scale in f32, tokens t >= t_len set to -1e30;
//   p[h,:]    = softmax over the tokens of head h in f32, rounded to the dtype;
//   out[l, h*dh+j] = sum_t p[h,t] v_tok[t, h*dh+j] in f32, rounded once.
// That is softmax((keys Wq + pe_q) k_tok^T) v_tok per head with the (B, L, D)
// projection qq = keys Wq + pe_q never formed.
//
// What bounds it on an H100: at the 1280^2 AMG shape (256 prompts, L = 6400,
// dk = 256, D = 128, 8 heads x 8 tokens, bf16) a launch reads 839 MB of
// per-prompt keys and writes 420 MB (0.38 ms at 3.35 TB/s) for ~57 GFLOP,
// 54 of them kq . keys over dk. Done with f32 FMAs on the CUDA cores
// (~0.85 ms at 67 TF/s), so FMA issue and shared-memory traffic bound it.
//
// Design (B4's): two launches on the caller's stream.
//  1. kq_kernel, one block per prompt: kq for all (token, head) rows, into a
//     caller-allocated scratch (B, heads * NT, dk) in the working dtype (kq
//     is rounded to it), formed once per prompt.
//  2. i2t_kernel, one block of 256 threads per (prompt, 128 image rows): the
//     prompt's kq (rows padded to dk+4) and tokens are loaded once, then four
//     32-row tiles stream through. Per tile, the (32 rows x 64 kq rows) score
//     product is register-tiled (each thread 2 rows x 4 kq rows, four
//     elements per read); one thread per (row, head), the 32 rows of a head
//     on consecutive threads, adds the pe term, takes the token softmax and
//     forms its dh outputs in place of the pe values it alone read; the tile
//     is then written out row by row, consecutive threads on consecutive
//     columns. Batch-1 keys (the first two-way layer) or tokens are read
//     through a batch stride of 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BL = 32;     // image rows per tile
constexpr int TILES = 4;   // tiles per block
constexpr int TMAX = 16;   // tokens
constexpr int RMAX = 64;   // heads * tokens
constexpr int LDS = RMAX + 1;  // score rows: 32 rows of a column in 32 banks

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

// four elements copied as one load / store (16 bytes for f32, 8 for bf16)
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  typedef float4 type;
};
template <>
struct Vec4<__nv_bfloat16> {
  typedef uint2 type;
};

template <typename T>
__device__ __forceinline__ void copy4(T* dst, const T* src) {
  typedef typename Vec4<T>::type V;
  *reinterpret_cast<V*>(dst) = *reinterpret_cast<const V*>(src);
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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// kq[b, t*heads + h, c] for one prompt b per block
template <typename T>
__global__ void __launch_bounds__(THREADS)
kq_kernel(const T* __restrict__ kt, const T* __restrict__ wq,
          T* __restrict__ kq, int NT, int heads, int dk, int D,
          long long t_sb) {
  const int dh = D / heads, ldw = dh + 1;
  extern __shared__ float4 smem4[];
  float* kt_s = reinterpret_cast<float*>(smem4);  // NT x D
  float* w_s = kt_s + NT * D;                      // dk x ldw: one head of Wq
  const int b = blockIdx.x, tid = threadIdx.x;
  const T* ktb = kt + b * t_sb;
  T* kqb = kq + (long long)b * heads * NT * dk;
  for (int i = tid; i < NT * D; i += THREADS) kt_s[i] = to_f<T>(ktb[i]);
  for (int h = 0; h < heads; ++h) {
    __syncthreads();
    for (int i = tid; i < dk * dh; i += THREADS) {
      const int c = i / dh, j = i % dh;
      w_s[c * ldw + j] = to_f<T>(wq[c * D + h * dh + j]);
    }
    __syncthreads();
    for (int i = tid; i < NT * dk; i += THREADS) {
      const int t = i / dk, c = i % dk;
      const float* k = kt_s + t * D + h * dh;
      const float* w = w_s + c * ldw;
      float a = 0.f;
      for (int j = 0; j < dh; ++j) a = fmaf(k[j], w[j], a);
      kqb[(t * heads + h) * dk + c] = from_f<T>(a);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
i2t_kernel(const T* __restrict__ keys, const T* __restrict__ kq,
           const T* __restrict__ peq, const T* __restrict__ kt,
           const T* __restrict__ vt, T* __restrict__ out, int NT,
           int heads, int t_len, int L, int dk, int D, float scale,
           long long k_sb, long long t_sb, long long q_sb) {
  const int dh = D / heads, dh4 = dh / 4;
  const int R = heads * NT;  // kq row r = t * heads + h
  const int dk4 = dk / 4, D4 = D / 4;
  // kq rows padded to dk+4: the rows a quarter-warp (f32) or half-warp
  // (bf16) reads fall in distinct banks
  const int LDQ = dk + 4, LDK = dk + 4, LDE = D + 4;
  extern __shared__ float4 smem4[];
  T* kq_s = reinterpret_cast<T*>(smem4);                   // RMAX x LDQ
  float* ks_s = reinterpret_cast<float*>(kq_s + RMAX * LDQ);  // BL x LDK
  float* pe_s = ks_s + BL * LDK;  // BL x LDE: pe_q rows, then attn in place
  float* sc_s = pe_s + BL * LDE;  // BL x LDS
  float* kt_s = sc_s + BL * LDS;  // NT x D
  float* vt_s = kt_s + NT * D;    // NT x D

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* kb = keys + b * k_sb;
  const T* ktb = kt + b * t_sb;
  const T* vtb = vt + b * t_sb;
  const T* kqb = kq + b * q_sb;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < NT * D; i += THREADS) {
    kt_s[i] = to_f<T>(ktb[i]);
    vt_s[i] = to_f<T>(vtb[i]);
  }
  for (int i = tid; i < RMAX * dk4; i += THREADS) {
    const int r = i / dk4, c = (i % dk4) * 4;
    if (r < R) {
      copy4<T>(kq_s + r * LDQ + c, kqb + r * dk + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) kq_s[r * LDQ + c + e] = from_f<T>(0.f);
    }
  }

  // score tile: rows lsel and lsel + 16, kq rows rsel + 16 i
  const int rsel = tid & 15, lsel = tid >> 4;
  T* ob = out + (long long)b * L * D;

  for (int tile = 0; tile < TILES; ++tile) {
    const int l0 = (blockIdx.x * TILES + tile) * BL;
    if (l0 >= L) break;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BL * dk4; i += THREADS) {
      const int r = i / dk4, cc = (i % dk4) * 4, l = l0 + r;
      *reinterpret_cast<float4*>(ks_s + r * LDK + cc) =
          l < L ? load4<T>(kb + (long long)l * dk + cc) : zero;
    }
    for (int i = tid; i < BL * D4; i += THREADS) {
      const int r = i / D4, cc = (i % D4) * 4, l = l0 + r;
      *reinterpret_cast<float4*>(pe_s + r * LDE + cc) =
          l < L ? load4<T>(peq + (long long)l * D + cc) : zero;
    }
    __syncthreads();

    // s = kq . keys for 32 rows x 64 kq rows
    {
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* k0p = reinterpret_cast<const float4*>(ks_s + lsel * LDK);
      const float4* k1p =
          reinterpret_cast<const float4*>(ks_s + (lsel + 16) * LDK);
      const T* qp = kq_s + rsel * LDQ;
#pragma unroll 4
      for (int d4 = 0; d4 < dk4; ++d4) {
        const float4 a0 = k0p[d4], a1 = k1p[d4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 w = load4<T>(qp + i * 16 * LDQ + 4 * d4);
          s0[i] = dot4(a0, w, s0[i]);
          s1[i] = dot4(a1, w, s1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc_s[lsel * LDS + rsel + 16 * i] = s0[i];
        sc_s[(lsel + 16) * LDS + rsel + 16 * i] = s1[i];
      }
    }
    __syncthreads();

    // pe term, token softmax and attention, per (row, head); the rows of
    // one head are consecutive threads: the token rows are broadcasts and
    // the pe / score rows fall in distinct banks
    for (int pr = tid; pr < BL * heads; pr += THREADS) {
      const int l = pr % BL, h = pr / BL;
      const float4* pe4 = reinterpret_cast<const float4*>(
          pe_s + l * LDE + h * dh);
      float p[TMAX];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < TMAX; ++t) {
        if (t < NT) {
          const float4* k4 =
              reinterpret_cast<const float4*>(kt_s + t * D + h * dh);
          float e = 0.f;
          for (int j = 0; j < dh4; ++j) e = dot4(k4[j], pe4[j], e);
          const float sv = sc_s[l * LDS + t * heads + h];
          p[t] = t < t_len ? (sv + e) * scale : -1e30f;
          mx = fmaxf(mx, p[t]);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TMAX; ++t) {
        if (t < NT) {
          p[t] = expf(p[t] - mx);
          sum += p[t];
        }
      }
#pragma unroll
      for (int t = 0; t < TMAX; ++t)
        if (t < NT) p[t] = rnd<T>(p[t] / sum);
      // this thread alone read these pe values: attn takes their place
      float4* at4 = reinterpret_cast<float4*>(pe_s + l * LDE + h * dh);
      for (int j = 0; j < dh4; ++j) {
        float4 a = zero;
#pragma unroll
        for (int t = 0; t < TMAX; ++t) {
          if (t < NT) {
            const float4 v =
                reinterpret_cast<const float4*>(vt_s + t * D + h * dh)[j];
            a.x = fmaf(p[t], v.x, a.x);
            a.y = fmaf(p[t], v.y, a.y);
            a.z = fmaf(p[t], v.z, a.z);
            a.w = fmaf(p[t], v.w, a.w);
          }
        }
        at4[j] = make_float4(rnd<T>(a.x), rnd<T>(a.y), rnd<T>(a.z),
                             rnd<T>(a.w));
      }
    }
    __syncthreads();

    // the tile's attention rows, consecutive threads on consecutive columns
    for (int i = tid; i < BL * D4; i += THREADS) {
      const int r = i / D4, cc = (i % D4) * 4, l = l0 + r;
      if (l < L)
        store4<T>(ob + (long long)l * D + cc,
                  *reinterpret_cast<const float4*>(pe_s + r * LDE + cc));
    }
  }
}

template <typename T>
cudaError_t launch(const void* keys, const void* wq, const void* peq,
                   const void* kt, const void* vt, void* out, T* kq, int B,
                   int NT, int heads, int t_len, int L, int dk, int D,
                   float scale, long long k_sb, long long t_sb,
                   cudaStream_t stream) {
  const int dh = D / heads;
  const size_t smem_kq = sizeof(float) * ((size_t)NT * D + dk * (dh + 1));
  cudaError_t err = cudaFuncSetAttribute(
      kq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_kq);
  if (err != cudaSuccess) return err;
  const int nq = t_sb ? B : 1;
  kq_kernel<T><<<nq, THREADS, smem_kq, stream>>>(
      static_cast<const T*>(kt), static_cast<const T*>(wq), kq, NT, heads, dk,
      D, t_sb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem =
      sizeof(T) * (size_t)RMAX * (dk + 4) +
      sizeof(float) * ((size_t)BL * (dk + 4) + BL * (D + 4) + BL * LDS +
                       2 * NT * D);
  err = cudaFuncSetAttribute(
      i2t_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BL * TILES - 1) / (BL * TILES), B);
  const long long q_sb = t_sb ? (long long)heads * NT * dk : 0;
  i2t_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(keys), kq, static_cast<const T*>(peq),
      static_cast<const T*>(kt), static_cast<const T*>(vt),
      static_cast<T*>(out), NT, heads, t_len, L, dk, D, scale, k_sb, t_sb,
      q_sb);
  return cudaGetLastError();
}

}  // namespace

// keys (B or 1, L, dk) read at k_sb elements per batch (0 = shared); wq
// (dk, D); peq (L, D); kt, vt (B or 1, NT, D) at t_sb; out (B, L, D); kq a
// scratch of (B, or 1 when t_sb is 0) x heads * NT x dk elements of the
// dtype. Needs NT <= 16, heads * NT <= 64, dk % 16 == 0, dk <= 256,
// (D / heads) % 4 == 0, D <= 256 and 16-byte aligned pointers. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launches.
extern "C" int ovo_cross_i2t_proj(const void* keys, const void* wq,
                                  const void* peq, const void* kt,
                                  const void* vt, void* out, void* kq, int B,
                                  int NT, int heads, int t_len, int L, int dk,
                                  int D, float scale, long long k_sb,
                                  long long t_sb, int dtype, void* stream) {
  if (B < 1 || NT < 1 || NT > TMAX || heads < 1 || heads * NT > RMAX ||
      t_len < 1 || t_len > NT || L < 1 || dk < 16 || dk > THREADS ||
      dk % 16 || D % heads || (D / heads) % 4 || D > THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(keys, wq, peq, kt, vt, out,
                              static_cast<float*>(kq), B, NT, heads, t_len, L,
                              dk, D, scale, k_sb, t_sb, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(keys, wq, peq, kt, vt, out,
                                      static_cast<__nv_bfloat16*>(kq), B, NT,
                                      heads, t_len, L, dk, D, scale, k_sb,
                                      t_sb, s);
  return (int)cudaErrorInvalidValue;
}
