// Image -> token cross attention with its whole image-side tail: the SAM
// decoder's image-to-token attention, out-projection, keys residual and
// LayerNorm (norm4) in one pass, writing the next layer's keys.
//
// Replaces: ovo_tpu/ops/attention.py cross_i2t_tail_from_keys ->
// _crossk_proj_ln_call / _crossk_proj_ln_kernel (a Pallas TPU kernel).
//
// What it computes, for prompt b and image row l (keys[l] of width dk, the
// query side; Wq (dk, D); D = heads * dh), in the reference's types:
//   kq[h,t,c] = sum_j k_tok[t, h*dh+j] Wq[c, h*dh+j], rounded to the dtype;
//   s[h,t]    = (kq[h,t] . keys[l] + k_tok[t, h-block] . pe_q[l, h-block])
//               * scale in f32, tokens t >= t_len set to -1e30;
//   p[h,:]    = softmax over the tokens of head h in f32, normalized, then
//               rounded to the dtype;
//   attn[h*dh+j] = sum_t p[h,t] v_tok[t, h*dh+j] in f32, rounded;
//   y         = attn . Wout + bout in f32, rounded;
//   x         = y + keys[l] in f32; out = LayerNorm(x) (f32 mean, then the
//               mean of the squared centred values; eps) * scale + bias,
//               rounded.
//
// What bounds it on an H100: at the AMG shape (256 prompts, L = 4096,
// dk = 256, D = 128, 8 heads x 8 tokens, bf16) a launch needs ~110 GFLOP
// (111 us at 989 TF/s) and moves 537 MB of keys in and 537 MB out (320 us at
// 3.35 TB/s): bytes bound it.
//
// Two launches on the caller's stream. kq_kernel, one block per prompt,
// forms kq for all (token, head) rows into a caller-allocated scratch (B, or
// 1, x heads * NT x dk, rows t * heads + h) in the working dtype, from one
// head's columns of Wq at a time staged in shared memory: kq does not depend
// on the image row (f32 FMAs; a few MFLOP a prompt). Then, by dtype:
//
// bf16 (i2t_mma_kernel), on the tensor cores. A block of eight warps holds
// the prompt's kq (rows reordered to h * TP + t, TP = NT rounded up to a
// power of two, so a head's tokens are whole quads or whole n8 tiles of a
// score fragment), the block-diagonal k_tok and v_tok (row h * TP + t holds
// token t in head h's columns) and Wout (64 KB), all in shared memory. Each
// warp takes 16 image rows at a time through its own keys buffer (cp.async,
// 16-byte copies where pointer and strides allow), every product on
// mma.sync m16n8k16:
//  - S (16 x 64) = [keys | pe_q] . [kq | k_tok_bd]^T, K = dk + the pe_q
//    columns of each score tile's heads (pe_q's A fragments read straight
//    from device memory, where its 1 MB stays in L2);
//  - the softmax over each head's tokens: a max and a sum over the lanes of
//    a quad (XOR shuffles 1, 2), or over two n8 tiles when NT > 8; p
//    normalized, rounded, and reused from the C fragments as the A
//    fragments of attn = p . v_tok_bd over the heads' blocks;
//  - attn rounded and reused the same way as the A fragments of
//    y = attn . Wout (ldmatrix.trans on Wout), in two column halves of 64
//    f32 accumulators a thread, + bout, rounded and kept packed as bf16;
//  - x = y + keys from the buffer already in shared memory (keys are read
//    once), the LayerNorm's mean and centred variance reduced over the quad,
//    the output written over the keys rows and stored in 16-byte copies.
// The (B, L, D) attention output, the projected tensor and the residual sum
// never reach device memory.
//
// float32 (i2t_kernel) keeps the first design, f32 FMAs on the CUDA cores:
// one block of 256 threads per (prompt, 128 image rows); the (32 rows x 64
// kq rows) score product register-tiled, one thread per (row, head) for the
// pe term, softmax and attn, one thread per output column for attn . Wout,
// the row statistics reduced with warp shuffles. The first design ran bf16
// too, at 7.007 ms (per-prompt keys) and 6.769 (shared) at the AMG shape.
// Batch-1 keys (the first two-way layer) or tokens are read through a batch
// stride of 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int NW = THREADS / 32;
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

// each warp's sums of x (or x^2) over its 32 threads, every row -> red_s
template <bool SQUARE>
__device__ __forceinline__ void row_sums(const float (&x)[BL],
                                         float* __restrict__ red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < BL; ++l) {
    float v = SQUARE ? x[l] * x[l] : x[l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red_s[warp * BL + l] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
i2t_kernel(const T* __restrict__ keys, const T* __restrict__ kq,
           const T* __restrict__ peq, const T* __restrict__ kt,
           const T* __restrict__ vt, const T* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ lns,
           const float* __restrict__ lnb, T* __restrict__ out, int NT,
           int heads, int t_len, int L, int dk, int D, float scale, float eps,
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
  float* red_s = vt_s + NT * D;   // NW x BL

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
  const int c = tid;  // out-projection / LayerNorm column
  const bool cok = c < dk;
  const float bc = cok ? bout[c] : 0.f;
  const float g = cok ? lns[c] : 0.f, bb = cok ? lnb[c] : 0.f;
  T* ob = out + (long long)b * L * dk;

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

    // out-projection, bias, keys residual: thread c owns column c of all rows
    float x[BL];
#pragma unroll
    for (int l = 0; l < BL; ++l) x[l] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = cok ? to_f<T>(wout[(d + i) * dk + c]) : 0.f;
#pragma unroll
      for (int l = 0; l < BL; ++l) {
        const float4 a = reinterpret_cast<const float4*>(pe_s + l * LDE + d)[0];
        x[l] = fmaf(a.x, w[0], x[l]);
        x[l] = fmaf(a.y, w[1], x[l]);
        x[l] = fmaf(a.z, w[2], x[l]);
        x[l] = fmaf(a.w, w[3], x[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < BL; ++l)
      x[l] = cok ? rnd<T>(x[l] + bc) + ks_s[l * LDK + c] : 0.f;

    // LayerNorm over the dk columns of each row, f32 statistics
    row_sums<false>(x, red_s);
    __syncthreads();
#pragma unroll
    for (int l = 0; l < BL; ++l) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) t += red_s[w * BL + l];
      x[l] = cok ? x[l] - t / (float)dk : 0.f;
    }
    __syncthreads();
    row_sums<true>(x, red_s);
    __syncthreads();
    if (cok) {
#pragma unroll
      for (int l = 0; l < BL; ++l) {
        if (l0 + l < L) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) t += red_s[w * BL + l];
          const float inv = rsqrtf(t / (float)dk + eps);
          ob[(long long)(l0 + l) * dk + c] = from_f<T>(x[l] * inv * g + bb);
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch_kq(const void* kt, const void* wq, T* kq, int B, int NT,
                      int heads, int dk, int D, long long t_sb,
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
  return cudaGetLastError();
}

cudaError_t launch_fma(const void* keys, const void* wq, const void* peq,
                       const void* kt, const void* vt, const void* wout,
                       const float* bout, const float* lns, const float* lnb,
                       void* out, float* kq, int B, int NT, int heads,
                       int t_len, int L, int dk, int D, float scale,
                       float eps, long long k_sb, long long t_sb,
                       cudaStream_t stream) {
  cudaError_t err = launch_kq<float>(kt, wq, kq, B, NT, heads, dk, D, t_sb,
                                     stream);
  if (err != cudaSuccess) return err;
  const size_t smem =
      sizeof(float) * (size_t)RMAX * (dk + 4) +
      sizeof(float) * ((size_t)BL * (dk + 4) + BL * (D + 4) + BL * LDS +
                       2 * NT * D + NW * BL);
  err = cudaFuncSetAttribute(
      i2t_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BL * TILES - 1) / (BL * TILES), B);
  const long long q_sb = t_sb ? (long long)heads * NT * dk : 0;
  i2t_kernel<float><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(keys), kq, static_cast<const float*>(peq),
      static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<const float*>(wout), bout, lns, lnb,
      static_cast<float*>(out), NT, heads, t_len, L, dk, D, scale, eps, k_sb,
      t_sb, q_sb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int DPAD = 128;   // D at most, the block-diagonal tokens' width
constexpr int TPW = 8;      // 16-row tiles a warp takes in one block

struct I2tArgs {
  const bf16* keys;   // (B or 1, L, dk)
  const bf16* kq;     // (B or 1, heads * NT, dk): row t * heads + h
  const bf16* peq;    // (L, D), 4-byte aligned
  const bf16* kt;     // (B or 1, NT, D)
  const bf16* vt;     // (B or 1, NT, D)
  const bf16* wout;   // (D, dk)
  const float* bout;  // (dk,)
  const float* lns;   // (dk,)
  const float* lnb;   // (dk,)
  bf16* out;          // (B, L, dk)
  int NT, heads, t_len, L, dk, D;
  float scale, eps;
  long long k_sb, t_sb, q_sb;
  int vs_k, vs_w;     // copy widths (vector_shift) of keys and wout
};

// TP: tokens a head takes in the score columns (NT rounded up to a power of
// two, at least 2; columns h * TP + t); RP: score columns, heads * TP
// rounded up to 64 or 128. DKC, DC, HC: dk, D and heads fixed at compile
// time (0: read at run time). The SAM decoder's widths (256, 128, 8) get
// their own instantiation: with the shape known, the unrolled loops lose
// their run-time guards and the code shrinks by more than half, which
// more than halves the kernel's time at the AMG shape on an H100.
template <int TP, int RP, int DKC, int DC, int HC>
__global__ void __launch_bounds__(256, 1) i2t_mma_kernel(I2tArgs a) {
  constexpr int NS = RP / 8;       // n8 score tiles
  constexpr int ND = DPAD / 8;     // n8 attention tiles
  const int dk = DKC ? DKC : a.dk, D = DC ? DC : a.D;
  const int NT = a.NT, heads = HC ? HC : a.heads;
  const int dh = D / heads;
  const int nw = blockDim.x >> 5;
  const int LDK = dk + 8, LDE = DPAD + 8;  // odd 16-byte units
  const int DP16 = (D + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wo_s = reinterpret_cast<bf16*>(smem_raw);  // DP16 x LDK
  bf16* kq_s = wo_s + DP16 * LDK;                  // RP x LDK
  bf16* kb_s = kq_s + RP * LDK;                    // RP x LDE, k_tok block-diag
  bf16* vb_s = kb_s + RP * LDE;                    // RP x LDE, v_tok block-diag
  bf16* ks_s = vb_s + RP * LDE;                    // nw x 16 x LDK
  float* bo_s = reinterpret_cast<float*>(ks_s + nw * 16 * LDK);  // dk
  float* ln_s = bo_s + dk;  // dk scale, then dk bias

  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  const bf16 zero = __float2bfloat16_rn(0.f);
  const bf16* kb = a.keys + b * a.k_sb;
  const bf16* kqb = a.kq + b * a.q_sb;
  const bf16* ktb = a.kt + b * a.t_sb;
  const bf16* vtb = a.vt + b * a.t_sb;

  // Wout, kq (rows reordered to h * TP + t) and the block-diagonal tokens
  load_rows(wo_s, LDK, a.wout, dk, 0, DP16, D, dk, a.vs_w, tid, blockDim.x);
  for (int i = tid; i < RP * (dk / 8); i += blockDim.x) {
    const int r = i / (dk / 8), col = 8 * (i % (dk / 8));
    const int h = r / TP, t = r % TP;
    const bool ok = h < heads && t < NT;
    copy_async(kq_s + r * LDK + col,
               kqb + (ok ? (t * heads + h) * dk + col : 0), ok, 3);
  }
  cp_async_commit();
  for (int i = tid; i < dk; i += blockDim.x) {
    bo_s[i] = a.bout[i];
    ln_s[i] = a.lns[i];
    ln_s[dk + i] = a.lnb[i];
  }
  for (int i = tid; i < RP * DPAD; i += blockDim.x) {
    const int r = i / DPAD, d = i % DPAD;
    const int h = r / TP, t = r % TP;
    const bool ok = h < heads && t < NT && d < D && d / dh == h;
    kb_s[r * LDE + d] = ok ? ktb[t * D + d] : zero;
    vb_s[r * LDE + d] = ok ? vtb[t * D + d] : zero;
  }
  cp_async_wait<0>();
  __syncthreads();

  bf16* ks_w = ks_s + warp * 16 * LDK;
  const int rows_per_block = nw * TPW * 16;
  const int nkd = DP16 / 16;  // k16 chunks of D
  const int ncol = dk / 16;   // n8 tiles of a column half of y
  for (int tile = 0; tile < TPW; ++tile) {
    const int l0 = blockIdx.x * rows_per_block + (tile * nw + warp) * 16;
    if (l0 >= a.L) break;
    load_rows(ks_w, LDK, kb, dk, l0, 16, a.L, dk, a.vs_k, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // scores S (16 rows x RP) = [keys | pe_q] . [kq | k_tok_bd]^T
    // pe_q's A fragments first: their loads from device memory overlap the
    // keys' products
    const int rA = l0 + g, rB = l0 + g + 8;
    auto pe2 = [&](int row, int d) -> uint32_t {
      return row < a.L && d < D ? *reinterpret_cast<const uint32_t*>(
                                      a.peq + (size_t)row * D + d)
                                : 0u;
    };
    uint32_t pa[DPAD / 16][4];
#pragma unroll
    for (int kc = 0; kc < DPAD / 16; ++kc) {
      const int d0 = 16 * kc + 2 * c;
      pa[kc][0] = pe2(rA, d0);
      pa[kc][1] = pe2(rB, d0);
      pa[kc][2] = pe2(rA, d0 + 8);
      pa[kc][3] = pe2(rB, d0 + 8);
    }
    float S[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) S[n][0] = S[n][1] = S[n][2] = S[n][3] = 0.f;
    for (int kt = 0; kt < dk / 16; ++kt) {
      uint32_t ka[4], kf[NS / 2][4];
      ldmatrix_x4(ka, ks_w + a_row * LDK + 16 * kt + a_col);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj)
        ldmatrix_x4(kf[jj], kq_s + (16 * jj + b_row) * LDK + 16 * kt + b_col);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        mma_bf16(S[2 * jj], ka, kf[jj][0], kf[jj][1]);
        mma_bf16(S[2 * jj + 1], ka, kf[jj][2], kf[jj][3]);
      }
    }
#pragma unroll
    for (int kc = 0; kc < DPAD / 16; ++kc) {
      if (kc >= nkd) break;
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        // the heads of score columns [16 jj, 16 jj + 16) and their columns
        // of pe_q: skip the zero blocks of k_tok_bd
        const int ha = 16 * jj / TP, hb = (16 * jj + 15) / TP;
        if (ha >= heads || (hb + 1) * dh <= 16 * kc || ha * dh >= 16 * kc + 16)
          continue;
        uint32_t kf[4];
        ldmatrix_x4(kf, kb_s + (16 * jj + b_row) * LDE + 16 * kc + b_col);
        mma_bf16(S[2 * jj], pa[kc], kf[0], kf[1]);
        mma_bf16(S[2 * jj + 1], pa[kc], kf[2], kf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = (8 * n + 2 * c + (e & 1)) % TP;
        S[n][e] = t < a.t_len ? S[n][e] * a.scale : -1e30f;
      }

    // softmax over each head's tokens: TP / 8 whole tiles (TP 16), or the
    // lanes of a quad that share a head (TP 8: four, 4: two, 2: one)
    constexpr int GT = TP >= 8 ? TP / 8 : 1;   // tiles of a head
    constexpr int XMAX = TP >= 8 ? 4 : TP / 2;  // shuffle span in the quad
    uint32_t pA[RP / 16][4];
#pragma unroll
    for (int n0 = 0; n0 < NS; n0 += GT) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = n0; n < n0 + GT; ++n)
          mx = fmaxf(mx, fmaxf(S[n][2 * hh], S[n][2 * hh + 1]));
#pragma unroll
        for (int off = 1; off < XMAX; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        float sum = 0.f;
#pragma unroll
        for (int n = n0; n < n0 + GT; ++n) {
          S[n][2 * hh] = expf(S[n][2 * hh] - mx);
          S[n][2 * hh + 1] = expf(S[n][2 * hh + 1] - mx);
          sum += S[n][2 * hh] + S[n][2 * hh + 1];
        }
#pragma unroll
        for (int off = 1; off < XMAX; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float rl = 1.f / sum;
        // p normalized, then rounded (the reference's rounding point), as
        // the A fragments of p . v_tok_bd
#pragma unroll
        for (int n = n0; n < n0 + GT; ++n)
          pA[n >> 1][hh + 2 * (n & 1)] =
              pack_bf16(div_by_sum(S[n][2 * hh], sum, rl),
                        div_by_sum(S[n][2 * hh + 1], sum, rl));
      }
    }

    // attn (16 x DPAD) = p . v_tok_bd over the heads' blocks
    float at[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) at[n][0] = at[n][1] = at[n][2] = at[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < RP / 16; ++kc) {
      const int ha = 16 * kc / TP;
      if (ha >= heads) continue;
      const int hb = min((16 * kc + 15) / TP, heads - 1);
      const int c_lo = ha * dh, c_hi = (hb + 1) * dh;
      const bf16* vrow = vb_s + (16 * kc + a_row) * LDE;
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        if (16 * np >= c_hi || 16 * np + 16 <= c_lo) continue;
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vrow + 16 * np + a_col);
        mma_bf16(at[2 * np], pA[kc], vf[0], vf[1]);
        mma_bf16(at[2 * np + 1], pA[kc], vf[2], vf[3]);
      }
    }
    // attn rounded (the reference's attn.astype), as the A fragments of
    // attn . Wout
    uint32_t aA[ND / 2][4];
#pragma unroll
    for (int kd = 0; kd < ND / 2; ++kd) {
      aA[kd][0] = pack_bf16(at[2 * kd][0], at[2 * kd][1]);
      aA[kd][1] = pack_bf16(at[2 * kd][2], at[2 * kd][3]);
      aA[kd][2] = pack_bf16(at[2 * kd + 1][0], at[2 * kd + 1][1]);
      aA[kd][3] = pack_bf16(at[2 * kd + 1][2], at[2 * kd + 1][3]);
    }

    // y = attn Wout + bout, rounded, in two column halves; kept packed
    uint32_t yv[2][16][2];
#pragma unroll
    for (int yh = 0; yh < 2; ++yh) {
      const int col0 = yh * (dk / 2);
      float acc[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < ND / 2; ++kd) {
        if (kd >= nkd) break;
        const bf16* wrow = wo_s + (16 * kd + a_row) * LDK + col0;
        uint32_t wf[8][4];
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (2 * np + 1 < ncol) {
            ldmatrix_x4_trans(wf[np], wrow + 16 * np + a_col);
          } else if (2 * np < ncol) {
            uint32_t w2[2];
            ldmatrix_x2_trans(w2, wrow + 16 * np);
            wf[np][0] = w2[0];
            wf[np][1] = w2[1];
          }
        }
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (2 * np < ncol) mma_bf16(acc[2 * np], aA[kd], wf[np][0], wf[np][1]);
          if (2 * np + 1 < ncol)
            mma_bf16(acc[2 * np + 1], aA[kd], wf[np][2], wf[np][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n < ncol) {
          const int col = col0 + 8 * n + 2 * c;
          const float b0 = bo_s[col], b1 = bo_s[col + 1];
          yv[yh][n][0] = pack_bf16(acc[n][0] + b0, acc[n][1] + b1);
          yv[yh][n][1] = pack_bf16(acc[n][2] + b0, acc[n][3] + b1);
        }
      }
    }

    // x = y + keys in f32; LayerNorm over dk: the mean, then the mean of
    // the squared centred values, each reduced over the quad; the output
    // takes y's registers, then overwrites the keys rows in shared memory
    // and leaves in 16-byte stores
    auto x_at = [&](int yh, int n, int hh, float (&x)[2]) {
      const int col = yh * (dk / 2) + 8 * n + 2 * c;
      const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          ks_w + (g + 8 * hh) * LDK + col));
      const uint32_t y = yv[yh][n][hh];
      x[0] = __uint_as_float(y << 16) + k2.x;
      x[1] = __uint_as_float(y & 0xffff0000u) + k2.y;
    };
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = 0.f;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < ncol) {
            float x[2];
            x_at(yh, n, hh, x);
            sum += x[0] + x[1];
          }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / (float)dk;
      float sq = 0.f;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < ncol) {
            float x[2];
            x_at(yh, n, hh, x);
            const float c0 = x[0] - mean, c1 = x[1] - mean;
            sq += c0 * c0 + c1 * c1;
          }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      const float inv = rsqrtf(sq / (float)dk + a.eps);
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < ncol) {
            float x[2];
            x_at(yh, n, hh, x);
            const int col = yh * (dk / 2) + 8 * n + 2 * c;
            yv[yh][n][hh] =
                pack_bf16((x[0] - mean) * inv * ln_s[col] + ln_s[dk + col],
                          (x[1] - mean) * inv * ln_s[col + 1] +
                              ln_s[dk + col + 1]);
          }
    }
#pragma unroll
    for (int yh = 0; yh < 2; ++yh)
#pragma unroll
      for (int n = 0; n < 16; ++n)
        if (n < ncol) {
          const int col = yh * (dk / 2) + 8 * n + 2 * c;
          *reinterpret_cast<uint32_t*>(ks_w + g * LDK + col) = yv[yh][n][0];
          *reinterpret_cast<uint32_t*>(ks_w + (g + 8) * LDK + col) =
              yv[yh][n][1];
        }
    __syncwarp();
    bf16* ob = a.out + ((size_t)b * a.L + l0) * dk;
    for (int i = lane; i < 16 * (dk / 8); i += 32) {
      const int r = i / (dk / 8), col = 8 * (i % (dk / 8));
      if (l0 + r < a.L)
        *reinterpret_cast<uint4*>(ob + (size_t)r * dk + col) =
            *reinterpret_cast<const uint4*>(ks_w + r * LDK + col);
    }
    __syncwarp();  // the keys buffer is refilled next
  }
}

template <int TP, int RP, int DKC = 0, int DC = 0, int HC = 0>
cudaError_t launch_mma_tp(const I2tArgs& a, int B, cudaStream_t stream) {
  const int nw = RP == 64 ? 8 : 2;  // shared memory: 202 KB / 220 KB at most
  const int DP16 = (a.D + 15) / 16 * 16, LDK = a.dk + 8;
  const size_t smem = sizeof(bf16) * ((size_t)(DP16 + RP + nw * 16) * LDK +
                                      2 * (size_t)RP * (DPAD + 8)) +
                      sizeof(float) * 3 * a.dk;
  cudaError_t err = cudaFuncSetAttribute(
      i2t_mma_kernel<TP, RP, DKC, DC, HC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int rows = nw * TPW * 16;
  dim3 grid((a.L + rows - 1) / rows, B);
  i2t_mma_kernel<TP, RP, DKC, DC, HC><<<grid, 32 * nw, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_mma(I2tArgs a, int B, cudaStream_t stream) {
  const int TP = a.NT <= 2 ? 2 : a.NT <= 4 ? 4 : a.NT <= 8 ? 8 : 16;
  const bool wide = a.heads * TP > 64;
  if (TP == 8 && a.dk == 256 && a.D == 128 && a.heads == 8)
    return launch_mma_tp<8, 64, 256, 128, 8>(a, B, stream);
  switch (TP) {
    case 2: return wide ? launch_mma_tp<2, 128>(a, B, stream)
                        : launch_mma_tp<2, 64>(a, B, stream);
    case 4: return wide ? launch_mma_tp<4, 128>(a, B, stream)
                        : launch_mma_tp<4, 64>(a, B, stream);
    case 8: return wide ? launch_mma_tp<8, 128>(a, B, stream)
                        : launch_mma_tp<8, 64>(a, B, stream);
    default: return wide ? launch_mma_tp<16, 128>(a, B, stream)
                         : launch_mma_tp<16, 64>(a, B, stream);
  }
}

}  // namespace

// keys (B or 1, L, dk) read at k_sb elements per batch (0 = shared); wq
// (dk, D); peq (L, D); kt, vt (B or 1, NT, D) at t_sb; wout (D, dk); bout,
// lns, lnb (dk,) f32; out (B, L, dk); kq a scratch of (B, or 1 when t_sb is
// 0) x heads * NT x dk elements of the dtype. Needs NT <= 16, heads * NT <= 64,
// dk % 16 == 0, dk <= 256, (D / heads) % 4 == 0; in bf16 also D <= 128 and
// a 4-byte aligned peq (keys and wout at any alignment), in f32 16-byte
// aligned pointers. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launches.
extern "C" int ovo_cross_i2t_tail(const void* keys, const void* wq,
                                  const void* peq, const void* kt,
                                  const void* vt, const void* wout,
                                  const void* bout, const void* lns,
                                  const void* lnb, void* out, void* kq,
                                  int B, int NT, int heads, int t_len, int L,
                                  int dk, int D, float scale, float eps,
                                  long long k_sb, long long t_sb, int dtype,
                                  void* stream) {
  if (B < 1 || NT < 1 || NT > TMAX || heads < 1 || heads * NT > RMAX ||
      t_len < 1 || t_len > NT || L < 1 || dk < 16 || dk > THREADS ||
      dk % 16 || D % heads || (D / heads) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bo = static_cast<const float*>(bout);
  const float* g = static_cast<const float*>(lns);
  const float* bb = static_cast<const float*>(lnb);
  if (dtype == 0)
    return (int)launch_fma(keys, wq, peq, kt, vt, wout, bo, g, bb, out,
                           static_cast<float*>(kq), B, NT, heads, t_len, L,
                           dk, D, scale, eps, k_sb, t_sb, s);
  if (dtype == 1) {
    if (D > DPAD || reinterpret_cast<uintptr_t>(peq) % 4)
      return (int)cudaErrorInvalidValue;
    I2tArgs a;
    a.keys = static_cast<const bf16*>(keys);
    a.kq = static_cast<const bf16*>(kq);
    a.peq = static_cast<const bf16*>(peq);
    a.kt = static_cast<const bf16*>(kt);
    a.vt = static_cast<const bf16*>(vt);
    a.wout = static_cast<const bf16*>(wout);
    a.bout = bo;
    a.lns = g;
    a.lnb = bb;
    a.out = static_cast<bf16*>(out);
    a.NT = NT;
    a.heads = heads;
    a.t_len = t_len;
    a.L = L;
    a.dk = dk;
    a.D = D;
    a.scale = scale;
    a.eps = eps;
    a.k_sb = k_sb;
    a.t_sb = t_sb;
    a.q_sb = t_sb ? (long long)heads * NT * dk : 0;
    const long long sk[2] = {dk, k_sb}, sw[1] = {dk};
    a.vs_k = vector_shift(&keys, 1, sk, 2, dk);
    a.vs_w = vector_shift(&wout, 1, sw, 1, dk);
    cudaError_t err = launch_kq<bf16>(kt, wq, static_cast<bf16*>(kq), B, NT,
                                      heads, dk, D, t_sb, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_mma(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
