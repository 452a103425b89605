// The SAM decoder's mask tail in one kernel: second upscale, bias, high-res
// skip, tanh-gelu and the hypernetwork dot.
//
// Replaces: ovo_tpu/ops/mask_tail.py fused_mask_tail / _mask_tail_kernel (a
// Pallas TPU kernel).
//
// What it computes, for prompt b, row r of up1g (B, R, C1) -- R = H * W * 4
// rows in (h, w, i, j) order, the first upscale's gelu(LN(.)) activation --
// and each output tap t = p * 2 + q of the 2x2 transposed conv, exactly in
// _mask_tail_kernel's op order:
//   y   = up1g[b, r] . w2q[t]         (C1 -> C2, f32 accumulation)
//   y   = bf16(y); y = bf16(y + b2); y = bf16(y + hr0q[t, r])
//   g   = tanh-gelu(y), every op of jax.nn.gelu(approximate=True) on bf16
//         rounded to bf16 in its order: x^3 = x * (x * x), 0.044715 * x^3,
//         x + ., sqrt(2/pi) * ., tanh, 1 + ., 0.5 * ., x * cdf (both
//         constants rounded to bf16 first, as JAX casts them)
//   out[b, t, r, c] = sum over C2 of g * hyper[b, c] in f32  (c < C)
// Pixel (4h + 2i + p, 4w + 2j + q) of the mask is out[b, p * 2 + q, (h, w,
// i, j), c]; mask_tail_to_raster permutes it outside the kernel.
//
// What bounds it on an H100: bytes. At the AMG shape (128 prompts after the
// gate, H = W = 64, C1 = 64, C2 = 32, C = 3) a launch reads up1g (268 MB)
// and hr0q (4 MB) and writes 101 MB of f32 logits: 0.111 ms at 3.35 TB/s;
// its 36 GFLOP are 0.036 ms at the bf16 tensor rate. This first design does
// the products with f32 FMAs on the CUDA cores (0.54 ms at their peak).
//
// Design: a block of 128 threads takes 128 consecutive rows and PB prompts,
// one thread per row. The weights (w2q as f32, 32 KB), the bias and the
// block's hr0q rows for the four taps (bf16, 32 KB) are staged in shared
// memory once and serve all PB prompts: hr0q is shared across prompts, as the
// TPU grid's (hband, prompt) order kept it resident. For each prompt a
// thread holds its up1g row in registers (read once), runs the four taps,
// and stages its C logits per tap in shared memory; the block then writes
// each tap's 128 x C floats, a contiguous run of out, with consecutive
// threads on consecutive words (C = 3 would leave each thread 12-byte
// stores otherwise).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;  // rows per block
constexpr int PB = 8;         // prompts per block
constexpr int MAX_C = 4;      // hypernet channels
// jax.nn.gelu's constants as bf16 (0.044715 and sqrt(2 / pi))
constexpr float GELU_A = 0x1.6ep-5f;  // 0.044677734375
constexpr float GELU_S = 0x1.98p-1f;  // 0.796875

__device__ __forceinline__ float bf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float gelu_bf16(float x) {
  const float x3 = bf(x * bf(x * x));
  const float u = bf(GELU_S * bf(x + bf(GELU_A * x3)));
  const float cdf = bf(0.5f * bf(1.0f + bf(tanhf(u))));
  return bf(x * cdf);
}

template <int C1, int C2>
__global__ void __launch_bounds__(THREADS)
mask_tail_kernel(const __nv_bfloat16* __restrict__ up1g,
                 const __nv_bfloat16* __restrict__ w2q,
                 const __nv_bfloat16* __restrict__ b2,
                 const __nv_bfloat16* __restrict__ hr0q,
                 const __nv_bfloat16* __restrict__ hyper,
                 float* __restrict__ out, int B, int R, int C) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);            // 4 x C1 x C2
  float* b_s = w_s + 4 * C1 * C2;                           // C2
  float* hy_s = b_s + C2;                                   // MAX_C x C2
  float* o_s = hy_s + MAX_C * C2;                           // 4 x THREADS x C
  __nv_bfloat16* hr_s =
      reinterpret_cast<__nv_bfloat16*>(o_s + 4 * THREADS * MAX_C);
  // hr_s: 4 x THREADS x C2

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * THREADS;
  const int nr = min(THREADS, R - r0);
  const int b0 = blockIdx.y * PB;
  const int nb = min(PB, B - b0);

  for (int i = tid; i < 4 * C1 * C2; i += THREADS) w_s[i] = to_f(w2q[i]);
  for (int i = tid; i < C2; i += THREADS) b_s[i] = to_f(b2[i]);
  for (int i = tid; i < 4 * THREADS * C2; i += THREADS) {
    const int t = i / (THREADS * C2), rem = i - t * THREADS * C2;
    const int rr = rem / C2;
    hr_s[i] = rr < nr ? hr0q[((long long)t * R + r0) * C2 + rem]
                      : __float2bfloat16_rn(0.f);
  }

  for (int pb = 0; pb < nb; ++pb) {
    const int b = b0 + pb;
    __syncthreads();  // the previous prompt's o_s is written out
    for (int i = tid; i < C * C2; i += THREADS)
      hy_s[i] = to_f(hyper[(long long)b * C * C2 + i]);
    __syncthreads();
    if (tid < nr) {
      float x[C1];
      const uint4* xr = reinterpret_cast<const uint4*>(
          up1g + ((long long)b * R + r0 + tid) * C1);
#pragma unroll
      for (int k = 0; k < C1 / 8; ++k) {
        const uint4 u = xr[k];
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[8 * k + 2 * e] = __uint_as_float(w[e] << 16);
          x[8 * k + 2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
        }
      }
#pragma unroll 1
      for (int t = 0; t < 4; ++t) {
        float y[C2];
#pragma unroll
        for (int c = 0; c < C2; ++c) y[c] = 0.f;
        const float* wt = w_s + t * C1 * C2;
#pragma unroll
        for (int k = 0; k < C1; ++k) {
          const float xk = x[k];
          const float4* w4 = reinterpret_cast<const float4*>(wt + k * C2);
#pragma unroll
          for (int c4 = 0; c4 < C2 / 4; ++c4) {
            const float4 wv = w4[c4];
            y[4 * c4] = fmaf(xk, wv.x, y[4 * c4]);
            y[4 * c4 + 1] = fmaf(xk, wv.y, y[4 * c4 + 1]);
            y[4 * c4 + 2] = fmaf(xk, wv.z, y[4 * c4 + 2]);
            y[4 * c4 + 3] = fmaf(xk, wv.w, y[4 * c4 + 3]);
          }
        }
        const __nv_bfloat16* hr = hr_s + (t * THREADS + tid) * C2;
        float m[MAX_C] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int c = 0; c < C2; ++c) {
          float v = bf(bf(y[c]) + b_s[c]);
          v = gelu_bf16(bf(v + to_f(hr[c])));
#pragma unroll
          for (int j = 0; j < MAX_C; ++j)
            if (j < C) m[j] = fmaf(v, hy_s[j * C2 + c], m[j]);
        }
#pragma unroll
        for (int j = 0; j < MAX_C; ++j)
          if (j < C) o_s[(t * THREADS + tid) * C + j] = m[j];
      }
    }
    __syncthreads();
    // each tap's nr x C logits are one contiguous run of out
    for (int t = 0; t < 4; ++t) {
      float* dst = out + (((long long)b * 4 + t) * R + r0) * C;
      for (int i = tid; i < nr * C; i += THREADS)
        dst[i] = o_s[t * THREADS * C + i];
    }
  }
}

template <int C1, int C2>
cudaError_t launch(const void* up1g, const void* w2q, const void* b2,
                   const void* hr0q, const void* hyper, void* out, int B,
                   int R, int C, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (4 * C1 * C2 + C2 + MAX_C * C2 + 4 * THREADS * MAX_C) +
      sizeof(__nv_bfloat16) * 4 * THREADS * C2;
  cudaError_t err = cudaFuncSetAttribute(
      mask_tail_kernel<C1, C2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((R + THREADS - 1) / THREADS, (B + PB - 1) / PB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  mask_tail_kernel<C1, C2><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(up1g),
      static_cast<const __nv_bfloat16*>(w2q),
      static_cast<const __nv_bfloat16*>(b2),
      static_cast<const __nv_bfloat16*>(hr0q),
      static_cast<const __nv_bfloat16*>(hyper), static_cast<float*>(out), B,
      R, C);
  return cudaGetLastError();
}

}  // namespace

// up1g (B, R, c1), w2q (4, c1, c2), b2 (c2,), hr0q (4, R, c2), hyper (B, C,
// c2), all bf16 and contiguous, up1g 16-byte aligned; out (B, 4, R, C) f32.
// (c1, c2) must be (64, 32) (SAM2's d = 256); 1 <= C <= 4.
// Returns the cudaError_t of the launch.
extern "C" int ovo_mask_tail(const void* up1g, const void* w2q,
                             const void* b2, const void* hr0q,
                             const void* hyper, void* out, int B, int R,
                             int c1, int c2, int C, void* stream) {
  if (B < 1 || R < 1 || C < 1 || C > MAX_C ||
      reinterpret_cast<uintptr_t>(up1g) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c1 == 64 && c2 == 32)
    return (int)launch<64, 32>(up1g, w2q, b2, hr0q, hyper, out, B, R, C, s);
  return (int)cudaErrorInvalidValue;
}
