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
// What bounds it on an H100: the gelu chain's instructions, not the bytes.
// At the AMG shape (128 prompts after the gate, H = W = 64, C1 = 64, C2 =
// 32, C = 3) a launch reads up1g (268 MB) and hr0q (4 MB) and writes 101 MB
// of f32 logits: 0.111 ms at 3.35 TB/s; its 36 GFLOP of products are 0.036
// ms at the bf16 tensor rate. But the 268M gelu outputs each take the exact
// chain of 12 bf16-rounded ops and a tanhf on the CUDA cores: 22
// instructions an element on bf16 pairs, two of them MUFU, which the card
// issues in 0.176 ms, more slowly than it moves the bytes
// (chip_smoke.B13_CHAIN_OPS).
//
// Design: a block of eight warps takes 128 consecutive rows (16 a warp)
// and up to PB prompts. w2q sits in shared memory once a block; each warp
// holds its rows' hr0q and b2 in registers for all its prompts (the skip is
// shared across prompts, as the TPU grid's (hband, prompt) order kept it
// resident). Per prompt, the warp's 16 up1g rows arrive by cp.async in one
// of two buffers while the previous prompt computes; then, per tap:
//  - y (16 x 32) = up1g rows . w2q[t] on mma.sync m16n8k16 (A by ldmatrix,
//    B by ldmatrix.trans), one chain over C1 = 64 from zero (the mma sums
//    without rounding to nearest: tests/test_torch_mask_tail_share.py
//    models that chain and shows it stays 10x under B13_SHARE);
//  - the epilogue in registers on bf16 pairs: the C fragment's two columns
//    rounded into one bf16x2, then + b2, + hr0q and the gelu's products and
//    sums as bf16x2 mul.rn / add.rn (a product of two bf16 values is exact
//    in f32 and a sum of two rounds once, so each op rounds as f32-then-bf16
//    does; no fused multiply-add, which would round once where the
//    reference rounds twice), tanh on f32 with tanhf (tanh.approx flips a
//    share of the bf16 roundings);
//  - the gelu output pairs are, register for register, the A fragments of
//    the hypernetwork dot g . hyper^T (K = 32, N = 8 with C <= 4, the other
//    columns zero) on two more mma steps, summed in f32;
//  - the logits stored from the C fragments, the warp's 16 x C floats of a
//    tap one contiguous run of out.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int C1 = 64;        // up1g channels (SAM2's d = 256 decoder)
constexpr int C2 = 32;        // second upscale's channels
constexpr int WARPS = 8;      // warps a block, 16 rows each
constexpr int ROWS = 16 * WARPS;
constexpr int PB = 8;         // prompts a block
constexpr int MAX_C = 4;      // hypernet channels
constexpr int LDX = C1 + 8;   // up1g rows in shared memory: odd 16-byte units
constexpr int LDW = C2 + 8;   // w2q rows: odd 16-byte units
// jax.nn.gelu's constants 0.044715 and sqrt(2 / pi) as bf16 (0.044677734375
// and 0.796875), and 0.5 and 1, each twice in a bf16x2 register
constexpr uint32_t GELU_A2 = 0x3d373d37u;
constexpr uint32_t GELU_S2 = 0x3f4c3f4cu;
constexpr uint32_t HALF2 = 0x3f003f00u;
constexpr uint32_t ONE2 = 0x3f803f80u;

// two bf16 products / sums at once, each rounded to nearest once
__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// jax.nn.gelu(x, approximate=True) on a bf16 pair, every op rounded to bf16
// in JAX's order
__device__ __forceinline__ uint32_t gelu2(uint32_t x) {
  const uint32_t x3 = mul2(x, mul2(x, x));
  const uint32_t u = mul2(GELU_S2, add2(x, mul2(GELU_A2, x3)));
  const uint32_t th = pack_bf16(tanhf(__uint_as_float(u << 16)),
                                tanhf(__uint_as_float(u & 0xffff0000u)));
  return mul2(x, mul2(HALF2, add2(ONE2, th)));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__global__ void __launch_bounds__(32 * WARPS, 2)
mask_tail_kernel(const bf16* __restrict__ up1g, const bf16* __restrict__ w2q,
                 const bf16* __restrict__ b2, const bf16* __restrict__ hr0q,
                 const bf16* __restrict__ hyper, float* __restrict__ out,
                 int B, int R, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* w_s = reinterpret_cast<bf16*>(smem_raw);  // 4 x C1 x LDW: 20 KB
  bf16* x_s = w_s + 4 * C1 * LDW;  // WARPS x 2 x 16 x LDX: up1g, 36 KB

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int r0 = blockIdx.x * ROWS + 16 * warp;
  const int b0 = blockIdx.y * PB, nb = min(PB, B - b0);
  bf16* buf = x_s + warp * 2 * 16 * LDX;

  // the first prompt's rows start loading before the weights are staged
  if (r0 < R)
    load_rows(buf, LDX, up1g + (size_t)b0 * R * C1, C1, r0, 16, R, C1, 3,
              lane, 32);
  cp_async_commit();
  for (int i = tid; i < 4 * C1 * C2 / 2; i += 32 * WARPS) {
    const int row = 2 * i / C2, col = 2 * i - row * C2;
    *reinterpret_cast<uint32_t*>(w_s + row * LDW + col) = ld32(w2q + 2 * i);
  }
  __syncthreads();
  if (r0 >= R) return;

  // per lane: b2 and hr0q at its C fragment's places (columns 8n + 2c and
  // 8n + 2c + 1 of rows g and g + 8), as bf16 pairs
  uint32_t b2v[4], hr[4][4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    b2v[n] = ld32(b2 + 8 * n + 2 * c);
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = r0 + g + 8 * hh;
        hr[t][n][hh] = row < R ? ld32(hr0q + ((size_t)t * R + row) * C2 +
                                      8 * n + 2 * c)
                               : 0u;
      }
  }

  for (int p = 0; p < nb; ++p) {
    const int b = b0 + p;
    const bf16* cur = buf + (p & 1) * 16 * LDX;
    if (p + 1 < nb)
      load_rows(buf + ((p + 1) & 1) * 16 * LDX, LDX,
                up1g + (size_t)(b + 1) * R * C1, C1, r0, 16, R, C1, 3, lane,
                32);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    uint32_t xa[C1 / 16][4];
#pragma unroll
    for (int kc = 0; kc < C1 / 16; ++kc)
      ldmatrix_x4(xa[kc], cur + a_row * LDX + 16 * kc + a_col);
    // hyper[b]^T as the B fragments of the hypernet dot: column n = g is
    // channel g, zero past C
    uint32_t hb[C2 / 16][2];
#pragma unroll
    for (int kc = 0; kc < C2 / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        hb[kc][j] = g < C ? ld32(hyper + ((size_t)b * C + g) * C2 + 16 * kc +
                                 8 * j + 2 * c)
                          : 0u;

#pragma unroll
    for (int t = 0; t < 4; ++t) {
      // y (16 x C2) = up1g rows . w2q[t]
      float y[C2 / 8][4];
#pragma unroll
      for (int n = 0; n < C2 / 8; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < C1 / 16; ++kc) {
        const bf16* wrow = w_s + (t * C1 + 16 * kc + a_row) * LDW;
#pragma unroll
        for (int np = 0; np < C2 / 16; ++np) {
          uint32_t wf[4];
          ldmatrix_x4_trans(wf, wrow + 16 * np + a_col);
          mma_bf16(y[2 * np], xa[kc], wf[0], wf[1]);
          mma_bf16(y[2 * np + 1], xa[kc], wf[2], wf[3]);
        }
      }
      // bf16(y) + b2 + hr0q, the gelu: the A fragments of g . hyper^T
      uint32_t ga[C2 / 16][4];
#pragma unroll
      for (int n = 0; n < C2 / 8; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t yb = pack_bf16(y[n][2 * hh], y[n][2 * hh + 1]);
          ga[n >> 1][hh + 2 * (n & 1)] =
              gelu2(add2(add2(yb, b2v[n]), hr[t][n][hh]));
        }
      float m[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kc = 0; kc < C2 / 16; ++kc)
        mma_bf16(m, ga[kc], hb[kc][0], hb[kc][1]);
      // logits (rows g, g + 8; channels 2c, 2c + 1)
      float* ot = out + (((size_t)b * 4 + t) * R + r0) * C;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (r0 + g + 8 * hh >= R) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * c + e < C) ot[(g + 8 * hh) * C + 2 * c + e] = m[2 * hh + e];
      }
    }
    __syncwarp();  // cur is refilled next
  }
}

}  // namespace

// up1g (B, R, c1), w2q (4, c1, c2), b2 (c2,), hr0q (4, R, c2), hyper (B, C,
// c2), all bf16 and contiguous, up1g 16-byte aligned and the others 4-byte;
// out (B, 4, R, C) f32. (c1, c2) must be (64, 32) (SAM2's d = 256); 1 <= C
// <= 4. Returns the cudaError_t of the launch.
extern "C" int ovo_mask_tail(const void* up1g, const void* w2q,
                             const void* b2, const void* hr0q,
                             const void* hyper, void* out, int B, int R,
                             int c1, int c2, int C, void* stream) {
  if (B < 1 || R < 1 || C < 1 || C > MAX_C || c1 != C1 || c2 != C2 ||
      reinterpret_cast<uintptr_t>(up1g) % 16 ||
      (reinterpret_cast<uintptr_t>(w2q) | reinterpret_cast<uintptr_t>(b2) |
       reinterpret_cast<uintptr_t>(hr0q) |
       reinterpret_cast<uintptr_t>(hyper)) % 4)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + ROWS - 1) / ROWS, (B + PB - 1) / PB);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int smem = sizeof(bf16) * (4 * C1 * LDW + WARPS * 2 * 16 * LDX);
  cudaError_t err = cudaFuncSetAttribute(
      mask_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  mask_tail_kernel<<<grid, 32 * WARPS, smem, s>>>(
      static_cast<const bf16*>(up1g), static_cast<const bf16*>(w2q),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(hr0q),
      static_cast<const bf16*>(hyper), static_cast<float*>(out), B, R, C);
  return (int)cudaGetLastError();
}
