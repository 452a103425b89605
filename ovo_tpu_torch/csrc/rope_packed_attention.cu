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
// kv_len 577, D = 1024, 16 heads of 64, bf16) one launch needs ~9.7 GFLOP
// and moves ~33 MB, so HBM (3.35 TB/s) bounds it at ~10 us and the tensor
// cores (989 TF/s) at ~10 us too. The reference rounds the NORMALIZED
// weight to the dtype, so a row's max and sum must be known before any
// weight is formed: two passes over the keys, q . k computed twice.
//
// bf16 design (tensor cores; B11's two-pass mma.sync layout, with RoPE and
// kv_len added), two launches:
// 1. rope_rotate_kernel rotates q and k once per token into a (2, B, L, D)
//    workspace: a thread owns the pair (d, d + hd/2) of one head of one
//    row with the row's bf16 cos and sin, and rounds each product and each
//    sum to bf16 in layers.apply_rope's op order, so the rotated values are
//    exactly the reference's and exact mma operands (~17 MB written and
//    read back, mostly from the 50 MB L2).
// 2. two_pass_mma_kernel (two_pass_attention.cuh, shared with B12a): one
//    block of eight warps per (view * head, 128-query tile); each warp owns
//    16 query rows, whose q fragments it keeps in registers. 64-key chunks
//    of the rotated k, and in pass 2 of v (read in place from the packed
//    projection, row stride 3D), stream through shared memory,
//    double-buffered with 16-byte cp.async copies. Pass 1 computes q . k on
//    mma.sync m16n8k16 (f32 accumulators, then times scale) and each lane's
//    running max and sum; pass 2 computes q . k again and p . v with p =
//    bf16(exp(s - m) / l), the reference's rounding point. Keys at or past
//    kv_len are zero rows at -1e30; chunk rows past kv_len round up to 16,
//    so at the PE shape the last chunk is one 16-row step with one valid
//    key. The head size is a template argument (every multiple of 16 up to
//    128), so the unrolled loops carry no run-time guards.
// Throwaway probes on an H100 (not kept) chose this over two alternatives
// the first bf16 version had: rotating each 64-key chunk in shared memory
// inside the attention kernel took a large share of its time (a latency-bound
// loop of cos / sin loads and bf16 roundings per block and chunk), and
// keeping a head's rotated keys resident in shared memory for pass 2 (85 KB
// at the PE shape) ran slower than streaming them twice, with or without
// the rotation (fewer blocks an SM). Eight warps a block ran faster than
// four. At the PE shape the 560 blocks fill the 132 SMs (two blocks an SM)
// 2.1 times. The first design (f32 FMAs on the CUDA cores, weights
// unrounded) took 0.626 ms at the PE shape, its rounding repair (two FMA
// passes) 0.999 ms.
//
// float32 keeps that FMA design (the tests' and f32 towers' route): one
// block of 256 threads per (view*head, 64-query tile). The q tile is
// rotated once into shared memory (f32, padded rows: no bank conflicts).
// 64-key tiles stream through shared memory twice: pass 1 recomputes the
// scores of each tile and keeps only each row's running max and sum; pass 2
// recomputes them again, forms the normalized weights and accumulates
// p . v. Each thread owns a 4x4 micro-tile of the 64x64 score tile (rows
// 4*(tid/16)+i, keys tid%16 + 16*j) and 4 rows x hd/16 columns of the
// output; row max and sum reduce over the 16 lanes of a half-warp with
// shuffles. Tiles wholly beyond kv_len are skipped in both passes: their
// keys would get exp(-1e30 - m) = 0 exactly. kv_len >= 1 keeps every row's
// max finite.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "two_pass_attention.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int LDP = BK + 4;
constexpr int THREADS = 256;

// element d of the rotate-half RoPE of one head row (hd values at x), in
// layers.apply_rope's op order
__device__ __forceinline__ float rope_elem(const float* __restrict__ x, int d,
                                           int h2, const float* __restrict__ cs,
                                           const float* __restrict__ sn) {
  if (d < h2) return __fsub_rn(__fmul_rn(x[d], cs[d]),
                               __fmul_rn(x[d + h2], sn[d]));
  const int e = d - h2;
  return __fadd_rn(__fmul_rn(x[e], sn[e]), __fmul_rn(x[d], cs[e]));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
rope_attn_kernel(const float* __restrict__ qkv,
                 const float* __restrict__ cos_t,
                 const float* __restrict__ sin_t, float* __restrict__ out,
                 int L, int D, int heads, int kv_len, float scale) {
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
  const float* base = qkv + (size_t)b * L * rs;
  const int qc = h * HD, kc = D + h * HD, vc = 2 * D + h * HD;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;  // rows 4*rg .. 4*rg+3
  const int cl = tid & 15;  // key / column lane

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, d = i % HD, t = q0 + r;
    float val = 0.f;
    if (t < L)
      val = rope_elem(base + t * rs + qc, d, H2, cos_t + (size_t)t * H2,
                         sin_t + (size_t)t * H2);
    q_s[r * LD + d] = val;
  }

  // k (rotated) and, in pass 2, v of one 64-key tile -> shared memory
  auto load_tile = [&](int k0, bool with_v) {
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, t = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < L) {
        kv = rope_elem(base + t * rs + kc, d, H2, cos_t + (size_t)t * H2,
                          sin_t + (size_t)t * H2);
        if (with_v) vv = base[t * rs + vc + d];
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

  // pass 2: the normalized weights times v
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
            expf(s[i][j] - m_i[i]) / l_i[i];
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
    float* o = out + ((size_t)b * L + row) * D + h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[cl + 16 * c] = acc[i][c];
  }
}

template <int HD>
cudaError_t launch(const void* qkv, const float* cos_t, const float* sin_t,
                   void* out, int B, int L, int D, int heads, int kv_len,
                   float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * LDP);
  cudaError_t err = cudaFuncSetAttribute(
      rope_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, B * heads);
  rope_attn_kernel<HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(qkv), cos_t, sin_t, static_cast<float*>(out),
      L, D, heads, kv_len, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// rotate-half RoPE of q and k, once per token: qkv (B, L, 3D) -> rot (2, B,
// L, D), q then k. A block per row (section, b, t); a thread a pair (d,
// d + hd/2) of one head. Every product and sum rounds to bf16 in
// layers.apply_rope's op order.
template <int HD>
__global__ void __launch_bounds__(256)
rope_rotate_kernel(const bf16* __restrict__ qkv,
                   const float* __restrict__ cos_t,
                   const float* __restrict__ sin_t, bf16* __restrict__ rot,
                   int BL, int L, int D) {
  constexpr int H2 = HD / 2;
  const int row = blockIdx.x;  // sec * B * L + b * L + t
  const int sec = row >= BL, t = (row - sec * BL) % L;
  const bf16* x = qkv + (long long)(row - sec * BL) * 3 * D + sec * D;
  bf16* y = rot + (long long)row * D;
  const float* cr = cos_t + t * H2;
  const float* sr = sin_t + t * H2;
  for (int p = threadIdx.x; p < D / 2; p += blockDim.x) {
    const int d = p % H2, col = p / H2 * HD + d;
    const float c = bf16_round(cr[d]), s = bf16_round(sr[d]);
    const float x1 = __bfloat162float(x[col]);
    const float x2 = __bfloat162float(x[col + H2]);
    const float a = bf16_round(__fmul_rn(x1, c));
    const float b = bf16_round(__fmul_rn(x2, s));
    const float e = bf16_round(__fmul_rn(x1, s));
    const float f = bf16_round(__fmul_rn(x2, c));
    y[col] = __float2bfloat16_rn(__fsub_rn(a, b));
    y[col + H2] = __float2bfloat16_rn(__fadd_rn(e, f));
  }
}

// rot: a (2, B, L, D) bf16 workspace for the rotated q and k
template <int HD>
cudaError_t launch_mma(const void* qkv, const float* cos_t, const float* sin_t,
                       void* rot, void* out, int B, int L, int D, int heads,
                       int kv_len, float scale, cudaStream_t stream) {
  const int threads = D / 2 < 256 ? (D / 2 + 31) / 32 * 32 : 256;
  rope_rotate_kernel<HD><<<2 * B * L, threads, 0, stream>>>(
      static_cast<const bf16*>(qkv), cos_t, sin_t, static_cast<bf16*>(rot),
      B * L, L, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bf16* r = static_cast<const bf16*>(rot);
  return launch_two_pass<HD>(r, r + (long long)B * L * D,
                             static_cast<const bf16*>(qkv) + 2 * D, D,
                             3LL * D, static_cast<bf16*>(out), B, L, D, heads,
                             kv_len, scale, stream);
}

// dtype 0 = float32 (FMA design), 1 = bfloat16 (tensor cores)
cudaError_t dispatch(int hd, const void* qkv, const float* c, const float* s,
                     void* rot, void* out, int B, int L, int D, int heads,
                     int kv_len, float scale, int dtype, cudaStream_t st) {
#define OVO_ROPE_HD(N)                                                      \
  case N:                                                                   \
    return dtype == 0                                                       \
        ? launch<N>(qkv, c, s, out, B, L, D, heads, kv_len, scale,          \
                           st)                                              \
        : launch_mma<N>(qkv, c, s, rot, out, B, L, D, heads, kv_len, scale, \
                        st);
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (hd) {
    OVO_ROPE_HD(16) OVO_ROPE_HD(32) OVO_ROPE_HD(48) OVO_ROPE_HD(64)
    OVO_ROPE_HD(80) OVO_ROPE_HD(96) OVO_ROPE_HD(112) OVO_ROPE_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef OVO_ROPE_HD
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; rot (bf16 only, else unused): a
// workspace of 2 * B * L * D bf16 values for the rotated q and k. Returns
// the cudaError_t of the launches.
extern "C" int ovo_rope_packed_attention(const void* qkv, const void* cos_t,
                                         const void* sin_t, void* rot,
                                         void* out, int B, int L, int D,
                                         int heads, int kv_len, float scale,
                                         int dtype, void* stream) {
  if (heads <= 0 || D % heads != 0 || kv_len < 1 || kv_len > L)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch(D / heads, qkv, static_cast<const float*>(cos_t),
                       static_cast<const float*>(sin_t), rot, out, B, L, D,
                       heads, kv_len, scale, dtype,
                       static_cast<cudaStream_t>(stream));
}
