// Image -> token cross attention, the part that kernels B4
// (cross_i2t_tail.cu: attention, out-projection, keys residual, LayerNorm)
// and B7 (cross_i2t_proj.cu: the attention alone) share, and whose token
// softmax and p . v kernel B9b (cross_small_head.cu: attention on a
// pre-projected q) takes up too.
//
// What the shared part computes, for prompt b and image row l (keys[l] of
// width dk, the query side; Wq (dk, D); D = heads * dh), in the reference's
// types:
//   kq[h,t,c] = sum_j k_tok[t, h*dh+j] Wq[c, h*dh+j], rounded to the dtype;
//   s[h,t]    = (kq[h,t] . keys[l] + k_tok[t, h-block] . pe_q[l, h-block])
//               * scale in f32, tokens t >= t_len set to -1e30;
//   p[h,:]    = softmax over the tokens of head h in f32, normalized, then
//               rounded to the dtype;
//   attn[h*dh+j] = sum_t p[h,t] v_tok[t, h*dh+j] in f32 (each kernel
//               rounds it once).
//
// Pieces:
//  - the helpers and sizes of both kernels' f32 FMA paths;
//  - kq_kernel / launch_kq: kq for all (token, head) rows of a prompt, one
//    block per prompt, into a caller-allocated scratch (B, or 1, x heads *
//    NT x dk, rows t * heads + h) in the working dtype, from one head's
//    columns of Wq at a time staged in shared memory (f32 FMAs; kq does
//    not depend on the image row: a few MFLOP a prompt);
//  - bf16 on the tensor cores: i2t_stage_tokens fills a block's shared
//    memory with the prompt's kq (rows reordered to h * TP + t, TP = NT
//    rounded up to a power of two, so a head's tokens are whole quads or
//    whole n8 tiles of a score fragment) and the block-diagonal k_tok and
//    v_tok (row h * TP + t holds token t in head h's columns);
//    i2t_attn_tile takes one warp's 16 image rows, whose keys sit in its
//    shared buffer, through every product on mma.sync m16n8k16:
//     - S (16 x RP) = [keys | pe_q] . [kq | k_tok_bd]^T, K = dk + the pe_q
//       columns of each score tile's heads (pe_q's A fragments read
//       straight from device memory, where it stays in L2);
//     - i2t_softmax_pv, from the scores S: the softmax over each head's
//       tokens, a max and a sum over the lanes of a quad (XOR shuffles 1,
//       2), or over two n8 tiles when NT > 8; p normalized, rounded, and
//       reused from the C fragments as the A fragments of attn = p .
//       v_tok_bd over the heads' blocks;
//     - attn left in its f32 C fragments (16 x DPAD) for the kernel's own
//       epilogue.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

// the f32 FMA paths
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
  int NT, heads, t_len, L, dk, D;
  float scale;
  long long k_sb, t_sb, q_sb;
  int vs_k;           // copy width (vector_shift) of keys
};

// TP: tokens a head takes in the score columns (NT rounded up to a power of
// two, at least 2; columns h * TP + t); RP: score columns, heads * TP
// rounded up to 64 or 128. DKC, DC, HC: dk, D and heads fixed at compile
// time (0: read at run time). The SAM decoder's widths (256, 128, 8) get
// their own instantiation: with the shape known, the unrolled loops lose
// their run-time guards and the code shrinks by more than half, which
// more than halves B4's time at the AMG shape on an H100.
template <int DKC, int DC, int HC>
struct I2tWidths {
  int dk, D, heads, dh;
  __device__ __forceinline__ explicit I2tWidths(const I2tArgs& a)
      : dk(DKC ? DKC : a.dk), D(DC ? DC : a.D), heads(HC ? HC : a.heads),
        dh(D / heads) {}
};

// kq (rows reordered to h * TP + t; cp.async, committed by the caller) and
// the block-diagonal tokens of prompt b into shared memory (row strides
// LDK = dk + 8 and LDE = DPAD + 8)
template <int TP, int RP, int DKC, int DC, int HC>
__device__ __forceinline__ void i2t_stage_tokens(const I2tArgs& a, int b,
                                                 bf16* kq_s, bf16* kb_s,
                                                 bf16* vb_s) {
  const I2tWidths<DKC, DC, HC> w(a);
  const int dk = w.dk, D = w.D, heads = w.heads, dh = w.dh, NT = a.NT;
  const int LDK = dk + 8, LDE = DPAD + 8;
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16_rn(0.f);
  const bf16* kqb = a.kq + b * a.q_sb;
  const bf16* ktb = a.kt + b * a.t_sb;
  const bf16* vtb = a.vt + b * a.t_sb;
  for (int i = tid; i < RP * (dk / 8); i += blockDim.x) {
    const int r = i / (dk / 8), col = 8 * (i % (dk / 8));
    const int h = r / TP, t = r % TP;
    const bool ok = h < heads && t < NT;
    copy_async(kq_s + r * LDK + col,
               kqb + (ok ? (t * heads + h) * dk + col : 0), ok, 3);
  }
  for (int i = tid; i < RP * DPAD; i += blockDim.x) {
    const int r = i / DPAD, d = i % DPAD;
    const int h = r / TP, t = r % TP;
    const bool ok = h < heads && t < NT && d < D && d / dh == h;
    kb_s[r * LDE + d] = ok ? ktb[t * D + d] : zero;
    vb_s[r * LDE + d] = ok ? vtb[t * D + d] : zero;
  }
}

// The token softmax and attn = p . v_tok_bd of one warp's 16 image rows,
// from their scores S (16 x RP, f32 C fragments, before the scale; score
// column h * TP + t is token t of head h): s scaled, tokens t >= t_len at
// -1e30; p normalized, rounded, and reused as the A fragments of p .
// v_tok_bd; attn in f32 C fragments (at[n] holds columns 8n..8n+7).
template <int TP, int RP, int DC, int HC>
__device__ __forceinline__ void i2t_softmax_pv(const I2tArgs& a,
                                               float (&S)[RP / 8][4],
                                               const bf16* vb_s,
                                               float (&at)[DPAD / 8][4]) {
  constexpr int NS = RP / 8;       // n8 score tiles
  constexpr int ND = DPAD / 8;     // n8 attention tiles
  const I2tWidths<0, DC, HC> w(a);
  const int heads = w.heads, dh = w.dh;
  constexpr int LDE = DPAD + 8;
  const int lane = threadIdx.x & 31;
  const int c = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
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
}

// attn (16 x DPAD, f32 C fragments: at[n] holds columns 8n..8n+7) of image
// rows [l0, l0 + 16), whose keys sit in ks_w (row stride dk + 8)
template <int TP, int RP, int DKC, int DC, int HC>
__device__ __forceinline__ void i2t_attn_tile(
    const I2tArgs& a, const bf16* ks_w, const bf16* kq_s, const bf16* kb_s,
    const bf16* vb_s, int l0, float (&at)[DPAD / 8][4]) {
  constexpr int NS = RP / 8;       // n8 score tiles
  const I2tWidths<DKC, DC, HC> w(a);
  const int dk = w.dk, D = w.D, heads = w.heads, dh = w.dh;
  const int LDK = dk + 8, LDE = DPAD + 8;  // odd 16-byte units
  const int nkd = (D + 15) / 16;  // k16 chunks of D
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

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
  i2t_softmax_pv<TP, RP, DC, HC>(a, S, vb_s, at);
}

// TP of NT tokens: NT rounded up to a power of two, at least 2
inline int i2t_tp(int NT) {
  return NT <= 2 ? 2 : NT <= 4 ? 4 : NT <= 8 ? 8 : 16;
}

// the shared fields of a bf16 launch's arguments, from its entry point's
// (kq's rows are shared when the tokens are, t_sb 0)
inline void fill_i2t_args(I2tArgs& a, const void* keys, const void* kq,
                          const void* peq, const void* kt, const void* vt,
                          int NT, int heads, int t_len, int L, int dk, int D,
                          float scale, long long k_sb, long long t_sb) {
  a.keys = static_cast<const bf16*>(keys);
  a.kq = static_cast<const bf16*>(kq);
  a.peq = static_cast<const bf16*>(peq);
  a.kt = static_cast<const bf16*>(kt);
  a.vt = static_cast<const bf16*>(vt);
  a.NT = NT;
  a.heads = heads;
  a.t_len = t_len;
  a.L = L;
  a.dk = dk;
  a.D = D;
  a.scale = scale;
  a.k_sb = k_sb;
  a.t_sb = t_sb;
  a.q_sb = t_sb ? (long long)heads * NT * dk : 0;
  const long long sk[2] = {dk, k_sb};
  a.vs_k = vector_shift(&keys, 1, sk, 2, dk);
}

// The instantiation of a kernel's launch for a's widths:
// Launch<TP, RP, DKC, DC, HC>::run(a, B, stream), with TP from NT, RP 128
// where heads * TP passes 64, and the SAM decoder's widths (8 tokens,
// dk 256, D 128, 8 heads) fixed at compile time.
template <template <int, int, int, int, int> class Launch, class Args>
cudaError_t launch_i2t(const Args& a, int B, cudaStream_t stream) {
  const int TP = i2t_tp(a.NT);
  const bool wide = a.heads * TP > 64;
  if (TP == 8 && a.dk == 256 && a.D == 128 && a.heads == 8)
    return Launch<8, 64, 256, 128, 8>::run(a, B, stream);
  switch (TP) {
    case 2: return wide ? Launch<2, 128, 0, 0, 0>::run(a, B, stream)
                        : Launch<2, 64, 0, 0, 0>::run(a, B, stream);
    case 4: return wide ? Launch<4, 128, 0, 0, 0>::run(a, B, stream)
                        : Launch<4, 64, 0, 0, 0>::run(a, B, stream);
    case 8: return wide ? Launch<8, 128, 0, 0, 0>::run(a, B, stream)
                        : Launch<8, 64, 0, 0, 0>::run(a, B, stream);
    default: return wide ? Launch<16, 128, 0, 0, 0>::run(a, B, stream)
                         : Launch<16, 64, 0, 0, 0>::run(a, B, stream);
  }
}

}  // namespace
