// Whole-KV self-attention with the score rows kept on chip.
//
// Replaces: ovo_tpu/ops/attention.py fused_attention / _fused_kernel (the
// Pallas TPU kernel the CLIP / SigLIP image towers run through: L = 729 and
// hd = 72 for SigLIP-384, at batch 1 for the global view and 96 for the
// per-mask crops).
//
// What it computes, per (batch b, head h), exactly as _fused_kernel does:
//   s   = (q . k) in f32, then * scale (after the dot), keys >= kv_len set to
//         -1e30;
//   p   = exp(s - max s) / sum exp(s - max s) in f32, then rounded to the
//         working dtype (the reference casts p to v's dtype before p.v);
//   out = p . v accumulated in f32, rounded once to q's dtype.
//
// What bounds it on an H100: at (96, 16, 729, 72) one launch needs
// 4 B H L^2 hd = 235 GFLOP and moves 4 x 322 MB (f32). In f32 the products
// run on the CUDA cores (67 TF/s peak): ~3.5 ms of arithmetic against
// ~0.4 ms of memory, so it is FLOP-bound; in bf16 the tensor cores would
// bound it near 0.24 ms. This first version does every product with f32
// FMAs fed from shared memory, so FMA throughput and shared-memory bandwidth
// bound it well above either floor; mma.sync / wgmma tiles are later work.
//
// Design: one block of 256 threads (8 warps) per (b*h, 32-query tile), the
// shape of the TPU kernel: the block's 32 x Lk f32 score rows stay in
// shared memory (<= 128 KB at Lk = 1024), so the exact row max and sum are
// taken once and p is rounded after normalization, as the reference does.
//   pass 1: 128-key tiles of k stream through shared memory; warp w owns
//           query rows 4w..4w+3 and lane j keys j + 32c of the tile, a 4 x 4
//           register micro-tile; the scaled score lands in the row buffer;
//   pass 2: each warp normalizes its own four rows (max and sum reduced
//           with shuffles), writing the rounded p in place;
//   pass 3: 128-key tiles of v stream through shared memory; warp w
//           accumulates its four rows, lane j columns j + 32c.
// Rows never cross warps, so passes 1-3 need block barriers only around the
// k / v tiles. The head size is taken natively (hd = 72): the v tile is
// zero-padded to 32 * NC columns and only columns < hd are written. Tiles
// wholly past kv_len are skipped: the reference gives their keys
// exp(-1e30 - m) = 0. Any (b, h, l) strides with a unit last stride are
// taken, so head-split views of a packed projection need no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 32;        // query rows per block
constexpr int BK = 128;       // keys per k / v tile
constexpr int THREADS = 256;  // 8 warps x 4 rows
constexpr int MAX_LK = 1024;

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

// shared memory: q tile BQ x LD | score rows BQ x LS | one k or v tile
__host__ __device__ __forceinline__ int score_ld(int Lk) {
  return (Lk + BK - 1) / BK * BK;
}

template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
fused_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int H, int Lq,
             int Lk, int hd, int kv_len, float scale, Strides st) {
  constexpr int LDV = 32 * NC;
  const int LD = hd + 1;  // odd row length: lanes on distinct banks
  const int LS = score_ld(Lk);
  extern __shared__ float smem[];
  float* q_s = smem;            // BQ x LD
  float* s_s = q_s + BQ * LD;   // BQ x LS
  float* t_s = s_s + BQ * LS;   // BK x LD (k) or BK x LDV (v)

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + b * st.qb + h * st.qh;
  const T* kb = k + b * st.kb + h * st.kh;
  const T* vb = v + b * st.vb + h * st.vh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = 4 * warp;  // this warp's rows r0 .. r0 + 3
  const int n_tiles = (kv_len + BK - 1) / BK;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd, t = q0 + r;
    q_s[r * LD + d] = t < Lq ? to_f<T>(qb[t * st.ql + d]) : 0.f;
  }

  // pass 1: scaled scores of every key tile into the row buffer
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // previous tile consumed (and the q tile written)
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, d = i % hd, t = k0 + r;
      t_s[r * LD + d] = t < Lk ? to_f<T>(kb[t * st.kl + d]) : 0.f;
    }
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      float qa[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = q_s[(r0 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = t_s[(lane + 32 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + lane + 32 * j;
        s_s[(r0 + i) * LS + key] = key < kv_len ? s[i][j] * scale : -1e30f;
      }
  }
  __syncwarp();

  // pass 2: exact row max and sum, then the normalized p rounded to the
  // dtype, in place; keys of the last tile past kv_len get p = 0
  const int kv_pad = n_tiles * BK;
  for (int i = 0; i < 4; ++i) {
    float* row = s_s + (r0 + i) * LS;
    float mx = -INFINITY;
    for (int j = lane; j < kv_len; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kv_len; j += 32) sum += expf(row[j] - mx);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int j = lane; j < kv_pad; j += 32)
      row[j] = j < kv_len ? rnd<T>(expf(row[j] - mx) / sum) : 0.f;
  }

  // pass 3: p . v over the value tiles
  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // k tile (or previous v tile) consumed
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV, d = i % LDV, t = k0 + r;
      t_s[i] = (t < Lk && d < hd) ? to_f<T>(vb[t * st.vl + d]) : 0.f;
    }
    __syncthreads();
    const float* p0 = s_s + r0 * LS + k0;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = p0[i * LS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = t_s[kk * LDV + lane + 32 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pa[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + r0 + i;
    if (row >= Lq) continue;
    T* o = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) o[col] = from_f<T>(acc[i][c]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int Lk, int hd, int kv_len,
                   float scale, const Strides& st, cudaStream_t stream) {
  const int ld = hd + 1;
  const int tile = BK * (ld > 32 * NC ? ld : 32 * NC);
  const size_t smem =
      sizeof(float) * ((size_t)BQ * ld + (size_t)BQ * score_ld(Lk) + tile);
  cudaError_t err = cudaFuncSetAttribute(
      fused_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  fused_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Lq, Lk, hd, kv_len,
      scale, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Lq, int Lk, int hd, int kv_len,
                     float scale, const Strides& st, cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch<T, 1>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 2: return launch<T, 2>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 3: return launch<T, 3>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    case 4: return launch<T, 4>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 int64 values, (batch, head, row) strides of q, k, v and out in
// elements; the last dimension of each is contiguous. Lk <= 1024, hd <= 128,
// B * H <= 65535. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t
// of the launch.
extern "C" int ovo_fused_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Lq, int Lk,
                                   int hd, int kv_len, float scale, int dtype,
                                   const long long* strides, void* stream) {
  if (B < 1 || H < 1 || B * H > 65535 || Lq < 1 || Lk > MAX_LK || hd < 1 ||
      hd > 128 || kv_len < 1 || kv_len > Lk)
    return (int)cudaErrorInvalidValue;
  const long long* a = strides;
  const Strides st = {a[0], a[1], a[2], a[3], a[4],  a[5],
                      a[6], a[7], a[8], a[9], a[10], a[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, H, Lq, Lk, hd, kv_len, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
