// Whole-KV self-attention of the CLIP / SigLIP image towers.
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
// 4 B H L^2 hd = 235 GFLOP and moves 4 x 322 MB (f32): operations, not
// bytes. On the CUDA cores (67 TF/s f32 FMA) that is 3.5 ms; the tensor
// cores take f32 only as TF32 (10-bit mantissa, 495 TF/s dense), so an f32
// product there costs three TF32 products (below): 3 x 235 GFLOP = 1.43 ms.
// In bf16 the tensor cores bound it near 0.24 ms.
//
// float32 design (f32_mma_kernel): both products on mma.sync m16n8k8 TF32
// with f32 accumulation, each as three products, a_hi b_hi + a_hi b_lo +
// a_lo b_hi with x_hi = tf32(x) and x_lo = tf32(x - x_hi) (CUTLASS's
// 3xTF32): the dropped a_lo b_lo term is ~2^-22 of a product, so the result
// is f32's up to summation order. One TF32 product alone would round q, k,
// p and v to 10 bits, another function (chip_smoke.fused_attention_tf32_once
// is held apart from this one by B10_F32_TOL). In f32 the reference's
// rounding of p is a no-op, so one pass with an online softmax (running row
// max and sum, the output divided by the sum at the end) computes the same
// function up to f32 summation order; the first design instead kept every
// score of a 32-row tile in shared memory (up to 128 KB, one block an SM)
// and did its products with FMAs, 33.4 ms a launch.
//  - A block of four warps takes 64 query rows of one (b, h); a warp owns 16
//    rows. Its q fragments are split once into hi / lo in registers (zero
//    past Lq and past hd).
//  - Keys stream in chunks of 32 through shared memory: cp.async (16 bytes
//    where the pointers and strides allow, else 4) into a raw k / v buffer,
//    rows at or past kv_len zero-filled; once landed, the block splits the
//    chunk into hi and lo buffers (each value split once per block, not per
//    warp) and issues the next chunk's copies into the raw buffer, which
//    overlap the chunk's products. Chunks wholly past kv_len are never
//    loaded (their keys get exp(-1e30 - m) = 0 in the reference).
//  - p stays in registers. The score C fragment of an 8-key n-tile holds
//    columns (2c, 2c + 1) of rows g and g + 8; the A fragment of m16n8k8
//    wants columns (c, c + 4). So inside each 8-key step A's column c takes
//    key 2c and column c + 4 key 2c + 1, and the B fragments of v read rows
//    2c and 2c + 1 in the same order (32-bit loads from shared memory).
//  - Each chunk's p . v is summed on the tensor cores from zero (12
//    products a tile), then joins the rescaled output in one f32 FMA: the
//    mma's accumulation is not rounded to nearest, and carried over a whole
//    row (276 accumulations at L 729) it moved outputs by up to 9.3e-6 at
//    the crops' batch (an H100 run of the first tensor-core version).
//  - Shared rows are padded to HDP + 4 floats (HDP = hd rounded up to the
//    instantiated width): the 8 x 4 lanes of a fragment load hit 32 distinct
//    banks for both the k (row g, column c) and the v (row 2c, column g)
//    reads. Columns [hd, HDP) are zero, so a padded width computes the same
//    function.
//  - Widths are fixed at compile time (64, 72, 80 and 128; any hd up to
//    128 takes the smallest that holds it): run-time bounds in the unrolled
//    loops would double the instructions (PR 8's finding on B3).
//
// bfloat16 design: B10's bf16 function is B2's (p rounded to bf16 after it
// is normalized, so the row's max and sum come before any weight: two
// passes), and B2's tensor-core device code takes any kv_len, so the bf16
// launch is B2's win_mma_kernel (window_attention.cuh; head sizes of
// WINDOWED_HEAD_DIMS, the wrapper pads others with zero columns).
//
// Any (b, h, l) strides with a unit last stride are taken, so head-split
// views of a packed projection need no copy.
#include "window_attention.cuh"

namespace tf32x3 {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int KC = 32;          // keys per chunk
constexpr int MAX_LK = 1024;

// x rounded to TF32 (10-bit mantissa, to nearest, ties away from zero:
// cvt.rna's rounding), the low 13 bits zero
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to ~2^-22 relative, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// d += a (16 x 8, row-major) * b (8 x 8), TF32 in, f32 accumulate.
// Fragments (g = lane / 4, c = lane % 4): a0 = (g, c), a1 = (g + 8, c),
// a2 = (g, c + 4), a3 = (g + 8, c + 4); b0 = (k c, n g), b1 = (k c + 4,
// n g); d0, d1 = (g, 2c..2c + 1), d2, d3 = (g + 8, 2c..2c + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += (a_hi + a_lo) * (b_hi + b_lo), less the a_lo b_lo term; the small
// products first
__device__ __forceinline__ void mma_3x(float (&d)[4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], uint32_t bh0,
                                       uint32_t bh1, uint32_t bl0,
                                       uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t bits(float x) { return __float_as_uint(x); }

// 16 bytes (vec) or 4 from device memory to shared memory, or zeros there
// when !ok (src is then not read)
__device__ __forceinline__ void copy_f32(float* dst, const float* src, bool ok,
                                         bool vec) {
  const uint32_t d = smem_addr(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// keys [c0, c0 + KC) of one (b, h) -> shared rows of LD floats, columns
// [0, hd); keys at or past kv_len zero-filled
template <int LD>
__device__ __forceinline__ void load_chunk(float* dst, const float* src,
                                           long long sl, int c0, int kv_len,
                                           int hd, bool vec) {
  const int w = vec ? 4 : 1;
  const int per_row = hd / w;
  for (int i = threadIdx.x; i < KC * per_row; i += THREADS) {
    const int r = i / per_row;
    const int col = (i - r * per_row) * w;
    const bool ok = c0 + r < kv_len;
    copy_f32(dst + r * LD + col, src + (ok ? c0 + r : 0) * sl + col, ok, vec);
  }
}

template <int HDP>
__global__ void __launch_bounds__(THREADS, HDP <= 80 ? 3 : 1)
f32_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out, int H,
               int Lq, int hd, int kv_len, float scale, Strides st,
               bool vec) {
  constexpr int KT = HDP / 8;  // k-steps of q . k = n-tiles of p . v
  constexpr int LD = HDP + 4;
  constexpr int TILE = KC * LD;
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;             // k | v as loaded
  float* hi = raw + 2 * TILE;    // k | v, TF32 hi parts
  float* lo = hi + 2 * TILE;     // k | v, TF32 lo parts

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int row0 = blockIdx.x * BQ + 16 * warp;
  const bool rows_here = row0 < Lq;
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + h * st.kh;
  const float* vb = v + b * st.vb + h * st.vh;

  // columns [hd, HDP) of the raw k and v rows are never copied: zero
  if (hd < HDP)
    for (int i = tid; i < 2 * KC * (HDP - hd); i += THREADS)
      raw[(i / (HDP - hd)) * LD + hd + i % (HDP - hd)] = 0.f;

  const int n_chunks = (kv_len + KC - 1) / KC;
  load_chunk<LD>(raw, kb, st.kl, 0, kv_len, hd, vec);
  load_chunk<LD>(raw + TILE, vb, st.vl, 0, kv_len, hd, vec);
  cp_async_commit();

  uint32_t qh[KT][4], ql[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + 8 * (r & 1);
      const int col = 8 * kt + c + 4 * (r >> 1);
      split(row < Lq && col < hd ? qb[row * st.ql + col] : 0.f, qh[kt][r],
            ql[kt][r]);
    }

  float o[KT][4];
#pragma unroll
  for (int n = 0; n < KT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8: running max (quad-uniform) and this lane's share of
  // the running sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int ch = 0; ch < n_chunks; ++ch) {
    cp_async_wait<0>();
    __syncthreads();  // chunk ch landed; every warp is done with ch - 1
    for (int i = 4 * tid; i < 2 * TILE; i += 4 * THREADS) {
      const float4 x = *reinterpret_cast<const float4*>(raw + i);
      uint4 xh, xl;
      split(x.x, xh.x, xl.x);
      split(x.y, xh.y, xl.y);
      split(x.z, xh.z, xl.z);
      split(x.w, xh.w, xl.w);
      *reinterpret_cast<uint4*>(hi + i) = xh;
      *reinterpret_cast<uint4*>(lo + i) = xl;
    }
    __syncthreads();  // hi / lo written; the raw buffer is free
    if (ch + 1 < n_chunks) {
      load_chunk<LD>(raw, kb, st.kl, (ch + 1) * KC, kv_len, hd, vec);
      load_chunk<LD>(raw + TILE, vb, st.vl, (ch + 1) * KC, kv_len, hd, vec);
      cp_async_commit();
    }
    if (!rows_here) continue;

    const int c0 = ch * KC;
    float s[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt)
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        const int at = (8 * j + g) * LD + 8 * kt + c;  // k row 8j + g
        mma_3x(s[j], qh[kt], ql[kt], bits(hi[at]), bits(hi[at + 4]),
               bits(lo[at]), bits(lo[at + 4]));
      }
    const bool edge = c0 + KC > kv_len;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] *= scale;
        if (edge && c0 + 8 * j + 2 * c + (e & 1) >= kv_len) s[j][e] = -1e30f;
      }

    // online softmax: the new row max, the sum rescaled, the chunk's
    // exp(s - max) in place of its scores
    float corr[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < KC / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[hh] = expf(m[hh] - mx);
      m[hh] = mx;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KC / 8; ++j) {
        s[j][2 * hh] = expf(s[j][2 * hh] - mx);
        s[j][2 * hh + 1] = expf(s[j][2 * hh + 1] - mx);
        sum += s[j][2 * hh] + s[j][2 * hh + 1];
      }
      l[hh] = l[hh] * corr[hh] + sum;
    }

    // p . v, 8 keys a step: A's column c is key 2c, column c + 4 key
    // 2c + 1. Each n-tile sums the chunk from zero on the tensor cores,
    // then joins the rescaled output in an f32 FMA: the mma's accumulation
    // (not rounded to nearest) then spans 12 products, not the whole row.
    uint32_t ph[KC / 8][4], pl[KC / 8][4];
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      split(s[kk][0], ph[kk][0], pl[kk][0]);  // (g, key 2c)
      split(s[kk][2], ph[kk][1], pl[kk][1]);  // (g + 8, key 2c)
      split(s[kk][1], ph[kk][2], pl[kk][2]);  // (g, key 2c + 1)
      split(s[kk][3], ph[kk][3], pl[kk][3]);  // (g + 8, key 2c + 1)
    }
#pragma unroll
    for (int n = 0; n < KT; ++n) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KC / 8; ++kk) {
        const int at = TILE + (8 * kk + 2 * c) * LD + 8 * n + g;  // v row
        mma_3x(d, ph[kk], pl[kk], bits(hi[at]), bits(hi[at + LD]),
               bits(lo[at]), bits(lo[at + LD]));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = fmaf(o[n][e], corr[e >> 1], d[e]);
    }
  }

  if (!rows_here) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const int row = row0 + g + 8 * hh;
    if (row >= Lq) continue;
    float* orow = out + b * st.ob + h * st.oh + row * st.ol;
#pragma unroll
    for (int n = 0; n < KT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * c + e;
        if (col < hd) orow[col] = o[n][2 * hh + e] / sum;
      }
  }
}

template <int HDP>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Lq, int hd, int kv_len, float scale,
                   const Strides& st, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 6 * KC * (HDP + 4);
  // 16-byte copies where every k / v row start allows them
  bool vec = hd % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const long long kv_strides[6] = {st.kb, st.kh, st.kl, st.vb, st.vh, st.vl};
  for (int i = 0; i < 6; ++i) vec = vec && kv_strides[i] % 4 == 0;
  cudaError_t err = cudaFuncSetAttribute(
      f32_mma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  f32_mma_kernel<HDP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Lq, hd,
      kv_len, scale, st, vec);
  return cudaGetLastError();
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         void* out, int B, int H, int Lq, int hd, int kv_len,
                         float scale, const Strides& st, cudaStream_t s) {
  if (hd <= 64) return launch<64>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st, s);
  if (hd <= 72) return launch<72>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st, s);
  if (hd <= 80) return launch<80>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st, s);
  return launch<128>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st, s);
}

}  // namespace tf32x3

// strides: 12 int64 values, (batch, head, row) strides of q, k, v and out in
// elements; the last dimension of each is contiguous. Lk <= 1024, B * H <=
// 65535; float32: hd <= 128; bfloat16: hd one of B2's head sizes (16, 32,
// 48, 56, 64, 72, 80, 96, 112, 128) and even out strides. dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_fused_attention(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Lq, int Lk,
                                   int hd, int kv_len, float scale, int dtype,
                                   const long long* strides, void* stream) {
  if (B < 1 || H < 1 || B * H > 65535 || Lq < 1 || Lk > tf32x3::MAX_LK ||
      hd < 1 || hd > 128 || kv_len < 1 || kv_len > Lk)
    return (int)cudaErrorInvalidValue;
  const long long* a = strides;
  const Strides st = {a[0], a[1], a[2], a[3], a[4],  a[5],
                      a[6], a[7], a[8], a[9], a[10], a[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)tf32x3::dispatch_f32(q, k, v, out, B, H, Lq, hd, kv_len,
                                     scale, st, s);
  if (dtype == 1) {
    if ((a[9] | a[10] | a[11]) % 2) return (int)cudaErrorInvalidValue;
    return (int)dispatch(q, k, v, out, B, H, Lq, hd, kv_len, scale, 1, st, s);
  }
  return (int)cudaErrorInvalidValue;
}
