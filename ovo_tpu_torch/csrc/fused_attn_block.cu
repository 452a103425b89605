// The attention half of a pre-LN transformer block: x + attn(LN(x)).
//
// Replaces: ovo_tpu/ops/fused_block.py fused_attn_block / _attn_kernel (the
// Pallas TPU kernel behind OVO_FUSED_BLOCK=1: every layer of a tower without
// LayerScale, on this path PE-Core-L14-336's 24 layers at 577 tokens, 16
// heads of 64, with RoPE-2D).
//
// What it computes, in _attn_kernel's op order:
//   lnx = LN(x) with f32 statistics, rounded to the dtype;
//   per head h: qkv = lnx . W_h in f32 + the f32 bias; RoPE in f32 on the
//     f32 q and k; q, k, v rounded to the dtype; s = q . k in f32, then
//     * hd^-0.5; keys >= L_real (and, causal, keys after the query) at
//     -1e30; p = softmax(s) in f32, rounded to the dtype; oh = p . v in f32,
//     rounded to the dtype;
//   acc = sum over heads, in head order, of oh . Wout_h in f32;
//   out = (x + acc) + out_b in f32, rounded to the dtype.
//
// What bounds it on an H100: per 577-token view and layer it does 6.2 GFLOP
// (qkv 3.63, scores and p.v 1.36, out-projection 1.21) and moves ~8 MB of
// bf16 weights once per call: in bf16 the tensor cores would bound a view
// near 6.3 us, the 7-view call (43.4 GFLOP) near 44 us.
//
// Design. The TPU kernel walks the heads in sequence on one core, computing
// LN once at head 0 and summing the out-projection in one VMEM scratch. A
// Hopper block shares nothing with other blocks, so the call runs as four
// or five launches over scratch in device memory (the wrapper allocates
// it), through one packed bf16 / f32 (B, L, 3D) buffer of [q | k | v]
// sections, head h at columns h hd of each:
//   1. LN rows -> lnx (dtype);
//   2. the qkv GEMM over the per-head weights (heads, D, 3hd) read in place.
//      bf16 with hd 64 (the PE tower's; block_common.cuh mma_gemm_kernel,
//      EPI_QKV_ROPE): on the tensor cores, summed in groups of one k step
//      (QKV_GROUP below), the bias and the f32 RoPE in its epilogue,
//      rounded once and written to the packed buffer -- no f32 scratch, no
//      third launch. Other shapes: the f32 FMA gemm_kernel writes f32 q, k,
//      v plus bias to a scratch, then
//   3. rope_split_kernel: RoPE, the rounding to the dtype and the packing;
//   4. attention over the packed buffer. bf16, not causal, hd a multiple of
//      16: B5's two-pass tensor-core kernel (two_pass_attention.cuh), which
//      computes this function exactly: f32 scores times the f32 scale, keys
//      at or past L_real at -1e30, p rounded after normalizing, p.v rounded
//      once. Otherwise (f32, causal, other head sizes) attn_kernel: per
//      (view, head, 32-query tile) the 32 score rows kept in shared memory
//      so the exact row max and sum are taken once and p is rounded after
//      normalizing (kernel B10's first design), FMAs on the CUDA cores;
//   5. the out-projection GEMM over the token-major heads (B L, D), its k
//      axis summed per head then across heads in order, with the residual
//      and the bias (tensor cores in bf16 where mma_gemm_fits takes it).
// attn_routes chooses the route of each stage; ovo_fused_attn_block_routes
// reports it to the wrapper. The first design (every stage on f32 FMAs, q,
// k, v split into (B, heads, L, hd) from an f32 scratch) took 3.159 ms at
// the PE shape on an H100.
#include "block_common.cuh"
#include "two_pass_attention.cuh"

namespace {

using namespace ovo_block;

constexpr int BQ = 32;        // query rows per attention block
constexpr int BK = 128;       // keys per k / v tile
constexpr int THREADS = 256;  // 8 warps x 4 rows
constexpr int MAX_L = 1024;

// 3. RoPE (rotate-half on the f32 values, each op rounded on its own), the
// rounding to T and the packing of the per-head [q | k | v] columns of qkv
// (B L, 3D), head-major, into packed (B L, 3D), section-major.
template <typename T>
__global__ void rope_split_kernel(const float* __restrict__ qkv,
                                  const float* __restrict__ cos_t,
                                  const float* __restrict__ sin_t,
                                  T* __restrict__ packed, int L, int H,
                                  int hd, long long total, int use_rope) {
  const long long D = (long long)H * hd;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long m = idx / D;
  const int c = (int)(idx % D);
  const int h = c / hd, d = c % hd;
  const int l = (int)(m % L);
  const float* base = qkv + m * 3 * D + (long long)h * 3 * hd;
  float qv = base[d], kv = base[hd + d];
  const float vv = base[2 * hd + d];
  if (use_rope) {
    const int half = hd / 2;
    const int i = d % half;
    const float cs = cos_t[l * half + i], sn = sin_t[l * half + i];
    const float q1 = base[i], q2 = base[i + half];
    const float k1 = base[hd + i], k2 = base[hd + i + half];
    if (d < half) {
      qv = __fsub_rn(__fmul_rn(q1, cs), __fmul_rn(q2, sn));
      kv = __fsub_rn(__fmul_rn(k1, cs), __fmul_rn(k2, sn));
    } else {
      qv = __fadd_rn(__fmul_rn(q1, sn), __fmul_rn(q2, cs));
      kv = __fadd_rn(__fmul_rn(k1, sn), __fmul_rn(k2, cs));
    }
  }
  T* row = packed + m * 3 * D + c;
  row[0] = from_f<T>(qv);
  row[D] = from_f<T>(kv);
  row[2 * D] = from_f<T>(vv);
}

__host__ __device__ __forceinline__ int score_ld(int L) {
  return (L + BK - 1) / BK * BK;
}

// 4. Whole-row softmax attention for one (view, head, 32-query tile) of the
// packed (B L, 3D) buffer; out token-major (B L, D).
//   pass 1: 128-key tiles of k through shared memory; warp w owns query rows
//           4w..4w+3, lane j keys j + 32c of the tile (a 4 x 4 register
//           micro-tile); the scaled, masked score lands in the row buffer;
//   pass 2: each warp normalizes its own rows (shuffle-reduced max and sum)
//           and writes the rounded p in place;
//   pass 3: 128-key tiles of v; warp w accumulates its rows, lane j columns
//           j + 32c.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS)
attn_kernel(const T* __restrict__ packed, T* __restrict__ out, int H,
            int L, int hd, int kv_len, int causal, float scale) {
  constexpr int LDV = 32 * NC;
  const int LD = hd + 1;  // odd row length: lanes on distinct banks
  const int LS = score_ld(L);
  extern __shared__ float smem[];
  float* q_s = smem;            // BQ x LD
  float* s_s = q_s + BQ * LD;   // BQ x LS
  float* t_s = s_s + BQ * LS;   // BK x LD (k) or BK x LDV (v)

  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;
  const size_t ld = 3 * (size_t)H * hd;  // the packed row
  const T* qb = packed + (size_t)b * L * ld + (size_t)h * hd;
  const T* kb = qb + (size_t)H * hd;
  const T* vb = kb + (size_t)H * hd;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = 4 * warp;
  const int n_tiles = (kv_len + BK - 1) / BK;

  for (int i = tid; i < BQ * hd; i += THREADS) {
    const int r = i / hd, d = i % hd, t = q0 + r;
    q_s[r * LD + d] = t < L ? to_f<T>(qb[(size_t)t * ld + d]) : 0.f;
  }

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    for (int i = tid; i < BK * hd; i += THREADS) {
      const int r = i / hd, d = i % hd, t = k0 + r;
      t_s[r * LD + d] = t < L ? to_f<T>(kb[(size_t)t * ld + d]) : 0.f;
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
        const bool keep = key < kv_len && !(causal && key > q0 + r0 + i);
        s_s[(r0 + i) * LS + key] = keep ? __fmul_rn(s[i][j], scale) : -1e30f;
      }
  }
  __syncwarp();

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

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV, d = i % LDV, t = k0 + r;
      t_s[i] = (t < L && d < hd) ? to_f<T>(vb[(size_t)t * ld + d]) : 0.f;
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
    if (row >= L) continue;
    T* o = out + (((size_t)b * L + row) * H + h) * hd;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = lane + 32 * c;
      if (col < hd) o[col] = from_f<T>(acc[i][c]);
    }
  }
}

template <typename T, int NC>
cudaError_t launch_attn(const void* packed, void* out, int B, int H, int L,
                        int hd, int kv_len, int causal, float scale,
                        cudaStream_t stream) {
  const int ld = hd + 1;
  const int tile = BK * (ld > 32 * NC ? ld : 32 * NC);
  const size_t smem =
      sizeof(float) * ((size_t)BQ * ld + (size_t)BQ * score_ld(L) + tile);
  cudaError_t err = cudaFuncSetAttribute(
      attn_kernel<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BQ - 1) / BQ, B * H);
  attn_kernel<T, NC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(packed), static_cast<T*>(out), H, L, hd, kv_len,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_attn(const void* packed, void* out, int B, int H, int L,
                          int hd, int kv_len, int causal, float scale,
                          cudaStream_t s) {
  switch ((hd + 31) / 32) {
    case 1: return launch_attn<T, 1>(packed, out, B, H, L, hd, kv_len, causal, scale, s);
    case 2: return launch_attn<T, 2>(packed, out, B, H, L, hd, kv_len, causal, scale, s);
    case 3: return launch_attn<T, 3>(packed, out, B, H, L, hd, kv_len, causal, scale, s);
    case 4: return launch_attn<T, 4>(packed, out, B, H, L, hd, kv_len, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

// The qkv GEMM's k groups on the tensor cores: one k step each. Summed by
// the mma over all of D (1024), its accumulation without rounding to
// nearest moved more of B12a's outputs by a bf16 step at the PE shape than
// two plain evaluations (card and CPU) differ in; summed per k step from
// zero and added in f32 it stays below (PERF.md, PR 11).
constexpr int QKV_GROUP = MMA_BK;

// routes (bf16 only), one bit each
constexpr int ROUTE_QKV_ROPE = 1;  // the qkv GEMM on the tensor cores, with
                                   // RoPE and packing in its epilogue
constexpr int ROUTE_ATTN_MMA = 2;  // two_pass_mma_kernel
constexpr int ROUTE_OUT_MMA = 4;   // the out-projection on the tensor cores

// The stages that run on the tensor cores for these inputs: bf16 only; the
// qkv GEMM with hd 64 where mma_gemm_fits takes it; the attention where it
// is not causal and hd is a multiple of 16 (<= 128); the out-projection
// where mma_gemm_fits takes it.
int attn_routes(const void* x, const void* w_heads, const void* ow, int D,
                int H, int causal, int dtype) {
  if (dtype != 1) return 0;
  const int hd = D / H;
  int r = 0;
  if (hd == 64 && mma_gemm_fits(w_heads, nullptr, D, 3 * hd, 3 * hd,
                                (long long)D * 3 * hd, 3 * D, D, QKV_GROUP,
                                3 * D, EPI_QKV_ROPE))
    r |= ROUTE_QKV_ROPE;
  if (!causal && hd % 16 == 0) r |= ROUTE_ATTN_MMA;
  if (mma_gemm_fits(ow, x, D, D, D, 0, D, D, hd, D, EPI_RESID))
    r |= ROUTE_OUT_MMA;
  return r;
}

template <typename T>
cudaError_t run(const void* x, const void* w_heads, const float* b_heads,
                const void* ow, const float* ob, const float* ln_s,
                const float* ln_b, const float* cos_t, const float* sin_t,
                void* out, void* lnx, float* qkv32, void* packed, void* oh,
                int B, int L, int D, int H, int L_real, int causal,
                int use_rope, int routes, cudaStream_t s) {
  const int M = B * L, hd = D / H;
  const RopeEpi rope{cos_t, sin_t, L, D, use_rope};
  const float scale = (float)pow((double)hd, -0.5);
  cudaError_t err = launch_ln_rows<T>(x, ln_s, ln_b, lnx, M, D, s);
  if (err != cudaSuccess) return err;
  // qkv: B[k, n] = w_heads[n / 3hd][k][n % 3hd]; the FMA GEMM sums in one
  // k group (a plain sum), the tensor cores in groups of QKV_GROUP
  if (routes & ROUTE_QKV_ROPE) {
    err = launch_mma_gemm<EPI_QKV_ROPE>(lnx, D, w_heads, 3 * hd, 3 * hd,
                                        (long long)D * 3 * hd, M, 3 * D, D,
                                        QKV_GROUP, b_heads, nullptr, packed,
                                        3 * D, 0, rope, s);
    if (err != cudaSuccess) return err;
  } else {
    err = launch_gemm<T, EPI_F32_BIAS>(lnx, D, w_heads, 3 * hd, 3 * hd,
                                       (long long)D * 3 * hd, M, 3 * D, D, D,
                                       b_heads, nullptr, qkv32, 3 * D, 0, s);
    if (err != cudaSuccess) return err;
    const long long total = (long long)M * D;
    rope_split_kernel<T><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        qkv32, cos_t, sin_t, static_cast<T*>(packed), L, H, hd, total,
        use_rope);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (routes & ROUTE_ATTN_MMA) {
    const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(packed);
    err = dispatch_two_pass(hd, p, p + D, p + 2 * D, 3LL * D, 3LL * D,
                            static_cast<__nv_bfloat16*>(oh), B, L, D, H,
                            L_real, scale, s);
  } else {
    err = dispatch_attn<T>(packed, oh, B, H, L, hd, L_real, causal, scale, s);
  }
  if (err != cudaSuccess) return err;
  // out-projection: ow_heads (H, hd, D) is the (D, D) row-major matrix; the
  // k axis summed per head (groups of hd), heads added in order
  return routes & ROUTE_OUT_MMA
             ? launch_mma_gemm<EPI_RESID>(oh, D, ow, D, D, 0, M, D, D, hd,
                                          ob, x, out, D, 0, rope, s)
             : launch_gemm<T, EPI_RESID>(oh, D, ow, D, D, 0, M, D, D, hd, ob,
                                         x, out, D, 0, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// The routes ovo_fused_attn_block takes for these inputs: the ROUTE_* bits.
extern "C" int ovo_fused_attn_block_routes(const void* x, const void* w_heads,
                                           const void* ow, int D, int H,
                                           int causal, int dtype) {
  if (H < 1 || D % H) return 0;
  return attn_routes(x, w_heads, ow, D, H, causal, dtype);
}

// x, out (B, L, D) and the scratch lnx, oh (B L, D), packed (B L, 3D) in
// the dtype; w_heads (H, D, 3hd) and ow_heads (H, hd, D) in the dtype;
// b_heads (H, 3hd), ob, ln_s, ln_b (D,), cos / sin (L, hd/2) and qkv32
// (B L, 3D; unused, and may be null, where the qkv GEMM takes the
// tensor-core route) f32. All contiguous; out and the scratch 16-byte
// aligned. L <= 1024, hd % 8 == 0, hd <= 128, B * H <= 65535. dtype:
// 0 = float32, 1 = bfloat16. Returns the first failing cudaError_t of the
// launches.
extern "C" int ovo_fused_attn_block(
    const void* x, const void* w_heads, const void* b_heads, const void* ow,
    const void* ob, const void* ln_s, const void* ln_b, const void* cos_t,
    const void* sin_t, void* out, void* lnx, void* qkv32, void* packed,
    void* oh, int B, int L, int D, int H, int L_real, int causal,
    int use_rope, int dtype, void* stream) {
  if (B < 1 || L < 1 || L > MAX_L || H < 1 || D % H || (D / H) % 8 ||
      D / H > 128 || B * H > 65535 || L_real < 1 || L_real > L ||
      !aligned16(out) || !aligned16(lnx) || !aligned16(packed) ||
      !aligned16(oh))
    return (int)cudaErrorInvalidValue;
  const int routes = attn_routes(x, w_heads, ow, D, H, causal, dtype);
  if (!(routes & ROUTE_QKV_ROPE) && qkv32 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(b_heads),
                       static_cast<const float*>(ob),
                       static_cast<const float*>(ln_s),
                       static_cast<const float*>(ln_b),
                       static_cast<const float*>(cos_t),
                       static_cast<const float*>(sin_t)};
  float* qkv = static_cast<float*>(qkv32);
  if (dtype == 0)
    return (int)run<float>(x, w_heads, f[0], ow, f[1], f[2], f[3], f[4], f[5],
                           out, lnx, qkv, packed, oh, B, L, D, H, L_real,
                           causal, use_rope, routes, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, w_heads, f[0], ow, f[1], f[2], f[3],
                                   f[4], f[5], out, lnx, qkv, packed, oh, B,
                                   L, D, H, L_real, causal, use_rope, routes,
                                   s);
  return (int)cudaErrorInvalidValue;
}
