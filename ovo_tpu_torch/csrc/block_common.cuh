// Shared pieces of the whole-block kernels B12a (fused_attn_block.cu) and
// B12b (fused_mlp_block.cu): dtype helpers, the row LayerNorm and two tiled
// GEMMs with the blocks' epilogues: gemm_kernel (f32 FMAs, every dtype and
// width) and mma_gemm_kernel (bf16 on the tensor cores, below).
//
// gemm_kernel does its products as f32 FMAs on the CUDA cores, fed from
// shared memory: a 128 x 64 output tile per block of 256 threads, 8-deep k
// slices, each thread an 8 x 4 register micro-tile (rows ty + 16 i, columns
// tx + 16 j, so the shared-memory reads of a warp are broadcasts or
// consecutive). Inputs in bf16 are widened on load, so every product is exact
// and every sum f32, as the TPU kernels' preferred_element_type=f32 dots.
//
// The k axis is summed in groups: a group's partial sum starts at zero and is
// added to the running sum when the group ends -- the TPU kernels' order for
// the out-projection (one group per head, heads in order) and the MLP's proj
// (one group per hidden chunk). With one group the result is the plain sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace ovo_block {

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

// ---------------------------------------------------------------------------
// LayerNorm over rows of D: f32 mean, then the f32 mean of squared
// deviations, (x - mu) * 1/sqrt(var + 1e-5), then * scale + bias, each op
// rounded on its own (no contraction), the result rounded to T. One warp per
// row, 8 rows per block.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
ln_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, T* __restrict__ out, int M,
               int D) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + (size_t)row * D;
  float s = 0.f;
  for (int i = lane; i < D; i += 32) s += to_f<T>(xr[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const float mu = s / (float)D;
  float s2 = 0.f;
  for (int i = lane; i < D; i += 32) {
    const float d = __fsub_rn(to_f<T>(xr[i]), mu);
    s2 = __fadd_rn(s2, __fmul_rn(d, d));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  const float rstd = 1.0f / sqrtf(__fadd_rn(s2 / (float)D, 1e-5f));
  T* orow = out + (size_t)row * D;
  for (int i = lane; i < D; i += 32) {
    const float y = __fmul_rn(__fsub_rn(to_f<T>(xr[i]), mu), rstd);
    orow[i] = from_f<T>(__fadd_rn(__fmul_rn(y, scale[i]), bias[i]));
  }
}

template <typename T>
cudaError_t launch_ln_rows(const void* x, const float* scale,
                           const float* bias, void* out, int M, int D,
                           cudaStream_t stream) {
  ln_rows_kernel<T><<<(M + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(x), scale, bias, static_cast<T*>(out), M, D);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// GEMM: C[m, n] = sum_k A[m, k] B[k, n], A (M, K) row-major with row stride
// lda; B addressed per column group, B[k, n] = Bw[(n / gn) * gs + n % gn +
// k * ldb] (a plain (K, N) row-major matrix: gn = N, gs = 0, ldb = N; the
// per-head qkv weights (heads, K, 3hd): gn = 3hd, gs = K * 3hd, ldb = 3hd).
// ---------------------------------------------------------------------------
enum Epilogue {
  EPI_F32_BIAS = 0,  // out f32 = C + bias
  EPI_ACT = 1,       // out T = act(C + bias)
  EPI_RESID = 2,     // out T = (resid + C) + bias
};
enum Act { ACT_GELU = 0, ACT_QUICK_GELU = 1 };

constexpr int GBM = 128, GBN = 64, GBK = 8, GTHREADS = 256;

template <typename T>
__device__ __forceinline__ float activate(float v, int act) {
  if (act == ACT_QUICK_GELU)
    return __fmul_rn(v, 1.0f / (1.0f + expf(-__fmul_rn(1.702f, v))));
  if (sizeof(T) == 2) {  // bf16: tanh approximation (layers.gelu's rule)
    const float kBeta = 0.7978845608028654f, kKappa = 0.044715f;
    const float inner = __fmul_rn(
        kBeta, __fadd_rn(v, __fmul_rn(kKappa, __fmul_rn(__fmul_rn(v, v), v))));
    return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(inner)));
  }
  return __fmul_rn(__fmul_rn(v, 0.5f),
                   __fadd_rn(1.0f, erff(__fmul_rn(v, 0.7071067811865476f))));
}

template <typename T, int EPI>
__global__ void __launch_bounds__(GTHREADS)
gemm_kernel(const T* __restrict__ A, int lda, const T* __restrict__ Bw,
            int ldb, int gn, long long gs, int M, int N, int K, int group,
            const float* __restrict__ bias, const T* __restrict__ resid,
            void* __restrict__ out, int ldo, int act) {
  __shared__ float As[GBK][GBM];
  __shared__ float Bs[GBK][GBN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;

  // this thread's B column (the same for both of its loads)
  const int bcol = tid & 63, bk = tid >> 6;  // bk in 0..3; rows bk, bk + 4
  const int bn = n0 + bcol;
  const long long bbase = bn < N ? (gs ? (long long)(bn / gn) * gs + bn % gn
                                       : (long long)bn)
                                 : -1;

  float acc[8][4], part[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = part[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += GBK) {
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int idx = tid + GTHREADS * r;
      const int row = idx >> 3, kk = idx & 7;
      const int m = m0 + row, k = k0 + kk;
      As[kk][row] = (m < M && k < K) ? to_f<T>(A[(size_t)m * lda + k]) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kk = bk + 4 * r, k = k0 + kk;
      Bs[kk][bcol] = (bbase >= 0 && k < K)
                         ? to_f<T>(Bw[bbase + (long long)k * ldb])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < GBK; ++kk) {
      float a[8], b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
    }
    const int kn = k0 + GBK;
    if (kn % group == 0 || kn >= K) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
          part[i][j] = 0.f;
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float c = acc[i][j];
      if (EPI == EPI_F32_BIAS) {
        static_cast<float*>(out)[(size_t)m * ldo + n] = __fadd_rn(c, bias[n]);
      } else if (EPI == EPI_ACT) {
        static_cast<T*>(out)[(size_t)m * ldo + n] =
            from_f<T>(activate<T>(__fadd_rn(c, bias[n]), act));
      } else {
        const float r = to_f<T>(resid[(size_t)m * ldo + n]);
        static_cast<T*>(out)[(size_t)m * ldo + n] =
            from_f<T>(__fadd_rn(__fadd_rn(r, c), bias[n]));
      }
    }
  }
}

template <typename T, int EPI>
cudaError_t launch_gemm(const void* A, int lda, const void* Bw, int ldb,
                        int gn, long long gs, int M, int N, int K, int group,
                        const float* bias, const void* resid, void* out,
                        int ldo, int act, cudaStream_t stream) {
  if (group < GBK || group % GBK) return cudaErrorInvalidValue;
  dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  gemm_kernel<T, EPI><<<grid, GTHREADS, 0, stream>>>(
      static_cast<const T*>(A), lda, static_cast<const T*>(Bw), ldb, gn, gs,
      M, N, K, group, bias, static_cast<const T*>(resid), out, ldo, act);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 GEMM on the tensor cores: the same C = A B, B addressing, k groups and
// epilogues as gemm_kernel, for N a multiple of the tile's N extent and K
// (and the group) a multiple of MMA_BK.
//
// What bounds it: mma.sync (Hopper's wgmma is not used) and the shared
// memory that feeds it. A warp's tile of m16n8k16 products (bf16 in, f32
// accumulators) takes its fragments through ldmatrix (B, a (K, N) row-major
// weight, through ldmatrix.trans); the wider the warp tile, the fewer
// shared-memory bytes a product needs. One-group GEMMs (fc) take 128 x 256
// blocks of eight 64 x 64 warp tiles, one block an SM (~246 registers);
// grouped ones (qkv, out, proj) hold a second accumulator set and take
// 128 x 128 blocks of eight 32 x 64 warp tiles (~228 registers). A
// MMA_STAGES-deep ring of MMA_BK-deep k slices in shared memory is filled
// by 16-byte cp.async copies (rows at or past M zero-filled), and the
// fragments of the next k16 step load while the current step's products
// run (two register sets). Rows are padded by 8 values, an odd number of
// 16-byte units: ldmatrix reads no two rows of one 8 x 8 matrix from one
// bank. The tiles and the k step are fixed at compile time, so the
// unrolled loops carry no run-time guards; they were chosen by timing
// their runners-up at the PE shape on an H100 (PERF.md, PR 11).
//
// The k groups: the mma accumulates without rounding to nearest, so a
// group's partial sum starts from zero accumulators and joins the running
// f32 sum with one __fadd_rn when the group ends, as in gemm_kernel. With
// one group (GROUPED false) the accumulators are the running sum.
//
// Epilogues, from the f32 accumulators in registers, in gemm_kernel's op
// order: EPI_ACT and EPI_RESID as there, and EPI_QKV_ROPE (B12a's qkv):
// bias, then rotate-half RoPE on the f32 q and k (each op rounded on its
// own), rounded once to bf16 and written to the packed [q | k | v] buffer
// (B, L, 3D), head h at columns h hd of each section. It needs a warp tile
// 64 columns wide over the per-head weights (heads, D, 3 * 64): a warp's
// columns are then one head's q, k or v, and column d and its rotate-half
// partner d + 32 sit in n8 tiles j and j + 4 of the same lane.
// ---------------------------------------------------------------------------
enum { EPI_QKV_ROPE = 3 };

constexpr int MMA_BK = 64, MMA_STAGES = 4;  // the k step, the ring's depth

template <int BM_, int BN_, int WARPS_M_, int WARPS_N_>
struct MmaTile {
  static constexpr int BM = BM_, BN = BN_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M, WTN = BN / WARPS_N;
  static constexpr int MT = WTM / 16, NT = WTN / 8;  // m16 / n8 tiles a warp
  static constexpr int LDA = MMA_BK + 8, LDB = BN + 8;
  static constexpr int STAGE = BM * LDA + MMA_BK * LDB;  // bf16 values
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * MMA_STAGES * STAGE;
  static_assert(WTM % 16 == 0 && WTN == 64, "warp tile: 64 columns wide");
  static_assert((BM * MMA_BK / 8) % THREADS == 0, "A copies");
  static_assert((MMA_BK * BN / 8) % THREADS == 0, "B copies");
  static_assert(THREADS % (BN / 8) == 0, "B column per thread");
};
using PlainTile = MmaTile<128, 256, 2, 4>;  // one k group
using GroupTile = MmaTile<128, 128, 4, 2>;  // grouped sums

// B12a's RoPE epilogue: cos / sin (L, 32) f32, the packed buffer's D
struct RopeEpi {
  const float* cos_t;
  const float* sin_t;
  int L, D, use_rope;
};

template <class Tl, int EPI, bool GROUPED>
__global__ void __launch_bounds__(Tl::THREADS, 1)
mma_gemm_kernel(const __nv_bfloat16* __restrict__ A, int lda,
                const __nv_bfloat16* __restrict__ Bw, int ldb, int gn,
                long long gs, int M, int K, int group,
                const float* __restrict__ bias,
                const __nv_bfloat16* __restrict__ resid,
                void* __restrict__ out, int ldo, int act, RopeEpi rope) {
  using bf16 = __nv_bfloat16;
  static_assert(EPI == EPI_ACT || EPI == EPI_RESID || EPI == EPI_QKV_ROPE,
                "epilogue");
  constexpr int BM = Tl::BM, BN = Tl::BN, LDA = Tl::LDA, LDB = Tl::LDB;
  constexpr int MT = Tl::MT, NT = Tl::NT, THREADS = Tl::THREADS;
  constexpr int CPR = MMA_BK / 8;  // 16-byte copies an A row
  constexpr int A_COPIES = BM * CPR / THREADS;
  constexpr int A_ROWS = THREADS / CPR;  // A rows a copy round
  constexpr int B_COPIES = MMA_BK * BN / 8 / THREADS;
  constexpr int B_ROWS = THREADS / (BN / 8);  // k rows a B copy round
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Tl::WARPS_M, wn = warp / Tl::WARPS_M;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  // this thread's copies: A rows tid / CPR + A_ROWS i at k offset
  // 8 (tid % CPR); B k rows tid / (BN / 8) + B_ROWS i at one column chunk
  const int a_row0 = tid / CPR, a_k = 8 * (tid % CPR);
  const bf16* a_src[A_COPIES];
  bool a_ok[A_COPIES];
#pragma unroll
  for (int i = 0; i < A_COPIES; ++i) {
    const int m = m0 + a_row0 + A_ROWS * i;
    a_ok[i] = m < M;
    a_src[i] = A + (size_t)(a_ok[i] ? m : 0) * lda + a_k;
  }
  const int b_col = 8 * (tid % (BN / 8)), b_row = tid / (BN / 8);
  const int bn = n0 + b_col;
  const bf16* b_src =
      Bw + (gs ? (long long)(bn / gn) * gs + bn % gn : (long long)bn) +
      (long long)b_row * ldb;

  auto load_stage = [&](int stage, int k0) {
    bf16* as = smem + stage * Tl::STAGE;
    bf16* bs = as + BM * LDA;
#pragma unroll
    for (int i = 0; i < A_COPIES; ++i)
      copy_async(as + (a_row0 + A_ROWS * i) * LDA + a_k, a_src[i] + k0,
                 a_ok[i], 3);
#pragma unroll
    for (int i = 0; i < B_COPIES; ++i)
      copy_async(bs + (b_row + B_ROWS * i) * LDB + b_col,
                 b_src + (long long)(k0 + B_ROWS * i) * ldb, true, 3);
  };

  float acc[MT][NT][4], part[GROUPED ? MT : 1][GROUPED ? NT : 1][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  if (GROUPED) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[GROUPED ? i : 0][GROUPED ? j : 0][e] = 0.f;
  }

  const int k_steps = K / MMA_BK, group_steps = group / MMA_BK;
  constexpr int KK = MMA_BK / 16;  // k16 steps a slice
  const int a_row = lane & 15, a_col = 8 * (lane >> 4);
  // the fragments of k16 step kk of a slot: A through ldmatrix, B (k x n
  // in shared memory) through ldmatrix.trans, two n8 tiles a load
  auto load_frags = [&](uint32_t (&af)[MT][4], uint32_t (&bfr)[NT][2],
                        int slot, int kk) {
    const bf16* as = smem + slot * Tl::STAGE + (wm * Tl::WTM) * LDA;
    const bf16* bs = smem + slot * Tl::STAGE + BM * LDA + wn * Tl::WTN;
#pragma unroll
    for (int i = 0; i < MT; ++i)
      ldmatrix_x4(af[i], as + (16 * i + a_row) * LDA + 16 * kk + a_col);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t r[4];
      ldmatrix_x4_trans(r, bs + (16 * kk + a_row) * LDB + 16 * j + a_col);
      bfr[2 * j][0] = r[0];
      bfr[2 * j][1] = r[1];
      bfr[2 * j + 1][0] = r[2];
      bfr[2 * j + 1][1] = r[3];
    }
  };
  auto products = [&](const uint32_t (&af)[MT][4],
                      const uint32_t (&bfr)[NT][2]) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (GROUPED)
          mma_bf16(part[GROUPED ? i : 0][GROUPED ? j : 0], af[i], bfr[j][0],
                   bfr[j][1]);
        else
          mma_bf16(acc[i][j], af[i], bfr[j][0], bfr[j][1]);
      }
  };
  auto end_group = [&](int kt) {
    if (GROUPED && (kt + 1) % group_steps == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float& p = part[GROUPED ? i : 0][GROUPED ? j : 0][e];
            acc[i][j][e] = __fadd_rn(acc[i][j][e], p);
            p = 0.f;
          }
    }
  };

#pragma unroll
  for (int s = 0; s < MMA_STAGES - 1; ++s) {
    if (s < k_steps) load_stage(s, s * MMA_BK);
    cp_async_commit();
  }
  // Two register sets of fragments: step kk + 1's are loaded while step
  // kk's products run; the next slice's first fragments after the barrier
  // that says it has landed and that every warp is done with the slot the
  // next copies refill.
  uint32_t af[2][MT][4], bfr[2][NT][2];
  cp_async_wait<MMA_STAGES - 2>();
  __syncthreads();
  load_frags(af[0], bfr[0], 0, 0);
  for (int kt = 0; kt < k_steps; ++kt) {
    const int slot = kt % MMA_STAGES;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      if (kk == KK - 1) {
        cp_async_wait<MMA_STAGES - 2>();
        __syncthreads();
      }
      if (kk < KK - 1)
        load_frags(af[(kk + 1) & 1], bfr[(kk + 1) & 1], slot, kk + 1);
      else if (kt + 1 < k_steps)
        load_frags(af[(kk + 1) & 1], bfr[(kk + 1) & 1],
                   (kt + 1) % MMA_STAGES, 0);
      if (kk == 0) {
        const int nxt = kt + MMA_STAGES - 1;
        if (nxt < k_steps) load_stage(nxt % MMA_STAGES, nxt * MMA_BK);
        cp_async_commit();
      }
      products(af[kk & 1], bfr[kk & 1]);
    }
    end_group(kt);
  }

  // epilogue: lane (g, c) holds rows g and g + 8 of each m16 tile, columns
  // 2c and 2c + 1 of each n8 tile
  const int g = lane >> 2, c = lane & 3;
  const int wn0 = n0 + wn * Tl::WTN;
  int sec = 0, head = 0;
  if (EPI == EPI_QKV_ROPE) {  // the warp's 64 columns: one head's q, k or v
    head = wn0 / 192;
    sec = wn0 % 192 / 64;
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = m0 + wm * Tl::WTM + 16 * i + g + 8 * hh;
      if (m >= M) continue;
      if (EPI == EPI_QKV_ROPE) {
        float y[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            y[j][e] = __fadd_rn(acc[i][j][2 * hh + e],
                                bias[wn0 + 8 * j + 2 * c + e]);
        if (rope.use_rope && sec < 2) {
          const int l = m % rope.L;
#pragma unroll
          for (int j = 0; j < NT / 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 8 * j + 2 * c + e;
              const float cs = rope.cos_t[l * 32 + d];
              const float sn = rope.sin_t[l * 32 + d];
              const float x1 = y[j][e], x2 = y[j + NT / 2][e];
              y[j][e] = __fsub_rn(__fmul_rn(x1, cs), __fmul_rn(x2, sn));
              y[j + NT / 2][e] =
                  __fadd_rn(__fmul_rn(x1, sn), __fmul_rn(x2, cs));
            }
        }
        bf16* orow = static_cast<bf16*>(out) + (size_t)m * ldo +
                     sec * rope.D + head * 64;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * c) =
              __floats2bfloat162_rn(y[j][0], y[j][1]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int n = wn0 + 8 * j + 2 * c;
        const float c0 = acc[i][j][2 * hh], c1 = acc[i][j][2 * hh + 1];
        if (EPI == EPI_ACT) {
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                             (size_t)m * ldo + n) =
              __floats2bfloat162_rn(
                  activate<bf16>(__fadd_rn(c0, bias[n]), act),
                  activate<bf16>(__fadd_rn(c1, bias[n + 1]), act));
        } else {
          const __nv_bfloat162 r = *reinterpret_cast<const __nv_bfloat162*>(
              resid + (size_t)m * ldo + n);
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) +
                                             (size_t)m * ldo + n) =
              __floats2bfloat162_rn(
                  __fadd_rn(__fadd_rn(__low2float(r), c0), bias[n]),
                  __fadd_rn(__fadd_rn(__high2float(r), c1), bias[n + 1]));
        }
      }
    }
}

// Whether the tensor-core GEMM takes a bf16 product of this shape: N a
// multiple of its tile's N extent, K and the group multiples of MMA_BK,
// the weight's rows 16-byte aligned (Bw, its stride and column groups) and
// A's row stride too, the residual and the output's row stride aligned for
// pairs; EPI_QKV_ROPE also needs the per-head layout of hd 64 (one head's
// q, k or v a warp). A and the output are the entry points' own 16-byte
// aligned buffers. The one test of what takes the tensor cores: the entry
// points choose their routes by it and report them.
inline bool mma_gemm_fits(const void* Bw, const void* resid, int lda,
                          int ldb, int gn, long long gs, int N, int K,
                          int group, int ldo, int epi) {
  const bool aligned = reinterpret_cast<uintptr_t>(Bw) % 16 == 0 &&
                       lda % 8 == 0 && ldb % 8 == 0 && gn % 8 == 0 &&
                       gs % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(resid) % 8 == 0 &&
                       ldo % 2 == 0;
  const int bn = group < K ? GroupTile::BN : PlainTile::BN;
  const bool shape = N % bn == 0 && K % MMA_BK == 0 &&
                     group % MMA_BK == 0 && K % group == 0;
  return aligned && shape && (epi != EPI_QKV_ROPE || gn == 192);
}

template <class Tl, int EPI, bool GROUPED>
cudaError_t launch_mma_gemm_as(const void* A, int lda, const void* Bw,
                               int ldb, int gn, long long gs, int M, int N,
                               int K, int group, const float* bias,
                               const void* resid, void* out, int ldo, int act,
                               RopeEpi rope, cudaStream_t stream) {
  auto kernel = mma_gemm_kernel<Tl, EPI, GROUPED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(N / Tl::BN, (M + Tl::BM - 1) / Tl::BM);
  kernel<<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(A), lda,
      static_cast<const __nv_bfloat16*>(Bw), ldb, gn, gs, M, K, group, bias,
      static_cast<const __nv_bfloat16*>(resid), out, ldo, act, rope);
  return cudaGetLastError();
}

// bf16 C = A B with EPI on the tensor cores, for a shape mma_gemm_fits
// takes (the caller chose this route by it)
template <int EPI>
cudaError_t launch_mma_gemm(const void* A, int lda, const void* Bw, int ldb,
                            int gn, long long gs, int M, int N, int K,
                            int group, const float* bias, const void* resid,
                            void* out, int ldo, int act, RopeEpi rope,
                            cudaStream_t stream) {
  if (group < K)
    return launch_mma_gemm_as<GroupTile, EPI, true>(
        A, lda, Bw, ldb, gn, gs, M, N, K, group, bias, resid, out, ldo, act,
        rope, stream);
  return launch_mma_gemm_as<PlainTile, EPI, false>(
      A, lda, Bw, ldb, gn, gs, M, N, K, K, bias, resid, out, ldo, act, rope,
      stream);
}

}  // namespace ovo_block
