// Masked single-query attention pooling over shared tokens.
//
// Replaces: ovo_tpu/ops/masked_pool.py pallas_masked_pool / _pool_kernel (the
// Pallas TPU kernel of TextRegion's per-mask probe pooling).
//
// What it computes, for each mask m and head h (all in f32):
//   s[l]    = (q[m, h] * scale) . k[h, l], set to -1e30 where key_mask[m, l] == 0;
//   p       = exp(s - max s) / max(sum, 1e-30), never rounded;
//   out[m,h] = p . v[h], rounded once to the dtype.
// A fully masked row sees every score at -1e30, so it pools the uniform mean
// of v over all L tokens: finite, never NaN (padded mask slots hit this case
// on every keyframe).
//
// What bounds it on an H100: at the TextRegion path shape (96 masks, 16 heads
// of 64, L = 48*72 = 3456 tokens, bf16) the function needs ~1.4 GFLOP
// (tensor-core rate: ~1.4 us) and must read v once (7 MB; k is one row per
// head, broadcast over the tokens) and the u8 mask (0.33 MB): it is
// memory-bound at ~2.3 us on HBM (3.35 TB/s).
//
// Design (flash-decoding: one query a mask, many keys): the tokens split
// into spans of a multiple of 64, chosen by the wrapper so that the (span,
// head) blocks fill the card about twice; a block reads its span of k, v
// and the mask once and keeps, per (mask, head), the span's f32 max m_s,
// sum l_s and unnormalized accumulator acc_s in a workspace. A second
// launch from the same entry combines the spans in a fixed order, so the
// result is deterministic: out = sum_s e^{m_s - M} acc_s / max(sum_s
// e^{m_s - M} l_s, 1e-30). A span whose masks are all 0 for a row keeps m_s
// = -1e30 and l_s = its token count, so the uniform mean falls out of the
// same formula; spans are never empty. Tokens past a span's end score -inf
// inside the span (they belong to another span).
//
// bf16 (tensor cores): a block of up to eight warps, each owning a tile of
// 16 masks whose q fragments it keeps in registers; 64-token chunks of k
// and v (read in place through their strides: TextRegion's stride-0 k and
// head-transposed v) and of the mask stream through shared memory,
// double-buffered with cp.async. q . k runs on mma.sync m16n8k16 (f32 out,
// then times scale: the reference's (q * scale) . k up to f32 rounding), the
// softmax is online over the span's chunks, and p . v keeps the weights f32
// in effect: p_hi = bf16(p) and p_lo = bf16(p - p_hi) on two mma (B1's
// split). Rounding p once would be the XLA route's function
// (xla_masked_single_query_attention), not the Pallas kernel's. More than
// 128 masks take more blocks along the grid's third axis.
//
// float32 keeps the first design's FMA products inside the same split grid:
// a block of 256 threads per (span, head, 16 masks), 128-token tiles of k
// and v in shared memory as f32, thread t owning mask row t/16 and tokens
// t%16 + 16*j of each tile for the scores and columns t%16 + 16*c of the
// accumulator; the 16 lanes of a half-warp reduce a row's max and sum. The
// first design ran that over all L tokens in one block per (head, 16 masks):
// 96 blocks on 132 SMs, 0.455 ms at the path shape in bf16.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

// workspace of the split: per (span s, head h, mask m) the span's max, sum
// and accumulator, at m_s[(s * H + h) * M + m], l_s[...], acc_s[(... ) * hd]
struct Partials {
  float* m;
  float* l;
  float* acc;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int P_WARPS = 8;     // warps a block at most: 128 masks
constexpr int KC = 64;         // tokens a chunk
constexpr int MLD = KC + 16;   // mask row stride in shared memory (bytes)

// w bytes (16, 8 or 4) of a mask row -> shared memory, zeros when !ok; a
// single byte (w 1) is a plain load and store
__device__ __forceinline__ void copy_mask(uint8_t* dst, const uint8_t* src,
                                          bool ok, int w) {
  const uint32_t d = smem_addr(dst);
  switch (w) {
    case 16:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
      break;
    case 8:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   ::"r"(d), "l"(src), "r"(ok ? 8 : 0) : "memory");
      break;
    case 4:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
      break;
    default:
      *dst = ok ? *src : 0;
  }
}

template <int HD>
__global__ void __launch_bounds__(32 * P_WARPS)
pool_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                Partials ws, int M, int H, int L, long long k_sh,
                long long k_sl, long long v_sh, long long v_sl, float scale,
                int span, int vshift, int mvec) {
  constexpr int KT = HD / 16;
  constexpr int NT = HD / 8;
  constexpr int LDS = HD + 8;  // odd 16-byte units: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_warps = blockDim.x >> 5, rows_b = 16 * n_warps;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // 2 x KC x LDS
  bf16* v_s = k_s + 2 * KC * LDS;                   // 2 x KC x LDS
  // 2 x rows_b x MLD mask bytes
  uint8_t* mk_s = reinterpret_cast<uint8_t*>(v_s + 2 * KC * LDS);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int h = blockIdx.y;
  const int t_begin = blockIdx.x * span;
  const int t_end = min(L, t_begin + span);
  const int m_block = blockIdx.z * rows_b;
  const int m0 = m_block + 16 * warp;
  const bf16* kh = k + h * k_sh;
  const bf16* vh = v + h * v_sh;

  // q fragments straight from device memory: rows m0 + g (+ 8), columns
  // 16 kt + 2c (+ 8), zeros past M
  uint32_t qa[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = m0 + g + 8 * (r & 1);
      const int col = 16 * kt + 8 * (r >> 1) + 2 * c;
      qa[kt][r] = row < M ? *reinterpret_cast<const uint32_t*>(
                                q + ((long long)row * H + h) * HD + col)
                          : 0u;
    }

  const int n_chunks = (t_end - t_begin + KC - 1) / KC;
  auto chunk_rows = [&](int c0) {
    return min(KC, (t_end - c0 + 15) / 16 * 16);
  };
  auto fetch = [&](int i) {
    const int c0 = t_begin + i * KC, rows = chunk_rows(c0);
    bf16* kb = k_s + (i & 1) * KC * LDS;
    load_rows(kb, LDS, kh, k_sl, c0, rows, t_end, HD, vshift, tid,
              blockDim.x);
    load_rows(v_s + (i & 1) * KC * LDS, LDS, vh, v_sl, c0, rows, t_end, HD,
              vshift, tid, blockDim.x);
    uint8_t* mb = mk_s + (i & 1) * rows_b * MLD;
    const int per_row = KC / mvec;
    for (int j = tid; j < rows_b * per_row; j += blockDim.x) {
      const int r = j / per_row, col = (j - r * per_row) * mvec;
      const bool ok = m_block + r < M && c0 + col < L;
      copy_mask(mb + r * MLD + col,
                mask + (ok ? (long long)(m_block + r) * L + c0 + col : 0), ok,
                mvec);
    }
    cp_async_commit();
  };

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  fetch(0);
  for (int i = 0; i < n_chunks; ++i) {
    // chunk i has landed, and every warp is done with chunk i - 1, whose
    // buffers the next copies refill
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < n_chunks) fetch(i + 1);
    const int c0 = t_begin + i * KC;
    const int nj = chunk_rows(c0) / 8;  // n8 token tiles, even
    const bf16* kbuf = k_s + (i & 1) * KC * LDS;
    const bf16* vbuf = v_s + (i & 1) * KC * LDS;
    const uint8_t* mrow = mk_s + (i & 1) * rows_b * MLD + (16 * warp + g) * MLD;

    float sc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        if (2 * jj < nj) {
          uint32_t kf[4];
          ldmatrix_x4(kf, kbuf + (16 * jj + b_row) * LDS + 16 * kt + b_col);
          mma_bf16(sc[2 * jj], qa[kt], kf[0], kf[1]);
          mma_bf16(sc[2 * jj + 1], qa[kt], kf[2], kf[3]);
        }
      }
    }
    // times scale; masked tokens at -1e30 (the reference's), tokens past
    // the span's end (or not computed) at -inf: they add nothing here
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1);
        if (j >= nj || c0 + col >= t_end)
          sc[j][e] = -INFINITY;
        else if (mrow[8 * (e >> 1) * MLD + col] == 0)
          sc[j][e] = -1e30f;
        else
          sc[j][e] *= scale;
      }

    // online softmax; rows g (hh = 0) and g + 8 (hh = 1) of the warp's 16.
    // Every chunk holds a token of the span, so the row max is finite.
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float alpha = expf(m[hh] - mx);
      m[hh] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[j][2 * hh] = expf(sc[j][2 * hh] - mx);
        sc[j][2 * hh + 1] = expf(sc[j][2 * hh + 1] - mx);
        rs += sc[j][2 * hh] + sc[j][2 * hh + 1];
      }
      // this lane's share of the row sum; the quad's shares add at the end
      l[hh] = l[hh] * alpha + rs;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * hh] *= alpha;
        o[n][2 * hh + 1] *= alpha;
      }
    }

    // p . v over 16 tokens at a time, p = p_hi + p_lo
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk < nj) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float* pr = &sc[2 * kk + (r >> 1)][2 * (r & 1)];
          const __nv_bfloat162 hi = __floats2bfloat162_rn(pr[0], pr[1]);
          ph[r] = *reinterpret_cast<const uint32_t*>(&hi);
          pl[r] = pack_bf16(pr[0] - __low2float(hi), pr[1] - __high2float(hi));
        }
        const bf16* vrow = vbuf + (16 * kk + a_row) * LDS;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vrow + 16 * np + a_col);
          mma_bf16(o[2 * np], ph, vf[0], vf[1]);
          mma_bf16(o[2 * np], pl, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], ph, vf[2], vf[3]);
          mma_bf16(o[2 * np + 1], pl, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = m0 + g + 8 * hh;
    if (row >= M) continue;
    const long long at = ((long long)blockIdx.x * H + h) * M + row;
    if (c == 0) {
      ws.m[at] = m[hh];
      ws.l[at] = l[hh];
    }
    float* acc = ws.acc + at * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(acc + 8 * n + 2 * c) =
          make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------------------
// float32: FMAs on the CUDA cores
// ---------------------------------------------------------------------------

constexpr int BM = 16;
constexpr int TL = 128;
constexpr int LDP = TL + 4;
constexpr int THREADS = 256;

template <int HD>
__global__ void __launch_bounds__(THREADS)
pool_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const uint8_t* __restrict__ mask,
                Partials ws, int M, int H, int L, long long k_sh,
                long long k_sl, long long v_sh, long long v_sl, float scale,
                int span) {
  constexpr int LD = HD + 1;
  constexpr int NC = HD / 16;
  constexpr int NT = TL / 16;
  extern __shared__ float smem[];
  float* q_s = smem;            // BM x HD
  float* k_s = q_s + BM * HD;   // TL x LD
  float* v_s = k_s + TL * LD;   // TL x HD
  float* p_s = v_s + TL * HD;   // BM x LDP

  const int h = blockIdx.y;
  const int t_begin = blockIdx.x * span;
  const int t_end = min(L, t_begin + span);
  const int m0 = blockIdx.z * BM;
  const int tid = threadIdx.x;
  const int mi = tid >> 4;
  const int cl = tid & 15;
  const int m = m0 + mi;
  const bool row_ok = m < M;
  const float* kh = k + h * k_sh;
  const float* vh = v + h * v_sh;

  for (int i = tid; i < BM * HD; i += THREADS) {
    const int r = i / HD, d = i % HD;
    q_s[i] = (m0 + r < M) ? q[((long long)(m0 + r) * H + h) * HD + d] * scale
                          : 0.f;
  }

  float m_run = -INFINITY, l_run = 0.f, acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;

  for (int t0 = t_begin; t0 < t_end; t0 += TL) {
    __syncthreads();
    for (int i = tid; i < TL * HD; i += THREADS) {
      const int r = i / HD, d = i % HD, t = t0 + r;
      float kv = 0.f, vv = 0.f;
      if (t < t_end) {
        kv = kh[t * k_sl + d];
        vv = vh[t * v_sl + d];
      }
      k_s[r * LD + d] = kv;
      v_s[r * HD + d] = vv;
    }
    __syncthreads();

    float s[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qa = q_s[mi * HD + d];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        s[j] = fmaf(qa, k_s[(cl + 16 * j) * LD + d], s[j]);
    }

    float mx = m_run;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int t = t0 + cl + 16 * j;
      if (t >= t_end) {
        s[j] = -INFINITY;  // past the span's end: excluded, p = 0
      } else if (!row_ok || mask[(long long)m * L + t] == 0) {
        s[j] = -1e30f;
      }
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float alpha = expf(m_run - mx);
    float rsum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float p = expf(s[j] - mx);
      rsum += p;
      p_s[mi * LDP + cl + 16 * j] = p;
    }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
    l_run = l_run * alpha + rsum;
    m_run = mx;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] *= alpha;
    __syncthreads();

#pragma unroll 4
    for (int tt = 0; tt < TL; ++tt) {
      const float pa = p_s[mi * LDP + tt];
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = fmaf(pa, v_s[tt * HD + cl + 16 * c], acc[c]);
    }
  }

  if (!row_ok) return;
  const long long at = ((long long)blockIdx.x * H + h) * M + m;
  if (cl == 0) {
    ws.m[at] = m_run;
    ws.l[at] = l_run;
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) ws.acc[at * HD + cl + 16 * c] = acc[c];
}

// ---------------------------------------------------------------------------
// the spans' combine, in span order
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store(T* p, float x);
template <>
__device__ __forceinline__ void store<float>(float* p, float x) { *p = x; }
template <>
__device__ __forceinline__ void store<bf16>(bf16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(256)
pool_combine_kernel(Partials ws, T* __restrict__ out, int M, int H, int hd,
                    int n_spans) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * H * hd) return;
  const int d = i % hd;
  const int mh = i / hd, h = mh % H, m = mh / H;
  const long long stride = (long long)H * M;
  const long long at0 = (long long)h * M + m;
  float mx = -INFINITY;
  for (int s = 0; s < n_spans; ++s) mx = fmaxf(mx, ws.m[at0 + s * stride]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < n_spans; ++s) {
    const long long at = at0 + s * stride;
    const float w = expf(ws.m[at] - mx);
    den += w * ws.l[at];
    num += w * ws.acc[at * hd + d];
  }
  store<T>(out + i, num / fmaxf(den, 1e-30f));
}

template <int HD>
cudaError_t launch_pool(const void* q, const void* k, const void* v,
                        const uint8_t* mask, void* out, const Partials& ws,
                        int M, int H, int L, long long k_sh, long long k_sl,
                        long long v_sh, long long v_sl, float scale, int span,
                        int dtype, cudaStream_t stream) {
  const int n_spans = (L + span - 1) / span;
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem =
        sizeof(float) * (BM * HD + TL * (HD + 1) + TL * HD + BM * LDP);
    err = cudaFuncSetAttribute(pool_fma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(n_spans, H, (M + BM - 1) / BM);
    pool_fma_kernel<HD><<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), mask, ws, M, H, L, k_sh, k_sl, v_sh,
        v_sl, scale, span);
  } else {
    constexpr int LDS = HD + 8;
    const int tiles = (M + 15) / 16;
    const int n_warps = tiles < P_WARPS ? tiles : P_WARPS;
    const size_t smem =
        sizeof(bf16) * 4 * KC * LDS + (size_t)2 * 16 * n_warps * MLD;
    const void* ptrs[2] = {k, v};
    const long long strides[4] = {k_sh, k_sl, v_sh, v_sl};
    const int vshift = vector_shift(ptrs, 2, strides, 4, HD);
    // the widest mask copy that every row start allows
    int mvec = 16;
    while (mvec > 1 && (L % mvec != 0 ||
                        reinterpret_cast<uintptr_t>(mask) % mvec != 0))
      mvec = mvec == 4 ? 1 : mvec / 2;
    err = cudaFuncSetAttribute(pool_mma_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    dim3 grid(n_spans, H, (tiles + n_warps - 1) / n_warps);
    pool_mma_kernel<HD><<<grid, 32 * n_warps, smem, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), mask, ws, M, H, L, k_sh, k_sl, v_sh,
        v_sl, scale, span, vshift, mvec);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)M * H * HD;
  const unsigned blocks = (unsigned)((n + 255) / 256);
  if (dtype == 0)
    pool_combine_kernel<float><<<blocks, 256, 0, stream>>>(
        ws, static_cast<float*>(out), M, H, HD, n_spans);
  else
    pool_combine_kernel<bf16><<<blocks, 256, 0, stream>>>(
        ws, static_cast<bf16*>(out), M, H, HD, n_spans);
  return cudaGetLastError();
}

}  // namespace

// q, out: (M, H, hd) contiguous; k, v: (H, L, hd) with unit stride on hd and
// the given head / token strides in elements (0 allowed); mask: (M, L) u8;
// ws: f32 workspace of n_spans * H * M * (hd + 2) values, n_spans =
// ceil(L / span), span a positive multiple of 64. dtype: 0 = float32,
// 1 = bfloat16. Two launches, the spans then their combine. Returns the
// cudaError_t of the launches.
extern "C" int ovo_masked_pool(const void* q, const void* k, const void* v,
                               const void* mask, void* out, void* ws, int M,
                               int H, int L, int hd, long long k_sh,
                               long long k_sl, long long v_sh, long long v_sl,
                               float scale, int span, int dtype,
                               void* stream) {
  if (M < 1 || H < 1 || L < 1 || span < 1 || span % 64 != 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long n_spans = (L + span - 1) / span;
  float* w = static_cast<float*>(ws);
  const Partials parts{w, w + n_spans * H * M, w + 2 * n_spans * H * M};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
#define OVO_POOL_HD(N)                                                      \
  case N:                                                                   \
    return (int)launch_pool<N>(q, k, v, mk, out, parts, M, H, L, k_sh, k_sl, \
                               v_sh, v_sl, scale, span, dtype, st);
  switch (hd) {
    OVO_POOL_HD(16) OVO_POOL_HD(32) OVO_POOL_HD(48) OVO_POOL_HD(64)
    OVO_POOL_HD(80) OVO_POOL_HD(96) OVO_POOL_HD(112) OVO_POOL_HD(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef OVO_POOL_HD
}
