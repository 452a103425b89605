// Two-pass softmax attention on the tensor cores (bf16 mma.sync), shared by
// B5 (rope_packed_attention.cu: the rotated q and k of its workspace, v read
// in place from the packed projection) and B12a (fused_attn_block.cu: q, k
// and v read in place from its packed [q | k | v] buffer).
//
// What it computes, per (view b, head h), for q, k and v given as head
// columns [h*HD, (h+1)*HD) of row-major (B, L, *) bf16 matrices:
//   s   = (q . k) in f32, times scale, keys at or past kv_len at -1e30;
//   p   = exp(s - m) / l with the row's max m and sum l, rounded to bf16
//         (normalized, then rounded: the reference's rounding point);
//   out = p . v in f32, rounded once, written token-major to out (B, L, D)
//         at columns [h*HD, (h+1)*HD).
//
// Design: one block of eight warps per (view * head, 128-query tile); each
// warp owns 16 query rows, whose q fragments it keeps in registers. 64-key
// chunks of k, and in pass 2 of v, stream through shared memory,
// double-buffered with 16-byte cp.async copies (8, 4 or 2 bytes where a
// pointer or stride is not aligned). Pass 1 computes q . k on mma.sync
// m16n8k16 (f32 accumulators, then times scale) and each lane's running
// max and sum; pass 2 computes q . k again and p . v with p = bf16(exp(s -
// m) / l). Keys at or past kv_len are zero rows at -1e30; chunk rows past
// kv_len round up to 16, so at the PE shape (577 keys) the last chunk is one
// 16-row step with one valid key. The head size is a template argument
// (every multiple of 16 up to 128), so the unrolled loops carry no run-time
// guards. At the PE shape the 560 blocks fill the 132 SMs (two blocks an
// SM) 2.1 times.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int TP_WARPS = 8;
constexpr int TP_THREADS = 32 * TP_WARPS;
constexpr int TP_ROWS = 16 * TP_WARPS;  // query rows a block
constexpr int TP_KC = 64;               // keys a chunk

// HD: the head size (a multiple of 16). q, k: row stride ld_qk; v: row
// stride ld_v; the view b starts at row b * L of each.
template <int HD>
__global__ void __launch_bounds__(TP_THREADS, HD > 64 ? 1 : 2)
two_pass_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, long long ld_qk,
                    long long ld_v, bf16* __restrict__ out, int L, int D,
                    int heads, int kv_len, float scale, int vshift) {
  constexpr int KT = HD / 16;
  constexpr int NT = HD / 8;
  constexpr int LDS = HD + 8;  // odd 16-byte units: no bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // TP_ROWS x LDS
  bf16* k_s = q_s + TP_ROWS * LDS;                  // 2 x TP_KC x LDS
  bf16* v_s = k_s + 2 * TP_KC * LDS;                // 2 x TP_KC x LDS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q_base = TP_ROWS * blockIdx.x;
  const int row0 = q_base + 16 * warp;
  const bool rows_here = row0 < L;
  const bf16* qb = q + (long long)b * L * ld_qk + h * HD;
  const bf16* kb = k + (long long)b * L * ld_qk + h * HD;
  const bf16* vb = v + (long long)b * L * ld_v + h * HD;

  // steps: pass 1 over the chunks (k), then pass 2 (k and v)
  const int n_chunks = (kv_len + TP_KC - 1) / TP_KC;
  const int steps = 2 * n_chunks;
  // the last chunk holds the keys left, rounded up to 16
  auto chunk_rows = [&](int c0) {
    return min(TP_KC, (kv_len - c0 + 15) / 16 * 16);
  };
  auto fetch = [&](int s) {
    const bool pass2 = s >= n_chunks;
    const int c0 = (s - (pass2 ? n_chunks : 0)) * TP_KC;
    const int rows = chunk_rows(c0);
    load_rows(k_s + (s & 1) * TP_KC * LDS, LDS, kb, ld_qk, c0, rows, kv_len,
              HD, vshift, tid, TP_THREADS);
    if (pass2)
      load_rows(v_s + (s & 1) * TP_KC * LDS, LDS, vb, ld_v, c0, rows, kv_len,
                HD, vshift, tid, TP_THREADS);
    cp_async_commit();
  };

  load_rows(q_s, LDS, qb, ld_qk, q_base, TP_ROWS, L, HD, vshift, tid,
            TP_THREADS);
  fetch(0);

  uint32_t qa[KT][4];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // pass 1 keeps each lane's running max and sum over its own columns; the
  // quad that shares a row combines them before pass 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);

  for (int s = 0; s < steps; ++s) {
    // step s's copies have landed, and every warp is done with step s - 1,
    // whose buffers the next copies refill
    cp_async_wait<0>();
    __syncthreads();
    if (s + 1 < steps) fetch(s + 1);
    const bool pass2 = s >= n_chunks;
    const int c0 = (s - (pass2 ? n_chunks : 0)) * TP_KC;
    const int nj = chunk_rows(c0) / 8;  // n8 key tiles, even
    const bf16* kbuf = k_s + (s & 1) * TP_KC * LDS;
    if (s == 0) {
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        ldmatrix_x4(qa[kt], q_s + (16 * warp + a_row) * LDS + 16 * kt + a_col);
    }
    if (!rows_here) continue;

    // scores of the warp's 16 rows against the chunk's keys, times scale;
    // keys at or past kv_len at -1e30
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
    const bool edge = c0 + 8 * nj > kv_len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] *= scale;
        if (edge && c0 + 8 * j + 2 * c + (e & 1) >= kv_len) sc[j][e] = -1e30f;
      }

    if (!pass2) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < nj) mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j < nj)
            sum += expf(sc[j][2 * hh] - mx) + expf(sc[j][2 * hh + 1] - mx);
        l[hh] = l[hh] * expf(m[hh] - mx) + sum;
        m[hh] = mx;
      }
      continue;
    }
    if (s == n_chunks) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        float sum = l[hh] * expf(m[hh] - mx);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        m[hh] = mx;
        l[hh] = sum;
        rl[hh] = 1.f / sum;
      }
    }
    // the reference's rounding point: normalized, then rounded
    const bf16* vbuf = v_s + (s & 1) * TP_KC * LDS;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (2 * kk < nj) {
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hh = r & 1;
          const float* pr = &sc[2 * kk + (r >> 1)][2 * hh];
          pa[r] = pack_bf16(div_by_sum(expf(pr[0] - m[hh]), l[hh], rl[hh]),
                            div_by_sum(expf(pr[1] - m[hh]), l[hh], rl[hh]));
        }
        const bf16* vrow = vbuf + (16 * kk + a_row) * LDS;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vf[4];
          ldmatrix_x4_trans(vf, vrow + 16 * np + a_col);
          mma_bf16(o[2 * np], pa, vf[0], vf[1]);
          mma_bf16(o[2 * np + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  if (!rows_here) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + 8 * hh;
    if (row >= L) continue;
    bf16* orow = out + ((long long)b * L + row) * D + h * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * c) =
          __floats2bfloat162_rn(o[n][2 * hh], o[n][2 * hh + 1]);
  }
}

// One launch of two_pass_mma_kernel<HD> over B views of L tokens: q and k
// with row stride ld_qk, v with ld_v, out (B, L, D) with D = heads * HD.
template <int HD>
cudaError_t launch_two_pass(const bf16* q, const bf16* k, const bf16* v,
                            long long ld_qk, long long ld_v, bf16* out,
                            int B, int L, int D, int heads, int kv_len,
                            float scale, cudaStream_t stream) {
  constexpr int LDS = HD + 8;
  const size_t smem = sizeof(bf16) * (TP_ROWS + 4 * TP_KC) * LDS;
  const void* ptrs[3] = {q, k, v};
  const long long strides[2] = {ld_qk, ld_v};
  const int vshift = vector_shift(ptrs, 3, strides, 2, HD);
  cudaError_t err = cudaFuncSetAttribute(
      two_pass_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + TP_ROWS - 1) / TP_ROWS, B * heads);
  two_pass_mma_kernel<HD><<<grid, TP_THREADS, smem, stream>>>(
      q, k, v, ld_qk, ld_v, out, L, D, heads, kv_len, scale, vshift);
  return cudaGetLastError();
}

// the head sizes the kernel is instantiated for
cudaError_t dispatch_two_pass(int hd, const bf16* q, const bf16* k,
                              const bf16* v, long long ld_qk, long long ld_v,
                              bf16* out, int B, int L, int D, int heads,
                              int kv_len, float scale, cudaStream_t st) {
#define OVO_TWO_PASS_HD(N) \
  case N:                  \
    return launch_two_pass<N>(q, k, v, ld_qk, ld_v, out, B, L, D, heads, \
                              kv_len, scale, st);
  switch (hd) {
    OVO_TWO_PASS_HD(16) OVO_TWO_PASS_HD(32) OVO_TWO_PASS_HD(48)
    OVO_TWO_PASS_HD(64) OVO_TWO_PASS_HD(80) OVO_TWO_PASS_HD(96)
    OVO_TWO_PASS_HD(112) OVO_TWO_PASS_HD(128)
    default: return cudaErrorInvalidValue;
  }
#undef OVO_TWO_PASS_HD
}

}  // namespace
