// Small-head cross attention on pre-projected operands: the SAM decoder's
// token <-> image attention on its unfused route (heads of 16).
//
// Replaces: ovo_tpu/ops/attention.py cross_attention_small_head ->
// _crossq_call / _crossq_kernel (t2i, entry ovo_cross_small_head_t2i) and
// _crossk_call / _crossk_kernel (i2t, entry ovo_cross_small_head_i2t),
// Pallas TPU kernels. The TPU kernels expand the short side block-diagonally
// so that 16-wide heads fill 128 lanes; the expansion only adds exact zeros,
// and here each head is indexed directly.
//
// What they compute, per prompt b and head h (dh = 16, D = heads * dh), in
// the reference's types: s = q_h . k_h * scale in f32; p = softmax(s) in
// f32, normalized, then rounded to the dtype; out_h = sum p v_h in f32,
// rounded once.
//   t2i: q (T tokens) x k, v (L image rows): the softmax runs over L.
//   i2t: q (L image rows) x k, v (T tokens): the softmax runs over the
//        tokens t < t_len (t >= t_len at -1e30, as the TPU kernel's pad).
//
// What bounds them on an H100: bytes. At the 1280^2 AMG shape (256
// prompts, 8 heads x 8 tokens, L = 6400, D = 128, bf16), t2i with per-prompt
// k, v reads 839 MB (0.25 ms at 3.35 TB/s) for 6.7 GFLOP; i2t reads 420 MB
// of image rows and writes 420 MB (0.25 ms). The second pass t2i needs
// (below) reads k again: 1.26 GB, 0.376 ms.
//
// Design.
//  t2i in bf16 (t2i_mma_kernel, tensor cores): one block per (prompt, 16
//   tokens), one warp a head (heads x 32 threads). The softmax weights are
//   rounded after normalizing, as the reference does, so each row's max
//   and sum over all L image rows come first: the block makes two passes
//   over 64-row tiles of the prompt's image side, k alone in the first, k
//   and v in the second, through three buffers of shared memory as bf16
//   (cp.async, 16 bytes a copy where pointers and strides allow): two
//   tiles load while one is multiplied, behind one block barrier a tile.
//   A shared image side (batch 1) serves two prompts a block (a warp for
//   each head of each prompt), so every tile is read once for both (faster
//   than one prompt a block in a probe on an H100). Per-prompt sides keep
//   one prompt a block: two blocks an SM fill the card; splitting each
//   head's keys over two warps of a block (more warps an SM) was slower in
//   the same probe. The span split of B6 would add blocks, not warps an SM:
//   the grid already fills every SM to its shared memory. Scores are mma.sync
//   m16n8k16: A is the head's q (16 token rows; the decoder's 8 tokens fill
//   half of it, the other rows are zero and skipped after the product), B
//   the head's 16 columns of k (ldmatrix), one k-step. Pass 1 keeps each
//   row's running max and sum per lane and merges them over the row's four
//   lanes; pass 2 recomputes the scores, forms p = bf16(exp(s - m) / l)
//   straight into the A fragments of p . v (the score C fragments, lane for
//   lane, as B2 does) and accumulates p . v on mma.sync in f32 (v through
//   ldmatrix.trans). Half of each product is padding, which costs nothing
//   here: bytes bound the kernel, not the tensor cores.
//  t2i in f32 (t2i_kernel, FMAs; in bf16 the first design, 2.056 ms
//   per-prompt and 1.573 ms shared at the AMG shape): one block of 256
//   threads per (prompt, 64 rows r = h * T + t), the same two passes over
//   64-row tiles widened to f32 in shared memory; each thread owns one row
//   and 16 keys of a score tile, then one row and four output columns of
//   p . v, p passing through shared memory.
//  i2t in bf16 at up to 16 tokens and D <= 128 (small_i2t_mma_kernel,
//   tensor cores): the image-to-token tile B4 and B7 share
//   (cross_i2t_common.cuh) without their keys . kq half. A block of eight
//   warps (two blocks an SM) holds the prompt's k_tok and v_tok
//   block-diagonally in shared memory (row h * TP + t holds token t in head
//   h's columns); each warp takes 16 image rows at a time, its next tile's
//   q arriving by cp.async (16-byte copies where pointer and strides allow)
//   in one of its two buffers while the current one computes: S = q .
//   k_tok_bd^T, one mma step per head; the token softmax and p . v_tok_bd
//   on mma.sync (i2t_softmax_pv, shared with B4 and B7: p normalized, then
//   rounded); attn rounded once over the tile's q rows and stored in
//   16-byte copies. The row tiles spread evenly over the blocks of a
//   prompt. The SAM decoder's widths (D 128, 8 heads) are fixed at compile
//   time (8 or 16 score columns a head); other widths read D and heads at
//   run time.
//  i2t in f32, and in bf16 past 16 tokens or D 128 (i2t_kernel, FMAs; in
//   bf16 the first design, 1.081 ms per-prompt and 0.998 ms shared at the
//   AMG shape): one block per (prompt, 128 image rows); the prompt's tokens
//   sit in shared memory in f32. One thread per (image row, head), the
//   rows of one head on consecutive threads, so the token reads are
//   broadcasts: it loads its row's 16 q values, takes the token max and sum
//   in one online pass, then p rounded and p . v in a second, and writes
//   its 16 outputs (one 32-byte sector in bf16).
//  Batch-1 operands are read through a batch stride of 0: the (B, L, D)
//  broadcast of a shared image side is never formed.
#include "cross_i2t_common.cuh"

namespace {

constexpr int DH = 16;       // head size
constexpr int RB = 64;       // t2i: token rows per block
constexpr int BK = 64;       // t2i: image rows per tile
constexpr int LDP = BK + 1;  // t2i: p rows
constexpr int ROWS_I2T = 128;  // i2t_kernel: image rows per block
constexpr int SHORT_MAX = 64;  // tokens (the short side)
constexpr int DMAX = 256;      // D = heads * 16

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
template <>
__device__ __forceinline__ void store4<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ float dot16(const float (&q)[DH],
                                       const float* __restrict__ k) {
  const float4* k4 = reinterpret_cast<const float4*>(k);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < DH / 4; ++j)
    s = dot4(make_float4(q[4 * j], q[4 * j + 1], q[4 * j + 2], q[4 * j + 3]),
             k4[j], s);
  return s;
}

// (m, l) of an online softmax: fold in score s
__device__ __forceinline__ void online(float s, float& m, float& l) {
  const float mn = fmaxf(m, s);
  l = l * expf(m - mn) + expf(s - mn);
  m = mn;
}

// an image-side tile (BK rows of D) of one prompt into shared memory, f32
template <typename T>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src, int k0,
                                          int L, int D, int LDK) {
  const int D4 = D / 4;
  for (int i = threadIdx.x; i < BK * D4; i += THREADS) {
    const int r = i / D4, c = (i % D4) * 4;
    *reinterpret_cast<float4*>(dst + r * LDK + c) =
        k0 + r < L ? load4<T>(src + (long long)(k0 + r) * D + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
t2i_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int NT, int heads,
           int L, int D, float scale, long long q_sb, long long k_sb,
           long long v_sb) {
  const int LDK = D + 4;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // BK x LDK
  float* v_s = k_s + BK * LDK;                    // BK x LDK
  float* p_s = v_s + BK * LDK;                    // RB x LDP

  const int b = blockIdx.x;
  const int R = heads * NT;
  const int tid = threadIdx.x;
  const int rl = tid >> 2, sub = tid & 3;  // row in the block, key lane
  const int r = blockIdx.y * RB + rl;      // row r = h * NT + t
  const bool live = r < R;
  const int h = live ? r / NT : 0, t = live ? r % NT : 0;
  const T* kb = k + b * k_sb;
  const T* vb = v + b * v_sb;

  float qr[DH];
  {
    const T* qp = q + b * q_sb + (long long)t * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH; j += 4) {
      const float4 x = live ? load4<T>(qp + j) : make_float4(0.f, 0.f, 0.f,
                                                             0.f);
      qr[j] = x.x;
      qr[j + 1] = x.y;
      qr[j + 2] = x.z;
      qr[j + 3] = x.w;
    }
  }

  // pass 1: each row's max and sum over the L image rows
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_tile<T>(k_s, kb, k0, L, D, LDK);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BK / 4; ++i) {
      const int kk = sub + 4 * i;
      if (k0 + kk < L)
        online(dot16(qr, k_s + kk * LDK + h * DH) * scale, m, l);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo = __shfl_xor_sync(0xffffffffu, l, off);
    const float mn = fmaxf(m, mo);
    l = l * expf(m - mn) + lo * expf(mo - mn);
    m = mn;
  }

  // pass 2: p normalized and rounded, then p . v
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const int c0 = 4 * sub;  // this thread's output columns c0 .. c0 + 3
  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();
    load_tile<T>(k_s, kb, k0, L, D, LDK);
    load_tile<T>(v_s, vb, k0, L, D, LDK);
    __syncthreads();
#pragma unroll 4
    for (int i = 0; i < BK / 4; ++i) {
      const int kk = sub + 4 * i;
      float p = 0.f;
      if (k0 + kk < L) {
        const float s = dot16(qr, k_s + kk * LDK + h * DH) * scale;
        p = rnd<T>(expf(s - m) / l);
      }
      p_s[rl * LDP + kk] = p;
    }
    __syncthreads();
    const float* vcol = v_s + h * DH + c0;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const float p = p_s[rl * LDP + kk];
      const float4 x = *reinterpret_cast<const float4*>(vcol + kk * LDK);
      acc.x = fmaf(p, x.x, acc.x);
      acc.y = fmaf(p, x.y, acc.y);
      acc.z = fmaf(p, x.z, acc.z);
      acc.w = fmaf(p, x.w, acc.w);
    }
  }
  if (live)
    store4<T>(out + ((long long)b * NT + t) * D + h * DH + c0, acc);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
i2t_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out, int NT, int t_len,
           int heads, int L, int D, float scale, long long q_sb,
           long long t_sb) {
  extern __shared__ float4 smem4[];
  float* kt_s = reinterpret_cast<float*>(smem4);  // NT x D
  float* vt_s = kt_s + NT * D;                     // NT x D
  const int b = blockIdx.y;
  const int l0 = blockIdx.x * ROWS_I2T;
  const T* kb = k + b * t_sb;
  const T* vb = v + b * t_sb;
  for (int i = threadIdx.x; i < NT * D; i += THREADS) {
    kt_s[i] = to_f<T>(kb[i]);
    vt_s[i] = to_f<T>(vb[i]);
  }
  __syncthreads();

  const T* qb = q + b * q_sb;
  T* ob = out + (long long)b * L * D;
  for (int item = threadIdx.x; item < ROWS_I2T * heads;
       item += THREADS) {
    const int h = item / ROWS_I2T, l = l0 + item % ROWS_I2T;
    if (l >= L) continue;
    float qr[DH];
    const T* qp = qb + (long long)l * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH; j += 4) {
      const float4 x = load4<T>(qp + j);
      qr[j] = x.x;
      qr[j + 1] = x.y;
      qr[j + 2] = x.z;
      qr[j + 3] = x.w;
    }
    float m = -INFINITY, sum = 0.f;
    for (int t = 0; t < NT; ++t) {
      const float s =
          t < t_len ? dot16(qr, kt_s + t * D + h * DH) * scale : -1e30f;
      online(s, m, sum);
    }
    float a[DH];
#pragma unroll
    for (int j = 0; j < DH; ++j) a[j] = 0.f;
    for (int t = 0; t < NT; ++t) {
      const float s =
          t < t_len ? dot16(qr, kt_s + t * D + h * DH) * scale : -1e30f;
      const float p = rnd<T>(expf(s - m) / sum);
      const float4* v4 = reinterpret_cast<const float4*>(vt_s + t * D +
                                                         h * DH);
#pragma unroll
      for (int j = 0; j < DH / 4; ++j) {
        const float4 x = v4[j];
        a[4 * j] = fmaf(p, x.x, a[4 * j]);
        a[4 * j + 1] = fmaf(p, x.y, a[4 * j + 1]);
        a[4 * j + 2] = fmaf(p, x.z, a[4 * j + 2]);
        a[4 * j + 3] = fmaf(p, x.w, a[4 * j + 3]);
      }
    }
    T* op = ob + (long long)l * D + h * DH;
#pragma unroll
    for (int j = 0; j < DH; j += 4)
      store4<T>(op + j, make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]));
  }
}

// t2i in bf16 on the tensor cores (design in the header note). HALVES: 1
// when every token fits in rows 0-7 of the 16-row tile (T <= 8), else 2.
// PROMPTS prompts share a block, and each tile, when k and v are shared.
constexpr int KC = 64;     // image rows per tile
constexpr int STAGES = 3;  // tiles in shared memory: two in flight

template <int HALVES, int PROMPTS>
__global__ void __launch_bounds__(32 * DMAX / DH)
t2i_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ out, int B, int NT, int heads,
               int L, int D, float scale, long long q_sb, long long k_sb,
               long long v_sb, int vshift) {
  typedef __nv_bfloat16 bf;
  const int LDS = D + 8;  // an odd number of 16-byte units a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf* kv_s = reinterpret_cast<bf*>(smem_raw);  // STAGES x (k | v), KC x LDS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp % heads;
  const int g = lane >> 2, c = lane & 3;
  // PROMPTS > 1 only for shared k and v (batch strides 0)
  const int b = blockIdx.x * PROMPTS + warp / heads;
  const bool live = b < B;  // a warp past the last prompt only loads tiles
  const int t0 = 16 * blockIdx.y;
  const bf* kb = k + blockIdx.x * k_sb;
  const bf* vb = v + blockIdx.x * v_sb;

  // the head's q rows t0 .. t0 + 15 as an A fragment (zero past NT)
  uint32_t qa[4];
  {
    const bf* qb = q + (live ? b : 0) * q_sb + h * DH + 2 * c;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t0 + g + 8 * (r & 1);
      qa[r] = t < NT ? *reinterpret_cast<const uint32_t*>(
                           qb + (long long)t * D + 8 * (r >> 1))
                     : 0u;
    }
  }

  const int n_tiles = (L + KC - 1) / KC;
  const int steps = 2 * n_tiles;  // pass 1 (k), then pass 2 (k and v)
  auto issue = [&](int s) {
    const int pass2 = s >= n_tiles;
    const int r0 = (s - pass2 * n_tiles) * KC;
    bf* kbuf = kv_s + (s % STAGES) * 2 * KC * LDS;
    load_rows(kbuf, LDS, kb, D, r0, KC, L, D, vshift, tid, blockDim.x);
    if (pass2)
      load_rows(kbuf + KC * LDS, LDS, vb, D, r0, KC, L, D, vshift, tid,
                blockDim.x);
  };

  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  // rows g and g + 8: running max and sum over this lane's columns, merged
  // over the quad before pass 2
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2] = {0.f, 0.f};

  // one commit group per step, empty past the last, so that step s waits
  // for its own group with STAGES - 2 younger ones in flight
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    // tile s landed for every thread, and every warp is done with step
    // s - 1, whose buffer the next issue refills
    __syncthreads();
    if (s + STAGES - 1 < steps) issue(s + STAGES - 1);
    cp_async_commit();
    if (!live) continue;
    const int pass2 = s >= n_tiles;
    const int r0 = (s - pass2 * n_tiles) * KC;
    const bf* kbuf = kv_s + (s % STAGES) * 2 * KC * LDS;

    float sc[KC / 8][4];
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int jj = 0; jj < KC / 16; ++jj) {
      uint32_t kf[4];
      ldmatrix_x4(kf, kbuf + (16 * jj + b_row) * LDS + h * DH + b_col);
      mma_bf16(sc[2 * jj], qa, kf[0], kf[1]);
      mma_bf16(sc[2 * jj + 1], qa, kf[2], kf[3]);
    }
    const bool edge = r0 + KC > L;
#pragma unroll
    for (int j = 0; j < KC / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] *= scale;
        if (edge && r0 + 8 * j + 2 * c + (e & 1) >= L) sc[j][e] = -1e30f;
      }

    if (!pass2) {
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) {
        float mx = m[hh];
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
          mx = fmaxf(mx, fmaxf(sc[j][2 * hh], sc[j][2 * hh + 1]));
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < KC / 8; ++j)
          sum += expf(sc[j][2 * hh] - mx) + expf(sc[j][2 * hh + 1] - mx);
        l[hh] = l[hh] * expf(m[hh] - mx) + sum;
        m[hh] = mx;
      }
    } else {
      if (s == n_tiles) {
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
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
      const bf* vbuf = kbuf + KC * LDS;
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        uint32_t pa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int hh = r & 1;
          const float* pr = &sc[2 * kk + (r >> 1)][2 * hh];
          pa[r] = hh < HALVES
                      ? pack_bf16(div_by_sum(expf(pr[0] - m[hh]), l[hh], rl[hh]),
                                  div_by_sum(expf(pr[1] - m[hh]), l[hh], rl[hh]))
                      : 0u;
        }
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vbuf + (16 * kk + a_row) * LDS + h * DH + a_col);
        mma_bf16(o[0], pa, vf[0], vf[1]);
        mma_bf16(o[1], pa, vf[2], vf[3]);
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) {
    const int t = t0 + g + 8 * hh;
    if (t >= NT) continue;
    bf* orow = out + ((long long)b * NT + t) * D + h * DH + 2 * c;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * hh], o[n][2 * hh + 1]);
  }
}

template <int PROMPTS>
cudaError_t launch_t2i_mma(const void* q, const void* k, const void* v,
                           void* out, int B, int NT, int heads, int L, int D,
                           float scale, long long q_sb, long long k_sb,
                           long long v_sb, cudaStream_t s) {
  typedef __nv_bfloat16 bf;
  const size_t smem = sizeof(bf) * STAGES * 2 * KC * (D + 8);
  const void* ptrs[2] = {k, v};
  const long long strides[3] = {k_sb, v_sb, D};
  const int vshift = vector_shift(ptrs, 2, strides, 3, D);
  dim3 grid((B + PROMPTS - 1) / PROMPTS, (NT + 15) / 16);
  auto kernel = NT <= 8 ? t2i_mma_kernel<1, PROMPTS>
                        : t2i_mma_kernel<2, PROMPTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, 32 * heads * PROMPTS, smem, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<bf*>(out), B, NT, heads, L, D,
      scale, q_sb, k_sb, v_sb, vshift);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// i2t in bf16 on the tensor cores (design in the header note)
// ---------------------------------------------------------------------------

constexpr int I2T_WARPS = 8;   // warps a block: two blocks an SM
constexpr int I2T_TILES = 8;   // 16-row tiles a warp takes in a block, at most
constexpr int LDQ = DPAD + 8;  // rows of the tokens, q and attn in shared
                               // memory: an odd number of 16-byte units

struct SmallI2tArgs : I2tArgs {
  const bf16* q;  // (B or 1, L, D)
  bf16* out;      // (B, L, D)
  long long qb;   // q's batch stride (0: shared)
  int vs_q;       // copy width (vector_shift) of q's rows
  int tiles;      // 16-row tiles a block takes
};

// i2t takes the tensor cores in bf16 at the shared tile's widths (at most
// 16 tokens, D <= 128), i2t_kernel otherwise
bool i2t_takes_mma(int NT, int D, int dtype) {
  return dtype == 1 && NT <= 16 && D <= DPAD;
}

// the prompt's k_tok and v_tok, block-diagonal, into shared memory in the
// layout i2t_stage_tokens builds (row h * TP + t holds token t in head h's
// 16 columns, zeros elsewhere), in 4-byte copies
template <int TP, int RP>
__device__ __forceinline__ void stage_small_tokens(const SmallI2tArgs& a,
                                                   int b, bf16* kb_s,
                                                   bf16* vb_s) {
  const int tid = threadIdx.x;
  const uint4 zero = {0u, 0u, 0u, 0u};
  for (int i = tid; i < RP * LDQ / 8; i += blockDim.x) {
    reinterpret_cast<uint4*>(kb_s)[i] = zero;
    reinterpret_cast<uint4*>(vb_s)[i] = zero;
  }
  __syncthreads();
  const bf16* ktb = a.kt + b * a.t_sb;
  const bf16* vtb = a.vt + b * a.t_sb;
  const int pairs = a.D / 2;  // 4-byte copies a token row takes
  for (int i = tid; i < a.NT * pairs; i += blockDim.x) {
    const int t = i / pairs, col = 2 * (i - t * pairs);
    const int r = ((col / DH) * TP + t) * LDQ + col;
    *reinterpret_cast<uint32_t*>(kb_s + r) =
        *reinterpret_cast<const uint32_t*>(ktb + t * a.D + col);
    *reinterpret_cast<uint32_t*>(vb_s + r) =
        *reinterpret_cast<const uint32_t*>(vtb + t * a.D + col);
  }
}

// TP, RP: as i2t_softmax_pv's (cross_i2t_common.cuh); DC, HC: D and heads
// fixed at compile time (0: read at run time)
template <int TP, int RP, int DC, int HC>
__global__ void __launch_bounds__(32 * I2T_WARPS, 2)
small_i2t_mma_kernel(SmallI2tArgs a) {
  constexpr int NS = RP / 8;    // n8 score tiles
  constexpr int ND = DPAD / 8;  // n8 attention tiles
  const int D = DC ? DC : a.D, heads = HC ? HC : a.heads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kb_s = reinterpret_cast<bf16*>(smem_raw);  // RP x LDQ, k_tok
  bf16* vb_s = kb_s + RP * LDQ;                    // RP x LDQ, v_tok
  bf16* q_s = vb_s + RP * LDQ;  // I2T_WARPS x 2 x 16 x LDQ: q, then attn

  const int b = blockIdx.y, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const int b_row = (lane & 7) + 8 * (lane >> 4), b_col = 8 * ((lane >> 3) & 1);
  stage_small_tokens<TP, RP>(a, b, kb_s, vb_s);
  __syncthreads();

  // the warp's tiles, each through one of its two buffers while the next
  // one loads into the other
  const bf16* qb = a.q + b * a.qb;
  const int t_end = min((a.L + 15) / 16, (blockIdx.x + 1) * a.tiles);
  bf16* buf = q_s + warp * 2 * 16 * LDQ;
  int tile = blockIdx.x * a.tiles + warp;
  if (tile < t_end)
    load_rows(buf, LDQ, qb, D, 16 * tile, 16, a.L, D, a.vs_q, lane, 32);
  cp_async_commit();
  const int per_row = D / 8;  // 16-byte copies a row of out takes
  for (int i = 0; tile < t_end; ++i, tile += I2T_WARPS) {
    bf16* cur = buf + (i & 1) * 16 * LDQ;
    if (tile + I2T_WARPS < t_end)
      load_rows(buf + ((i + 1) & 1) * 16 * LDQ, LDQ, qb, D,
                16 * (tile + I2T_WARPS), 16, a.L, D, a.vs_q, lane, 32);
    cp_async_commit();
    cp_async_wait<1>();
    __syncwarp();

    // S (16 x RP) = q . k_tok_bd^T: head h's 16 columns of q against the
    // score columns of its tokens, one mma step each (the zero blocks of
    // k_tok_bd skipped)
    float S[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n) S[n][0] = S[n][1] = S[n][2] = S[n][3] = 0.f;
#pragma unroll
    for (int h = 0; h < DPAD / DH; ++h) {
      if (h >= heads) break;
      uint32_t qa[4];
      ldmatrix_x4(qa, cur + a_row * LDQ + DH * h + a_col);
#pragma unroll
      for (int jj = 0; jj < NS / 2; ++jj) {
        if (16 * jj + 16 <= h * TP || 16 * jj >= (h + 1) * TP) continue;
        uint32_t kf[4];
        ldmatrix_x4(kf, kb_s + (16 * jj + b_row) * LDQ + DH * h + b_col);
        mma_bf16(S[2 * jj], qa, kf[0], kf[1]);
        mma_bf16(S[2 * jj + 1], qa, kf[2], kf[3]);
      }
    }
    float at[ND][4];
    i2t_softmax_pv<TP, RP, DC, HC>(a, S, vb_s, at);

    // attn rounded once (the reference's astype) over the q rows every
    // lane has read, then out in 16-byte copies
    __syncwarp();
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (8 * n >= D) break;
      const int col = 8 * n + 2 * c;
      *reinterpret_cast<uint32_t*>(cur + g * LDQ + col) =
          pack_bf16(at[n][0], at[n][1]);
      *reinterpret_cast<uint32_t*>(cur + (g + 8) * LDQ + col) =
          pack_bf16(at[n][2], at[n][3]);
    }
    __syncwarp();
    bf16* ob = a.out + ((size_t)b * a.L + 16 * tile) * D;
    for (int j = lane; j < 16 * per_row; j += 32) {
      const int r = j / per_row, col = 8 * (j - r * per_row);
      if (16 * tile + r >= a.L) break;
      *reinterpret_cast<uint4*>(ob + (size_t)r * D + col) =
          *reinterpret_cast<const uint4*>(cur + r * LDQ + col);
    }
    __syncwarp();  // cur is refilled next
  }
}

template <int TP, int RP, int DC, int HC>
cudaError_t launch_small_i2t(const SmallI2tArgs& a, int B, int blocks,
                             cudaStream_t s) {
  // 102 KB at RP 64 (two blocks an SM), 136 KB at RP 128
  const size_t smem = sizeof(bf16) * ((size_t)2 * RP * LDQ +
                                      (size_t)I2T_WARPS * 2 * 16 * LDQ);
  auto kernel = small_i2t_mma_kernel<TP, RP, DC, HC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(blocks, B), 32 * I2T_WARPS, smem, s>>>(a);
  return cudaGetLastError();
}

// i2t in bf16 on the tensor cores: the SAM decoder's widths (D 128, 8
// heads) fixed at compile time, 8 or 16 token columns a head; other widths
// (D <= 128) at 16 and run-time D and heads
cudaError_t small_i2t_mma(const void* q, const void* k, const void* v,
                          void* out, int B, int NT, int t_len, int heads,
                          int L, int D, float scale, long long q_sb,
                          long long t_sb, cudaStream_t s) {
  SmallI2tArgs a = {};
  a.kt = static_cast<const bf16*>(k);
  a.vt = static_cast<const bf16*>(v);
  a.NT = NT;
  a.heads = heads;
  a.t_len = t_len;
  a.L = L;
  a.D = D;
  a.scale = scale;
  a.t_sb = t_sb;
  a.q = static_cast<const bf16*>(q);
  a.out = static_cast<bf16*>(out);
  a.qb = q_sb;
  const long long sq[2] = {D, q_sb};
  a.vs_q = vector_shift(&q, 1, sq, 2, D);
  // the row tiles spread evenly over the fewest blocks of at most
  // I2T_WARPS x I2T_TILES tiles
  const int n_tiles = (L + 15) / 16;
  const int blocks = (n_tiles + I2T_WARPS * I2T_TILES - 1) /
                     (I2T_WARPS * I2T_TILES);
  a.tiles = (n_tiles + blocks - 1) / blocks;
  if (D == 128 && heads == 8)
    return NT <= 8 ? launch_small_i2t<8, 64, 128, 8>(a, B, blocks, s)
                   : launch_small_i2t<16, 128, 128, 8>(a, B, blocks, s);
  return launch_small_i2t<16, 128, 0, 0>(a, B, blocks, s);
}

bool bad_shape(int B, int NT, int heads, int L, int D) {
  return B < 1 || NT < 1 || NT > SHORT_MAX || heads < 1 || L < 1 ||
         D != heads * DH || D > DMAX;
}

}  // namespace

// t2i: q (B or 1, NT, D) at q_sb elements per batch (0 = shared), k and v
// (B or 1, L, D) at k_sb / v_sb; out (B, NT, D). D = heads * 16 <= 256,
// NT <= 64, 16-byte aligned pointers. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int ovo_cross_small_head_t2i(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int NT, int heads, int L, int D,
                                        float scale, long long q_sb,
                                        long long k_sb, long long v_sb,
                                        int dtype, void* stream) {
  if (bad_shape(B, NT, heads, L, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const size_t smem = sizeof(float) * (2 * BK * (D + 4) + RB * LDP);
    dim3 grid(B, (heads * NT + RB - 1) / RB);
    err = cudaFuncSetAttribute(t2i_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    t2i_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), NT, heads, L,
        D, scale, q_sb, k_sb, v_sb);
  } else if (dtype == 1) {
    // a shared image side: two prompts a block read each tile once
    if (k_sb == 0 && v_sb == 0 && 2 * heads <= DMAX / DH)
      return (int)launch_t2i_mma<2>(q, k, v, out, B, NT, heads, L, D, scale,
                                    q_sb, k_sb, v_sb, s);
    return (int)launch_t2i_mma<1>(q, k, v, out, B, NT, heads, L, D, scale,
                                  q_sb, k_sb, v_sb, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// i2t: q (B or 1, L, D) at q_sb; k and v (B or 1, NT, D) at t_sb; out (B, L,
// D). Tokens t >= t_len are masked. Limits as t2i. bf16 with NT <= 16 and
// D <= 128 runs on the tensor cores (small_i2t_mma_kernel), other widths
// and f32 on i2t_kernel.
extern "C" int ovo_cross_small_head_i2t(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int NT, int t_len, int heads, int L,
                                        int D, float scale, long long q_sb,
                                        long long t_sb, int dtype,
                                        void* stream) {
  if (bad_shape(B, NT, heads, L, D) || t_len < 1 || t_len > NT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (i2t_takes_mma(NT, D, dtype))
    return (int)small_i2t_mma(q, k, v, out, B, NT, t_len, heads, L, D, scale,
                              q_sb, t_sb, s);
  const size_t smem = sizeof(float) * 2 * NT * D;
  dim3 grid((L + ROWS_I2T - 1) / ROWS_I2T, B);
  cudaError_t err;
  if (dtype == 0) {
    err = cudaFuncSetAttribute(i2t_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    i2t_kernel<float><<<grid, THREADS, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), NT, t_len,
        heads, L, D, scale, q_sb, t_sb);
  } else if (dtype == 1) {
    err = cudaFuncSetAttribute(i2t_kernel<bf16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    i2t_kernel<bf16><<<grid, THREADS, smem, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), NT, t_len,
        heads, L, D, scale, q_sb, t_sb);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
