// Image -> token cross attention with the image-side q projection folded
// in: the SAM decoder's image-to-token attention on its proj route (the
// out-projection and norm4 follow outside, norm4 through kernel B8).
//
// Replaces: ovo_tpu/ops/attention.py cross_i2t_from_keys -> _crossk_proj_call
// / _crossk_proj_kernel (a Pallas TPU kernel). It is kernel B4
// (csrc/cross_i2t_tail.cu) without the out-projection, residual and
// LayerNorm.
//
// What it computes (cross_i2t_common.cuh has it in full): per prompt and
// image row, softmax((keys Wq + pe_q) k_tok^T) v_tok per head, as
// softmax(kq . keys + k_tok . pe_q) with kq = k_tok Wq^T rounded, s in f32,
// p normalized then rounded, out = p v_tok in f32 rounded once; the (B, L,
// D) projection qq = keys Wq + pe_q is never formed.
//
// What bounds it on an H100: at the 1280^2 AMG shape (256 prompts, L =
// 6400, dk = 256, D = 128, 8 heads x 8 tokens, bf16) a launch reads 839 MB
// of per-prompt keys and writes 420 MB (0.38 ms at 3.35 TB/s) for ~57
// GFLOP, 54 of them kq . keys over dk (58 us at 989 TF/s): bytes.
//
// Design: two launches on the caller's stream. kq_kernel
// (cross_i2t_common.cuh) forms kq once per prompt; then, by dtype:
//
// bf16 (i2t_mma_kernel), on the tensor cores: B4's front half. A block of
// eight warps holds the prompt's kq and the block-diagonal k_tok and v_tok
// in shared memory (i2t_stage_tokens); each warp takes 16 image rows at a
// time through its own keys buffer (cp.async, 16-byte copies where pointer
// and strides allow) into i2t_attn_tile (S, the token softmax, p . v on
// mma.sync m16n8k16, shared with B4), then rounds attn, writes it over its
// keys rows and stores it in 16-byte copies. Without B4's Wout (64 KB) and
// its tail's registers, the block holds sixteen warps at the SAM decoder's
// widths (dk 256, D 128, 8 heads), which are fixed at compile time as B4's.
//
// float32 (i2t_kernel) keeps the first design, f32 FMAs on the CUDA cores
// (the first design ran bf16 too, at 3.729 ms with per-prompt keys and
// 3.614 shared at the path shape): one block of 256 threads per (prompt,
// 128 image rows); the prompt's kq (rows padded to dk+4) and tokens are
// loaded once, then four 32-row tiles stream through. Per tile, the (32
// rows x 64 kq rows) score product is register-tiled (each thread 2 rows x
// 4 kq rows, four elements per read); one thread per (row, head), the 32
// rows of a head on consecutive threads, adds the pe term, takes the token
// softmax and forms its dh outputs in place of the pe values it alone
// read; the tile is then written out row by row, consecutive threads on
// consecutive columns.
//
// Batch-1 keys (the first two-way layer) or tokens are read through a
// batch stride of 0.
#include "cross_i2t_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v);
template <>
__device__ __forceinline__ void store4<float>(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
i2t_kernel(const T* __restrict__ keys, const T* __restrict__ kq,
           const T* __restrict__ peq, const T* __restrict__ kt,
           const T* __restrict__ vt, T* __restrict__ out, int NT,
           int heads, int t_len, int L, int dk, int D, float scale,
           long long k_sb, long long t_sb, long long q_sb) {
  const int dh = D / heads, dh4 = dh / 4;
  const int R = heads * NT;  // kq row r = t * heads + h
  const int dk4 = dk / 4, D4 = D / 4;
  // kq rows padded to dk+4: the rows a quarter-warp (f32) or half-warp
  // (bf16) reads fall in distinct banks
  const int LDQ = dk + 4, LDK = dk + 4, LDE = D + 4;
  extern __shared__ float4 smem4[];
  T* kq_s = reinterpret_cast<T*>(smem4);                   // RMAX x LDQ
  float* ks_s = reinterpret_cast<float*>(kq_s + RMAX * LDQ);  // BL x LDK
  float* pe_s = ks_s + BL * LDK;  // BL x LDE: pe_q rows, then attn in place
  float* sc_s = pe_s + BL * LDE;  // BL x LDS
  float* kt_s = sc_s + BL * LDS;  // NT x D
  float* vt_s = kt_s + NT * D;    // NT x D

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const T* kb = keys + b * k_sb;
  const T* ktb = kt + b * t_sb;
  const T* vtb = vt + b * t_sb;
  const T* kqb = kq + b * q_sb;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i = tid; i < NT * D; i += THREADS) {
    kt_s[i] = to_f<T>(ktb[i]);
    vt_s[i] = to_f<T>(vtb[i]);
  }
  for (int i = tid; i < RMAX * dk4; i += THREADS) {
    const int r = i / dk4, c = (i % dk4) * 4;
    if (r < R) {
      copy4<T>(kq_s + r * LDQ + c, kqb + r * dk + c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) kq_s[r * LDQ + c + e] = from_f<T>(0.f);
    }
  }

  // score tile: rows lsel and lsel + 16, kq rows rsel + 16 i
  const int rsel = tid & 15, lsel = tid >> 4;
  T* ob = out + (long long)b * L * D;

  for (int tile = 0; tile < TILES; ++tile) {
    const int l0 = (blockIdx.x * TILES + tile) * BL;
    if (l0 >= L) break;
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < BL * dk4; i += THREADS) {
      const int r = i / dk4, cc = (i % dk4) * 4, l = l0 + r;
      *reinterpret_cast<float4*>(ks_s + r * LDK + cc) =
          l < L ? load4<T>(kb + (long long)l * dk + cc) : zero;
    }
    for (int i = tid; i < BL * D4; i += THREADS) {
      const int r = i / D4, cc = (i % D4) * 4, l = l0 + r;
      *reinterpret_cast<float4*>(pe_s + r * LDE + cc) =
          l < L ? load4<T>(peq + (long long)l * D + cc) : zero;
    }
    __syncthreads();

    // s = kq . keys for 32 rows x 64 kq rows
    {
      float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* k0p = reinterpret_cast<const float4*>(ks_s + lsel * LDK);
      const float4* k1p =
          reinterpret_cast<const float4*>(ks_s + (lsel + 16) * LDK);
      const T* qp = kq_s + rsel * LDQ;
#pragma unroll 4
      for (int d4 = 0; d4 < dk4; ++d4) {
        const float4 a0 = k0p[d4], a1 = k1p[d4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 w = load4<T>(qp + i * 16 * LDQ + 4 * d4);
          s0[i] = dot4(a0, w, s0[i]);
          s1[i] = dot4(a1, w, s1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sc_s[lsel * LDS + rsel + 16 * i] = s0[i];
        sc_s[(lsel + 16) * LDS + rsel + 16 * i] = s1[i];
      }
    }
    __syncthreads();

    // pe term, token softmax and attention, per (row, head); the rows of
    // one head are consecutive threads: the token rows are broadcasts and
    // the pe / score rows fall in distinct banks
    for (int pr = tid; pr < BL * heads; pr += THREADS) {
      const int l = pr % BL, h = pr / BL;
      const float4* pe4 = reinterpret_cast<const float4*>(
          pe_s + l * LDE + h * dh);
      float p[TMAX];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < TMAX; ++t) {
        if (t < NT) {
          const float4* k4 =
              reinterpret_cast<const float4*>(kt_s + t * D + h * dh);
          float e = 0.f;
          for (int j = 0; j < dh4; ++j) e = dot4(k4[j], pe4[j], e);
          const float sv = sc_s[l * LDS + t * heads + h];
          p[t] = t < t_len ? (sv + e) * scale : -1e30f;
          mx = fmaxf(mx, p[t]);
        }
      }
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < TMAX; ++t) {
        if (t < NT) {
          p[t] = expf(p[t] - mx);
          sum += p[t];
        }
      }
#pragma unroll
      for (int t = 0; t < TMAX; ++t)
        if (t < NT) p[t] = rnd<T>(p[t] / sum);
      // this thread alone read these pe values: attn takes their place
      float4* at4 = reinterpret_cast<float4*>(pe_s + l * LDE + h * dh);
      for (int j = 0; j < dh4; ++j) {
        float4 a = zero;
#pragma unroll
        for (int t = 0; t < TMAX; ++t) {
          if (t < NT) {
            const float4 v =
                reinterpret_cast<const float4*>(vt_s + t * D + h * dh)[j];
            a.x = fmaf(p[t], v.x, a.x);
            a.y = fmaf(p[t], v.y, a.y);
            a.z = fmaf(p[t], v.z, a.z);
            a.w = fmaf(p[t], v.w, a.w);
          }
        }
        at4[j] = make_float4(rnd<T>(a.x), rnd<T>(a.y), rnd<T>(a.z),
                             rnd<T>(a.w));
      }
    }
    __syncthreads();

    // the tile's attention rows, consecutive threads on consecutive columns
    for (int i = tid; i < BL * D4; i += THREADS) {
      const int r = i / D4, cc = (i % D4) * 4, l = l0 + r;
      if (l < L)
        store4<T>(ob + (long long)l * D + cc,
                  *reinterpret_cast<const float4*>(pe_s + r * LDE + cc));
    }
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

struct I2tProjArgs : I2tArgs {
  bf16* out;  // (B, L, D)
  int vs_o;   // copy width (vector_shift) of out's rows
};

// warps a block: sixteen at the SAM decoder's widths (124 registers a
// thread, 204 KB of shared memory), twice what B4 holds, to hide more of
// the keys' loads; eight at the generic widths (up to 206 registers)
template <int DKC>
__host__ __device__ constexpr int proj_warps() { return DKC ? 16 : 8; }

// TP, RP, DKC, DC, HC: as i2t_attn_tile's (cross_i2t_common.cuh)
template <int TP, int RP, int DKC, int DC, int HC>
__global__ void __launch_bounds__(32 * proj_warps<DKC>(), 1)
i2t_mma_kernel(I2tProjArgs a) {
  constexpr int ND = DPAD / 8;     // n8 attention tiles
  const int dk = DKC ? DKC : a.dk, D = DC ? DC : a.D;
  const int nw = blockDim.x >> 5;
  // a warp's buffer: its keys rows (stride LDK), then its attn rows
  // (stride LDO); both odd 16-byte units
  const int LDK = dk + 8, LDE = DPAD + 8, LDO = (D + 7) / 8 * 8 + 8;
  const int LDW = max(LDK, LDO);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kq_s = reinterpret_cast<bf16*>(smem_raw);  // RP x LDK
  bf16* kb_s = kq_s + RP * LDK;                    // RP x LDE, k_tok block-diag
  bf16* vb_s = kb_s + RP * LDE;                    // RP x LDE, v_tok block-diag
  bf16* ks_s = vb_s + RP * LDE;                    // nw x 16 x LDW

  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const bf16* kb = a.keys + b * a.k_sb;

  i2t_stage_tokens<TP, RP, DKC, DC, HC>(a, b, kq_s, kb_s, vb_s);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  bf16* ks_w = ks_s + warp * 16 * LDW;
  const int rows_per_block = nw * TPW * 16;
  const int per_row = D >> a.vs_o;  // copies a row of out takes
  for (int tile = 0; tile < TPW; ++tile) {
    const int l0 = blockIdx.x * rows_per_block + (tile * nw + warp) * 16;
    if (l0 >= a.L) break;
    load_rows(ks_w, LDK, kb, dk, l0, 16, a.L, dk, a.vs_k, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    float at[ND][4];
    i2t_attn_tile<TP, RP, DKC, DC, HC>(a, ks_w, kq_s, kb_s, vb_s, l0, at);
    // attn rounded once (the reference's astype), over the keys rows every
    // lane has read, then out in copies of 1 << vs_o elements
    __syncwarp();
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      if (8 * n >= D) break;
      const int col = 8 * n + 2 * c;
      *reinterpret_cast<uint32_t*>(ks_w + g * LDO + col) =
          pack_bf16(at[n][0], at[n][1]);
      *reinterpret_cast<uint32_t*>(ks_w + (g + 8) * LDO + col) =
          pack_bf16(at[n][2], at[n][3]);
    }
    __syncwarp();
    bf16* ob = a.out + ((size_t)b * a.L + l0) * D;
    for (int i = lane; i < 16 * per_row; i += 32) {
      const int r = i / per_row, col = (i - r * per_row) << a.vs_o;
      if (l0 + r >= a.L) break;
      if (a.vs_o == 3)
        *reinterpret_cast<uint4*>(ob + (size_t)r * D + col) =
            *reinterpret_cast<const uint4*>(ks_w + r * LDO + col);
      else
        *reinterpret_cast<uint2*>(ob + (size_t)r * D + col) =
            *reinterpret_cast<const uint2*>(ks_w + r * LDO + col);
    }
    __syncwarp();  // the buffer is refilled next
  }
}

template <int TP, int RP, int DKC, int DC, int HC>
struct LaunchProj {
  static cudaError_t run(const I2tProjArgs& a, int B, cudaStream_t stream) {
    constexpr int nw = proj_warps<DKC>();  // shared memory: 204 / 205 KB
    const int LDK = a.dk + 8, LDO = (a.D + 7) / 8 * 8 + 8;
    const size_t smem =
        sizeof(bf16) * ((size_t)RP * LDK + 2 * (size_t)RP * (DPAD + 8) +
                        (size_t)nw * 16 * (LDK > LDO ? LDK : LDO));
    cudaError_t err = cudaFuncSetAttribute(
        i2t_mma_kernel<TP, RP, DKC, DC, HC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int rows = nw * TPW * 16;
    dim3 grid((a.L + rows - 1) / rows, B);
    i2t_mma_kernel<TP, RP, DKC, DC, HC><<<grid, 32 * nw, smem, stream>>>(a);
    return cudaGetLastError();
  }
};

cudaError_t launch_fma(const void* keys, const void* wq, const void* peq,
                       const void* kt, const void* vt, void* out, float* kq,
                       int B, int NT, int heads, int t_len, int L, int dk,
                       int D, float scale, long long k_sb, long long t_sb,
                       cudaStream_t stream) {
  cudaError_t err = launch_kq<float>(kt, wq, kq, B, NT, heads, dk, D, t_sb,
                                     stream);
  if (err != cudaSuccess) return err;
  const size_t smem =
      sizeof(float) * ((size_t)RMAX * (dk + 4) + BL * (dk + 4) +
                       BL * (D + 4) + BL * LDS + 2 * NT * D);
  err = cudaFuncSetAttribute(
      i2t_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BL * TILES - 1) / (BL * TILES), B);
  const long long q_sb = t_sb ? (long long)heads * NT * dk : 0;
  i2t_kernel<float><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(keys), kq, static_cast<const float*>(peq),
      static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<float*>(out), NT, heads, t_len, L, dk, D, scale, k_sb, t_sb,
      q_sb);
  return cudaGetLastError();
}

}  // namespace

// keys (B or 1, L, dk) read at k_sb elements per batch (0 = shared); wq
// (dk, D); peq (L, D); kt, vt (B or 1, NT, D) at t_sb; out (B, L, D); kq a
// scratch of (B, or 1 when t_sb is 0) x heads * NT x dk elements of the
// dtype. Needs NT <= 16, heads * NT <= 64, dk % 16 == 0, dk <= 256,
// (D / heads) % 4 == 0; in bf16 also D <= 128 and a 4-byte aligned peq
// (keys at any alignment), in f32 D <= 256 and 16-byte aligned pointers.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches.
extern "C" int ovo_cross_i2t_proj(const void* keys, const void* wq,
                                  const void* peq, const void* kt,
                                  const void* vt, void* out, void* kq, int B,
                                  int NT, int heads, int t_len, int L, int dk,
                                  int D, float scale, long long k_sb,
                                  long long t_sb, int dtype, void* stream) {
  if (B < 1 || NT < 1 || NT > TMAX || heads < 1 || heads * NT > RMAX ||
      t_len < 1 || t_len > NT || L < 1 || dk < 16 || dk > THREADS ||
      dk % 16 || D % heads || (D / heads) % 4 || D > THREADS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_fma(keys, wq, peq, kt, vt, out,
                           static_cast<float*>(kq), B, NT, heads, t_len, L,
                           dk, D, scale, k_sb, t_sb, s);
  if (dtype == 1) {
    if (D > DPAD || reinterpret_cast<uintptr_t>(peq) % 4)
      return (int)cudaErrorInvalidValue;
    I2tProjArgs a;
    fill_i2t_args(a, keys, kq, peq, kt, vt, NT, heads, t_len, L, dk, D,
                  scale, k_sb, t_sb);
    a.out = static_cast<bf16*>(out);
    const long long so[1] = {D};
    const void* optr = out;
    // D is a multiple of 4: copies of 8 elements, or of 4
    a.vs_o = vector_shift(&optr, 1, so, 1, D);
    if (a.vs_o < 2) return (int)cudaErrorInvalidValue;
    cudaError_t err = launch_kq<bf16>(kt, wq, static_cast<bf16*>(kq), B, NT,
                                      heads, dk, D, t_sb, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_i2t<LaunchProj>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
