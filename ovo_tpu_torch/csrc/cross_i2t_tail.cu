// Image -> token cross attention with its whole image-side tail: the SAM
// decoder's image-to-token attention, out-projection, keys residual and
// LayerNorm (norm4) in one pass, writing the next layer's keys.
//
// Replaces: ovo_tpu/ops/attention.py cross_i2t_tail_from_keys ->
// _crossk_proj_ln_call / _crossk_proj_ln_kernel (a Pallas TPU kernel).
//
// What it computes, for prompt b and image row l (keys[l] of width dk, the
// query side; Wq (dk, D); D = heads * dh), in the reference's types:
//   kq[h,t,c] = sum_j k_tok[t, h*dh+j] Wq[c, h*dh+j], rounded to the dtype;
//   s[h,t]    = (kq[h,t] . keys[l] + k_tok[t, h-block] . pe_q[l, h-block])
//               * scale in f32, tokens t >= t_len set to -1e30;
//   p[h,:]    = softmax over the tokens of head h in f32, normalized, then
//               rounded to the dtype;
//   attn[h*dh+j] = sum_t p[h,t] v_tok[t, h*dh+j] in f32, rounded;
//   y         = attn . Wout + bout in f32, rounded;
//   x         = y + keys[l] in f32; out = LayerNorm(x) (f32 mean, then the
//               mean of the squared centred values; eps) * scale + bias,
//               rounded.
//
// What bounds it on an H100: at the AMG shape (256 prompts, L = 4096,
// dk = 256, D = 128, 8 heads x 8 tokens, bf16) a launch needs ~110 GFLOP
// (111 us at 989 TF/s) and moves 537 MB of keys in and 537 MB out (320 us at
// 3.35 TB/s): bytes bound it.
//
// Two launches on the caller's stream: kq_kernel (cross_i2t_common.cuh)
// forms kq once per prompt; then, by dtype:
//
// bf16 (i2t_mma_kernel), on the tensor cores. A block of eight warps holds
// the prompt's kq and the block-diagonal k_tok and v_tok
// (i2t_stage_tokens) and Wout (64 KB), all in shared memory. Each warp
// takes 16 image rows at a time through its own keys buffer (cp.async,
// 16-byte copies where pointer and strides allow), every product on
// mma.sync m16n8k16:
//  - S = [keys | pe_q] . [kq | k_tok_bd]^T, the softmax over each head's
//    tokens, p rounded and attn = p . v_tok_bd: i2t_attn_tile
//    (cross_i2t_common.cuh, shared with B7);
//  - attn rounded and reused the same way as the A fragments of
//    y = attn . Wout (ldmatrix.trans on Wout), in two column halves of 64
//    f32 accumulators a thread, + bout, rounded and kept packed as bf16;
//  - x = y + keys from the buffer already in shared memory (keys are read
//    once), the LayerNorm's mean and centred variance reduced over the quad,
//    the output written over the keys rows and stored in 16-byte copies.
// The (B, L, D) attention output, the projected tensor and the residual sum
// never reach device memory.
//
// float32 (i2t_kernel) keeps the first design, f32 FMAs on the CUDA cores:
// one block of 256 threads per (prompt, 128 image rows); the (32 rows x 64
// kq rows) score product register-tiled, one thread per (row, head) for the
// pe term, softmax and attn, one thread per output column for attn . Wout,
// the row statistics reduced with warp shuffles. The first design ran bf16
// too, at 7.007 ms (per-prompt keys) and 6.769 (shared) at the AMG shape.
// Batch-1 keys (the first two-way layer) or tokens are read through a batch
// stride of 0.
#include "cross_i2t_common.cuh"

namespace {

// each warp's sums of x (or x^2) over its 32 threads, every row -> red_s
template <bool SQUARE>
__device__ __forceinline__ void row_sums(const float (&x)[BL],
                                         float* __restrict__ red_s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int l = 0; l < BL; ++l) {
    float v = SQUARE ? x[l] * x[l] : x[l];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red_s[warp * BL + l] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
i2t_kernel(const T* __restrict__ keys, const T* __restrict__ kq,
           const T* __restrict__ peq, const T* __restrict__ kt,
           const T* __restrict__ vt, const T* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ lns,
           const float* __restrict__ lnb, T* __restrict__ out, int NT,
           int heads, int t_len, int L, int dk, int D, float scale, float eps,
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
  float* red_s = vt_s + NT * D;   // NW x BL

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
  const int c = tid;  // out-projection / LayerNorm column
  const bool cok = c < dk;
  const float bc = cok ? bout[c] : 0.f;
  const float g = cok ? lns[c] : 0.f, bb = cok ? lnb[c] : 0.f;
  T* ob = out + (long long)b * L * dk;

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

    // out-projection, bias, keys residual: thread c owns column c of all rows
    float x[BL];
#pragma unroll
    for (int l = 0; l < BL; ++l) x[l] = 0.f;
    for (int d = 0; d < D; d += 4) {
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = cok ? to_f<T>(wout[(d + i) * dk + c]) : 0.f;
#pragma unroll
      for (int l = 0; l < BL; ++l) {
        const float4 a = reinterpret_cast<const float4*>(pe_s + l * LDE + d)[0];
        x[l] = fmaf(a.x, w[0], x[l]);
        x[l] = fmaf(a.y, w[1], x[l]);
        x[l] = fmaf(a.z, w[2], x[l]);
        x[l] = fmaf(a.w, w[3], x[l]);
      }
    }
#pragma unroll
    for (int l = 0; l < BL; ++l)
      x[l] = cok ? rnd<T>(x[l] + bc) + ks_s[l * LDK + c] : 0.f;

    // LayerNorm over the dk columns of each row, f32 statistics
    row_sums<false>(x, red_s);
    __syncthreads();
#pragma unroll
    for (int l = 0; l < BL; ++l) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < NW; ++w) t += red_s[w * BL + l];
      x[l] = cok ? x[l] - t / (float)dk : 0.f;
    }
    __syncthreads();
    row_sums<true>(x, red_s);
    __syncthreads();
    if (cok) {
#pragma unroll
      for (int l = 0; l < BL; ++l) {
        if (l0 + l < L) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < NW; ++w) t += red_s[w * BL + l];
          const float inv = rsqrtf(t / (float)dk + eps);
          ob[(long long)(l0 + l) * dk + c] = from_f<T>(x[l] * inv * g + bb);
        }
      }
    }
  }
}

cudaError_t launch_fma(const void* keys, const void* wq, const void* peq,
                       const void* kt, const void* vt, const void* wout,
                       const float* bout, const float* lns, const float* lnb,
                       void* out, float* kq, int B, int NT, int heads,
                       int t_len, int L, int dk, int D, float scale,
                       float eps, long long k_sb, long long t_sb,
                       cudaStream_t stream) {
  cudaError_t err = launch_kq<float>(kt, wq, kq, B, NT, heads, dk, D, t_sb,
                                     stream);
  if (err != cudaSuccess) return err;
  const size_t smem =
      sizeof(float) * (size_t)RMAX * (dk + 4) +
      sizeof(float) * ((size_t)BL * (dk + 4) + BL * (D + 4) + BL * LDS +
                       2 * NT * D + NW * BL);
  err = cudaFuncSetAttribute(
      i2t_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((L + BL * TILES - 1) / (BL * TILES), B);
  const long long q_sb = t_sb ? (long long)heads * NT * dk : 0;
  i2t_kernel<float><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(keys), kq, static_cast<const float*>(peq),
      static_cast<const float*>(kt), static_cast<const float*>(vt),
      static_cast<const float*>(wout), bout, lns, lnb,
      static_cast<float*>(out), NT, heads, t_len, L, dk, D, scale, eps, k_sb,
      t_sb, q_sb);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

struct I2tTailArgs : I2tArgs {
  const bf16* wout;   // (D, dk)
  const float* bout;  // (dk,)
  const float* lns;   // (dk,)
  const float* lnb;   // (dk,)
  bf16* out;          // (B, L, dk)
  float eps;
  int vs_w;           // copy width (vector_shift) of wout
};

// TP, RP, DKC, DC, HC: as i2t_attn_tile's (cross_i2t_common.cuh)
template <int TP, int RP, int DKC, int DC, int HC>
__global__ void __launch_bounds__(256, 1) i2t_mma_kernel(I2tTailArgs a) {
  constexpr int ND = DPAD / 8;     // n8 attention tiles
  const int dk = DKC ? DKC : a.dk, D = DC ? DC : a.D;
  const int nw = blockDim.x >> 5;
  const int LDK = dk + 8, LDE = DPAD + 8;  // odd 16-byte units
  const int DP16 = (D + 15) / 16 * 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* wo_s = reinterpret_cast<bf16*>(smem_raw);  // DP16 x LDK
  bf16* kq_s = wo_s + DP16 * LDK;                  // RP x LDK
  bf16* kb_s = kq_s + RP * LDK;                    // RP x LDE, k_tok block-diag
  bf16* vb_s = kb_s + RP * LDE;                    // RP x LDE, v_tok block-diag
  bf16* ks_s = vb_s + RP * LDE;                    // nw x 16 x LDK
  float* bo_s = reinterpret_cast<float*>(ks_s + nw * 16 * LDK);  // dk
  float* ln_s = bo_s + dk;  // dk scale, then dk bias

  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3;
  const int a_row = (lane & 7) + 8 * ((lane >> 3) & 1), a_col = 8 * (lane >> 4);
  const bf16* kb = a.keys + b * a.k_sb;

  // Wout, kq and the block-diagonal tokens
  load_rows(wo_s, LDK, a.wout, dk, 0, DP16, D, dk, a.vs_w, tid, blockDim.x);
  i2t_stage_tokens<TP, RP, DKC, DC, HC>(a, b, kq_s, kb_s, vb_s);
  cp_async_commit();
  for (int i = tid; i < dk; i += blockDim.x) {
    bo_s[i] = a.bout[i];
    ln_s[i] = a.lns[i];
    ln_s[dk + i] = a.lnb[i];
  }
  cp_async_wait<0>();
  __syncthreads();

  bf16* ks_w = ks_s + warp * 16 * LDK;
  const int rows_per_block = nw * TPW * 16;
  const int nkd = DP16 / 16;  // k16 chunks of D
  const int ncol = dk / 16;   // n8 tiles of a column half of y
  for (int tile = 0; tile < TPW; ++tile) {
    const int l0 = blockIdx.x * rows_per_block + (tile * nw + warp) * 16;
    if (l0 >= a.L) break;
    load_rows(ks_w, LDK, kb, dk, l0, 16, a.L, dk, a.vs_k, lane, 32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    float at[ND][4];
    i2t_attn_tile<TP, RP, DKC, DC, HC>(a, ks_w, kq_s, kb_s, vb_s, l0, at);
    // attn rounded (the reference's attn.astype), as the A fragments of
    // attn . Wout
    uint32_t aA[ND / 2][4];
#pragma unroll
    for (int kd = 0; kd < ND / 2; ++kd) {
      aA[kd][0] = pack_bf16(at[2 * kd][0], at[2 * kd][1]);
      aA[kd][1] = pack_bf16(at[2 * kd][2], at[2 * kd][3]);
      aA[kd][2] = pack_bf16(at[2 * kd + 1][0], at[2 * kd + 1][1]);
      aA[kd][3] = pack_bf16(at[2 * kd + 1][2], at[2 * kd + 1][3]);
    }

    // y = attn Wout + bout, rounded, in two column halves; kept packed
    uint32_t yv[2][16][2];
#pragma unroll
    for (int yh = 0; yh < 2; ++yh) {
      const int col0 = yh * (dk / 2);
      float acc[16][4];
#pragma unroll
      for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < ND / 2; ++kd) {
        if (kd >= nkd) break;
        const bf16* wrow = wo_s + (16 * kd + a_row) * LDK + col0;
        uint32_t wf[8][4];
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (2 * np + 1 < ncol) {
            ldmatrix_x4_trans(wf[np], wrow + 16 * np + a_col);
          } else if (2 * np < ncol) {
            uint32_t w2[2];
            ldmatrix_x2_trans(w2, wrow + 16 * np);
            wf[np][0] = w2[0];
            wf[np][1] = w2[1];
          }
        }
#pragma unroll
        for (int np = 0; np < 8; ++np) {
          if (2 * np < ncol) mma_bf16(acc[2 * np], aA[kd], wf[np][0], wf[np][1]);
          if (2 * np + 1 < ncol)
            mma_bf16(acc[2 * np + 1], aA[kd], wf[np][2], wf[np][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        if (n < ncol) {
          const int col = col0 + 8 * n + 2 * c;
          const float b0 = bo_s[col], b1 = bo_s[col + 1];
          yv[yh][n][0] = pack_bf16(acc[n][0] + b0, acc[n][1] + b1);
          yv[yh][n][1] = pack_bf16(acc[n][2] + b0, acc[n][3] + b1);
        }
      }
    }

    // x = y + keys in f32; LayerNorm over dk: the mean, then the mean of
    // the squared centred values, each reduced over the quad; the output
    // takes y's registers, then overwrites the keys rows in shared memory
    // and leaves in 16-byte stores
    auto x_at = [&](int yh, int n, int hh, float (&x)[2]) {
      const int col = yh * (dk / 2) + 8 * n + 2 * c;
      const float2 k2 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
          ks_w + (g + 8 * hh) * LDK + col));
      const uint32_t y = yv[yh][n][hh];
      x[0] = __uint_as_float(y << 16) + k2.x;
      x[1] = __uint_as_float(y & 0xffff0000u) + k2.y;
    };
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float sum = 0.f;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < ncol) {
            float x[2];
            x_at(yh, n, hh, x);
            sum += x[0] + x[1];
          }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float mean = sum / (float)dk;
      float sq = 0.f;
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < ncol) {
            float x[2];
            x_at(yh, n, hh, x);
            const float c0 = x[0] - mean, c1 = x[1] - mean;
            sq += c0 * c0 + c1 * c1;
          }
      sq += __shfl_xor_sync(0xffffffffu, sq, 1);
      sq += __shfl_xor_sync(0xffffffffu, sq, 2);
      const float inv = rsqrtf(sq / (float)dk + a.eps);
#pragma unroll
      for (int yh = 0; yh < 2; ++yh)
#pragma unroll
        for (int n = 0; n < 16; ++n)
          if (n < ncol) {
            float x[2];
            x_at(yh, n, hh, x);
            const int col = yh * (dk / 2) + 8 * n + 2 * c;
            yv[yh][n][hh] =
                pack_bf16((x[0] - mean) * inv * ln_s[col] + ln_s[dk + col],
                          (x[1] - mean) * inv * ln_s[col + 1] +
                              ln_s[dk + col + 1]);
          }
    }
#pragma unroll
    for (int yh = 0; yh < 2; ++yh)
#pragma unroll
      for (int n = 0; n < 16; ++n)
        if (n < ncol) {
          const int col = yh * (dk / 2) + 8 * n + 2 * c;
          *reinterpret_cast<uint32_t*>(ks_w + g * LDK + col) = yv[yh][n][0];
          *reinterpret_cast<uint32_t*>(ks_w + (g + 8) * LDK + col) =
              yv[yh][n][1];
        }
    __syncwarp();
    bf16* ob = a.out + ((size_t)b * a.L + l0) * dk;
    for (int i = lane; i < 16 * (dk / 8); i += 32) {
      const int r = i / (dk / 8), col = 8 * (i % (dk / 8));
      if (l0 + r < a.L)
        *reinterpret_cast<uint4*>(ob + (size_t)r * dk + col) =
            *reinterpret_cast<const uint4*>(ks_w + r * LDK + col);
    }
    __syncwarp();  // the keys buffer is refilled next
  }
}

template <int TP, int RP, int DKC, int DC, int HC>
struct LaunchTail {
  static cudaError_t run(const I2tTailArgs& a, int B, cudaStream_t stream) {
    // shared memory: 202 KB / 220 KB at most
    const int nw = RP == 64 ? 8 : 2;
    const int DP16 = (a.D + 15) / 16 * 16, LDK = a.dk + 8;
    const size_t smem =
        sizeof(bf16) * ((size_t)(DP16 + RP + nw * 16) * LDK +
                        2 * (size_t)RP * (DPAD + 8)) +
        sizeof(float) * 3 * a.dk;
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

}  // namespace

// keys (B or 1, L, dk) read at k_sb elements per batch (0 = shared); wq
// (dk, D); peq (L, D); kt, vt (B or 1, NT, D) at t_sb; wout (D, dk); bout,
// lns, lnb (dk,) f32; out (B, L, dk); kq a scratch of (B, or 1 when t_sb is
// 0) x heads * NT x dk elements of the dtype. Needs NT <= 16, heads * NT <= 64,
// dk % 16 == 0, dk <= 256, (D / heads) % 4 == 0; in bf16 also D <= 128 and
// a 4-byte aligned peq (keys and wout at any alignment), in f32 16-byte
// aligned pointers. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launches.
extern "C" int ovo_cross_i2t_tail(const void* keys, const void* wq,
                                  const void* peq, const void* kt,
                                  const void* vt, const void* wout,
                                  const void* bout, const void* lns,
                                  const void* lnb, void* out, void* kq,
                                  int B, int NT, int heads, int t_len, int L,
                                  int dk, int D, float scale, float eps,
                                  long long k_sb, long long t_sb, int dtype,
                                  void* stream) {
  if (B < 1 || NT < 1 || NT > TMAX || heads < 1 || heads * NT > RMAX ||
      t_len < 1 || t_len > NT || L < 1 || dk < 16 || dk > THREADS ||
      dk % 16 || D % heads || (D / heads) % 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bo = static_cast<const float*>(bout);
  const float* g = static_cast<const float*>(lns);
  const float* bb = static_cast<const float*>(lnb);
  if (dtype == 0)
    return (int)launch_fma(keys, wq, peq, kt, vt, wout, bo, g, bb, out,
                           static_cast<float*>(kq), B, NT, heads, t_len, L,
                           dk, D, scale, eps, k_sb, t_sb, s);
  if (dtype == 1) {
    if (D > DPAD || reinterpret_cast<uintptr_t>(peq) % 4)
      return (int)cudaErrorInvalidValue;
    I2tTailArgs a;
    fill_i2t_args(a, keys, kq, peq, kt, vt, NT, heads, t_len, L, dk, D,
                  scale, k_sb, t_sb);
    a.wout = static_cast<const bf16*>(wout);
    a.bout = bo;
    a.lns = g;
    a.lnb = bb;
    a.out = static_cast<bf16*>(out);
    a.eps = eps;
    const long long sw[1] = {dk};
    a.vs_w = vector_shift(&wout, 1, sw, 1, dk);
    cudaError_t err = launch_kq<bf16>(kt, wq, static_cast<bf16*>(kq), B, NT,
                                      heads, dk, D, t_sb, s);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_i2t<LaunchTail>(a, B, s);
  }
  return (int)cudaErrorInvalidValue;
}
