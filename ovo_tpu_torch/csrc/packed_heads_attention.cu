// Window attention on the head-packed layout: the Hiera trunk's window
// blocks under window_attn="packed".
//
// Replaces: ovo_tpu/ops/attention.py packed_heads_attention /
// _packed_heads_kernel (a Pallas TPU kernel that slices the heads out of the
// (B, L, heads * hd) rows in-kernel, so that no (B, L, H, hd) -> (B, H, L,
// hd) transpose is written around it).
//
// What it computes, per window b and head h of q (B, Lq, heads * hd) and k,
// v (B, Lk, heads * hd), Lq != Lk allowed (the q-pooled stage transitions),
// exactly as _packed_heads_kernel does:
//   s   = (q_h . k_h) * scale in f32;
//   p   = exp(s - max s) / sum exp(s - max s) in f32, then rounded to the
//         working dtype (the reference casts p to v's dtype after
//         normalizing);
//   out = p . v_h accumulated in f32, rounded once per head, written to
//         the head's columns of out (B, Lq, heads * hd).
// The reference pads Lq / Lk to multiples of 8 and masks the padded keys with
// -1e30; here nothing is padded (every key is real), which is the same
// function. An all-zero window softmaxes to uniform, never NaN.
//
// What bounds it on an H100: the same work as kernel B2 on the same windows
// (at Hiera-L's stage 3, 25 windows of 196 x 196, 8 heads of 72, bf16: 2.2
// GFLOP and 4 x 5.6 MB, bytes-bound at 6.7 us; stage 1, 1024 windows of 64,
// 2 heads: 22.5 us).
//
// Design: B2's device code (window_attention.cuh: bf16 on mma.sync tensor
// cores, float32 on FMAs; notes in windowed_attention.cu) with the packed
// layout expressed as strides: head h of row l of window b sits at b *
// batch_stride + l * row_stride + h * hd, so q, k and v are read straight
// from the qkv projection (row stride 3 * heads * hd) or from the pooled q
// (row stride heads * hd), and the output is written token-major, (B, Lq,
// heads * hd), the layout the out-projection reads. On the TPU the
// transposes cost layout-flip copies; on the card B2 already takes strided
// views, so the two kernels do the same work and differ in entry point and
// launch count. The first design (B2's f32-FMA device code) took 0.382 ms
// at stage 3 and 0.442 ms at stage 1.
#include "window_attention.cuh"

// q (B, Lq, dout), k and v (B, Lk, dout), dout = heads * hd, each with a
// contiguous last dimension and the given batch and row strides (elements);
// out (B, Lq, dout) contiguous. hd must be one of 16, 32, 48, 56, 64, 72,
// 80, 96, 112, 128. dtype: 0 = float32, 1 = bfloat16. Returns the
// cudaError_t of the launch.
extern "C" int ovo_packed_heads_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Lq,
    int Lk, int dout, int heads, float scale, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || heads < 1 || dout % heads)
    return (int)cudaErrorInvalidValue;
  const int hd = dout / heads;
  const Strides st = {q_bs, hd, q_rs, k_bs, hd, k_rs, v_bs, hd, v_rs,
                      (long long)Lq * dout, hd, dout};
  return (int)dispatch(q, k, v, out, B, heads, Lq, hd, Lk, scale, dtype, st,
                       static_cast<cudaStream_t>(stream));
}
