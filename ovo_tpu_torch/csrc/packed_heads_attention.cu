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
// Design: B2's device code (window_attention.cuh) with the packed layout
// expressed as strides: head h of row l of window b sits at b * batch_stride
// + l * row_stride + h * hd, so q, k and v are read straight from the qkv
// projection (row stride 3 * heads * hd) or from the pooled q (row stride
// heads * hd), and the output is written token-major, (B, Lq, heads * hd),
// the layout the out-projection reads. On the TPU the transposes cost
// layout-flip copies; on the card B2 already takes strided views, so the
// two kernels do the same work and differ in entry point and launch count.
#include "window_attention.cuh"

// q (B, Lq, dout), k and v (B, Lk, dout), dout = heads * hd, each with a
// contiguous last dimension and the given batch and row strides (elements,
// multiples of 4, pointers aligned to 4 elements); out (B, Lq, dout)
// contiguous. hd must be one of 16, 32, 48, 56, 64, 72, 80, 96, 112, 128.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_packed_heads_attention(
    const void* q, const void* k, const void* v, void* out, int B, int Lq,
    int Lk, int dout, int heads, float scale, long long q_bs, long long q_rs,
    long long k_bs, long long k_rs, long long v_bs, long long v_rs,
    int dtype, void* stream) {
  if (B < 1 || Lq < 1 || Lk < 1 || heads < 1 || dout % heads)
    return (int)cudaErrorInvalidValue;
  const int hd = dout / heads;
  const long long a[9] = {q_bs, hd, q_rs, k_bs, hd, k_rs, v_bs, hd, v_rs};
  for (int i = 0; i < 9; ++i)
    if (a[i] % 4) return (int)cudaErrorInvalidValue;
  const uintptr_t align = dtype == 0 ? 16 : 8;  // four elements
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % align)
    return (int)cudaErrorInvalidValue;
  const Strides st = {a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8],
                      (long long)Lq * dout, hd, dout};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, B, heads, Lq, hd, Lk, scale,
                                st, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, heads, Lq, hd, Lk,
                                        scale, st, s);
  return (int)cudaErrorInvalidValue;
}
