// Whole-KV attention over many small instances (windows, token sets).
//
// Replaces: ovo_tpu/ops/attention.py windowed_fused_attention /
// _winfused_kernel (the Pallas TPU kernel the Hiera window blocks and the
// SAM decoder's token self-attention run through).
//
// What it computes, per instance (b, h) of (B, H, Lq, D) x (B, H, Lk, D),
// exactly as _winfused_kernel does:
//   s   = (q . k) * scale in f32, keys >= kv_len set to -1e30;
//   p   = exp(s - max s) / sum exp(s - max s) in f32, then rounded to the
//         working dtype (the reference casts p to v's dtype);
//   out = p . v accumulated in f32, rounded once.
// An all-zero (padded) instance gets s = 0 everywhere: a uniform softmax and
// the mean of v, never NaN.
//
// What bounds it on an H100: the instances are tiny (lq 4-196, lk 8-196,
// hd 32 or 72). At the largest Hiera-L shape (200 instances of 196 x 196,
// hd 72, bf16) a launch needs 2.2 GFLOP and moves 4 x 5.6 MB: 2.2 us of
// tensor-core time against 6.7 us of memory time, so bytes bound it; the
// decoder's (2048, 8, 8, hd 32) launch is ~2 MB and a microsecond. What costs
// is work per instance too small to fill a block: one block per instance
// would leave most threads idle at lq = 4-16.
//
// Design: one thread per query row. A block of 128 threads holds G whole
// instances (G = 128 / lq rows, cut to what fits 96 KB of shared memory) or,
// for lq > 128, one 128-row slice of an instance; so lq = 4 packs 32
// instances per block and nothing is wasted on padding rows. Keys and values
// stream through shared memory in chunks of up to 64 keys for all G
// instances at once (f32, instance rows offset by 4 floats against bank
// conflicts), four elements per global read; every thread of an instance
// reads the same k / v row, a broadcast, as float4. Each thread keeps its q
// row and its output row in registers. Two passes over the keys give the reference's rounding: pass 1
// the row max and sum (online), pass 2 the normalized weights, rounded to the
// dtype, times v. The dot products keep four partial sums for ILP.
#include "window_attention.cuh"

// strides: 12 int64 values, (batch, head, row) strides of q, k, v and out in
// elements; the last dimension of each is contiguous; the q, k, v strides are
// multiples of 4 and their pointers aligned to 4 elements. hd must be one of
// 16, 32, 48, 56, 64, 72, 80, 96, 112, 128. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int ovo_windowed_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Lq, int Lk, int hd, int kv_len,
                                      float scale, int dtype,
                                      const long long* strides, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || kv_len < 1 || kv_len > Lk)
    return (int)cudaErrorInvalidValue;
  const long long* a = strides;
  for (int i = 0; i < 9; ++i)
    if (a[i] % 4) return (int)cudaErrorInvalidValue;
  const uintptr_t align = dtype == 0 ? 16 : 8;  // four elements
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % align)
    return (int)cudaErrorInvalidValue;
  const Strides st = {a[0], a[1], a[2], a[3], a[4],  a[5],
                      a[6], a[7], a[8], a[9], a[10], a[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, out, B, H, Lq, hd, kv_len, scale, st, s);
  return (int)cudaErrorInvalidValue;
}
