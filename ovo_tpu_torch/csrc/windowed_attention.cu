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
// decoder's (2048, 8, 8, hd 32) launch is ~2 MB and a microsecond.
//
// bf16 design (tensor cores, window_attention.cuh win_mma_kernel): a warp
// owns a 16-row query tile of one instance, its q fragments in registers.
// For lq > 16 (Hiera stage 1: 64, stage 3: 196, stage 4: 49, text: 64) a
// block of four warps takes up to four row tiles of one instance and the
// warps share its k / v chunks in shared memory; for lq <= 16 (the
// decoder's 8 tokens, stage 2's 16, the q-pooled 4) each warp takes a whole
// instance, rows padded to 16, and a block packs four. Keys stream in
// chunks of up to 64 through shared memory as bf16 (cp.async, 16 bytes a
// copy where every pointer and stride allows, else 8, 4 or 2), the next
// chunk loading while the current one is multiplied; the last chunk holds
// the keys left, rounded up to 16 (196 keys: 64, 64, 64, 16). Registers are
// capped at 128 a thread so that four blocks share an SM. Two passes over the
// chunks give the reference's rounding point: pass 1 takes the row max and
// sum from mma.sync m16n8k16 scores (bf16 in, f32 out, then times scale);
// pass 2 recomputes the scores, forms p = bf16(exp(s - m) / l) straight
// into the A fragments of p . v (the score C fragments, lane for lane) and
// accumulates p . v on mma.sync in f32. Recomputing q . k is cheap here:
// stage 3 is bound by bytes. When one chunk holds every key, pass 2 loads v
// alone, while pass 1 runs. Head sizes that are not multiples of 16 (56,
// 72, 112) are zero-padded in shared memory to the next 16 for q . k; p . v
// covers hd / 8 n8 tiles. Shared rows are padded by 8 elements (an odd
// number of 16-byte units), so ldmatrix reads hit distinct bank groups. The
// first design (one thread per query row, f32 FMA dot products over k / v
// widened to f32 in shared memory) took 0.351 ms at stage 3, 0.399 ms at
// stage 1, 0.048 ms at the decoder's shape and 0.097 ms at the text tower's.
//
// float32 keeps that FMA design (win_fma_kernel; the f32 decoder route and
// SigLIP-384's f32 text tower): one thread per query row; a block of 128
// threads holds G whole instances (G = 128 / lq rows, cut to what fits 96
// KB of shared memory) or, for lq > 128, one 128-row slice of an instance;
// keys and values stream through shared memory in chunks of up to 64 keys
// for all G instances at once, four elements per read (16 bytes where
// aligned); each thread keeps its q row and its output row in registers,
// and the same two passes give the reference's rounding.
#include "window_attention.cuh"

// strides: 12 int64 values, (batch, head, row) strides of q, k, v and out in
// elements; the last dimension of each is contiguous, the out strides are
// even. hd must be one of 16, 32, 48, 56, 64, 72, 80, 96, 112, 128. dtype:
// 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ovo_windowed_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int H,
                                      int Lq, int Lk, int hd, int kv_len,
                                      float scale, int dtype,
                                      const long long* strides, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || kv_len < 1 || kv_len > Lk)
    return (int)cudaErrorInvalidValue;
  const long long* a = strides;
  if ((a[9] | a[10] | a[11]) % 2) return (int)cudaErrorInvalidValue;
  const Strides st = {a[0], a[1], a[2], a[3], a[4],  a[5],
                      a[6], a[7], a[8], a[9], a[10], a[11]};
  return (int)dispatch(q, k, v, out, B, H, Lq, hd, kv_len, scale, dtype, st,
                       static_cast<cudaStream_t>(stream));
}
