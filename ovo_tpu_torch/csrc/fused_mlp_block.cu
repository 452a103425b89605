// The MLP half of a pre-LN transformer block: x + proj(act(fc(LN(x)))).
//
// Replaces: ovo_tpu/ops/fused_block.py fused_mlp_block / _mlp_kernel (the
// Pallas TPU kernel behind OVO_FUSED_BLOCK=1; on this path PE-Core-L14-336's
// 24 MLPs, D 1024, hidden 4096, in chunks of 512).
//
// What it computes, in _mlp_kernel's op order:
//   lnx = LN(x) with f32 statistics, rounded to the dtype;
//   per hidden chunk c: h = lnx . fc_w[:, c] in f32 + the f32 bias; the
//     activation in f32 (quick_gelu, or gelu: the tanh approximation for
//     bf16, erf for f32, layers.gelu's rule); rounded to the dtype;
//   acc = sum over chunks, in chunk order, of h_c . proj_w[c] in f32;
//   out = (x + acc) + proj_b in f32, rounded to the dtype.
//
// What bounds it on an H100: per 577-token view it does 9.7 GFLOP and reads
// 16.8 MB of bf16 weights: the bf16 tensor cores would bound a view near
// 9.8 us. This first version does the products as f32 FMAs on the CUDA cores,
// so FMA throughput and shared-memory bandwidth bound it.
//
// Design. The TPU kernel walks the hidden chunks in sequence on one core and
// sums the proj in one VMEM scratch; a Hopper block shares nothing with the
// others, so the call runs as three launches over scratch in device memory:
//   1. LN rows -> lnx (dtype);
//   2. the fc GEMM with bias and activation in its epilogue -> h (dtype);
//   3. the proj GEMM, its k axis summed per chunk then across chunks in
//      order, with the residual and the bias in its epilogue.
#include "block_common.cuh"

namespace {

using namespace ovo_block;

template <typename T>
cudaError_t run(const void* x, const void* fc_w, const float* fc_b,
                const void* proj_w, const float* proj_b, const float* ln_s,
                const float* ln_b, void* out, void* lnx, void* h, int M,
                int D, int hidden, int chunk, int act, cudaStream_t s) {
  cudaError_t err = launch_ln_rows<T>(x, ln_s, ln_b, lnx, M, D, s);
  if (err != cudaSuccess) return err;
  err = launch_gemm<T, EPI_ACT>(lnx, D, fc_w, hidden, hidden, 0, M, hidden,
                                D, D, fc_b, nullptr, h, hidden, act, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, EPI_RESID>(h, hidden, proj_w, D, D, 0, M, D, hidden,
                                   chunk, proj_b, x, out, D, 0, s);
}

}  // namespace

// x, out (M, D) and lnx (M, D), h (M, hidden) scratch in the dtype; fc_w
// (D, hidden), proj_w (hidden, D) in the dtype; fc_b (hidden,), proj_b, ln_s,
// ln_b (D,) f32. All contiguous. chunk divides hidden, chunk % 8 == 0,
// D % 8 == 0. act: 0 = gelu, 1 = quick_gelu. dtype: 0 = float32,
// 1 = bfloat16. Returns the first failing cudaError_t of the three launches.
extern "C" int ovo_fused_mlp_block(const void* x, const void* fc_w,
                                   const void* fc_b, const void* proj_w,
                                   const void* proj_b, const void* ln_s,
                                   const void* ln_b, void* out, void* lnx,
                                   void* h, int M, int D, int hidden,
                                   int chunk, int act, int dtype,
                                   void* stream) {
  if (M < 1 || D < 8 || D % 8 || chunk < 8 || chunk % 8 || hidden % chunk ||
      (act != ACT_GELU && act != ACT_QUICK_GELU))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(fc_b);
  const float* pb = static_cast<const float*>(proj_b);
  const float* ls = static_cast<const float*>(ln_s);
  const float* lb = static_cast<const float*>(ln_b);
  if (dtype == 0)
    return (int)run<float>(x, fc_w, fb, proj_w, pb, ls, lb, out, lnx, h, M,
                           D, hidden, chunk, act, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, fc_w, fb, proj_w, pb, ls, lb, out, lnx,
                                   h, M, D, hidden, chunk, act, s);
  return (int)cudaErrorInvalidValue;
}
