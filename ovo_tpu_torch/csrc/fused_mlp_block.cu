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
// 9.8 us, the 7-view call (67.8 GFLOP) near 69 us.
//
// Design. The TPU kernel walks the hidden chunks in sequence on one core and
// sums the proj in one VMEM scratch; a Hopper block shares nothing with the
// others, so the call runs as three launches over scratch in device memory:
//   1. LN rows -> lnx (dtype);
//   2. the fc GEMM with bias and activation in its epilogue -> h (dtype;
//      at the PE shape 33 MB, most of which stays in the 50 MB L2);
//   3. the proj GEMM, its k axis summed per chunk then across chunks in
//      order, with the residual and the bias in its epilogue.
// In bf16 both GEMMs run on the tensor cores (block_common.cuh
// mma_gemm_kernel: mma.sync m16n8k16; the fc in 128 x 256 blocks of 64 x 64
// warp tiles, the proj, which holds a second accumulator set for its chunk
// groups, in 128 x 128 blocks of 32 x 64 warp tiles; a 4-deep cp.async ring
// of 64-deep k slices) wherever mma_gemm_fits takes the shape: N a multiple
// of the tile's N extent (256, 128), K and the chunk multiples of 64 (every
// GEMM of the PE tower). Other widths, and float32, take the f32 FMA
// gemm_kernel. mlp_routes chooses; ovo_fused_mlp_block_routes reports the
// choice to the wrapper. The first design (every product an f32 FMA) took
// 3.764 ms at the PE shape on an H100.
#include "block_common.cuh"

namespace {

using namespace ovo_block;

constexpr int ROUTE_FC_MMA = 1, ROUTE_PROJ_MMA = 2;

// The GEMMs that run on the tensor cores for these inputs (bf16 only):
// each where mma_gemm_fits takes it.
int mlp_routes(const void* x, const void* fc_w, const void* proj_w, int D,
               int hidden, int chunk, int dtype) {
  if (dtype != 1) return 0;
  return (mma_gemm_fits(fc_w, nullptr, D, hidden, hidden, 0, hidden, D, D,
                        hidden, EPI_ACT)
              ? ROUTE_FC_MMA
              : 0) |
         (mma_gemm_fits(proj_w, x, hidden, D, D, 0, D, hidden, chunk, D,
                        EPI_RESID)
              ? ROUTE_PROJ_MMA
              : 0);
}

template <typename T>
cudaError_t run(const void* x, const void* fc_w, const float* fc_b,
                const void* proj_w, const float* proj_b, const float* ln_s,
                const float* ln_b, void* out, void* lnx, void* h, int M,
                int D, int hidden, int chunk, int act, int routes,
                cudaStream_t s) {
  const RopeEpi none{};
  cudaError_t err = launch_ln_rows<T>(x, ln_s, ln_b, lnx, M, D, s);
  if (err != cudaSuccess) return err;
  err = routes & ROUTE_FC_MMA
            ? launch_mma_gemm<EPI_ACT>(lnx, D, fc_w, hidden, hidden, 0, M,
                                       hidden, D, D, fc_b, nullptr, h, hidden,
                                       act, none, s)
            : launch_gemm<T, EPI_ACT>(lnx, D, fc_w, hidden, hidden, 0, M,
                                      hidden, D, D, fc_b, nullptr, h, hidden,
                                      act, s);
  if (err != cudaSuccess) return err;
  return routes & ROUTE_PROJ_MMA
             ? launch_mma_gemm<EPI_RESID>(h, hidden, proj_w, D, D, 0, M, D,
                                          hidden, chunk, proj_b, x, out, D, 0,
                                          none, s)
             : launch_gemm<T, EPI_RESID>(h, hidden, proj_w, D, D, 0, M, D,
                                         hidden, chunk, proj_b, x, out, D, 0,
                                         s);
}

}  // namespace

// The routes ovo_fused_mlp_block takes for these inputs: bit 0 the fc GEMM,
// bit 1 the proj GEMM on the tensor cores.
extern "C" int ovo_fused_mlp_block_routes(const void* x, const void* fc_w,
                                          const void* proj_w, int D,
                                          int hidden, int chunk, int dtype) {
  if (chunk < 1 || hidden % chunk) return 0;
  return mlp_routes(x, fc_w, proj_w, D, hidden, chunk, dtype);
}

// x, out (M, D) and lnx (M, D), h (M, hidden) scratch in the dtype; fc_w
// (D, hidden), proj_w (hidden, D) in the dtype; fc_b (hidden,), proj_b, ln_s,
// ln_b (D,) f32. All contiguous; out and the scratch 16-byte aligned. chunk
// divides hidden, chunk % 8 == 0, D % 8 == 0. act: 0 = gelu,
// 1 = quick_gelu. dtype: 0 = float32, 1 = bfloat16. Returns the first
// failing cudaError_t of the three launches.
extern "C" int ovo_fused_mlp_block(const void* x, const void* fc_w,
                                   const void* fc_b, const void* proj_w,
                                   const void* proj_b, const void* ln_s,
                                   const void* ln_b, void* out, void* lnx,
                                   void* h, int M, int D, int hidden,
                                   int chunk, int act, int dtype,
                                   void* stream) {
  if (M < 1 || D < 8 || D % 8 || chunk < 8 || chunk % 8 || hidden % chunk ||
      (act != ACT_GELU && act != ACT_QUICK_GELU) ||
      reinterpret_cast<uintptr_t>(out) % 16 ||
      reinterpret_cast<uintptr_t>(lnx) % 16 ||
      reinterpret_cast<uintptr_t>(h) % 16)
    return (int)cudaErrorInvalidValue;
  const int routes = mlp_routes(x, fc_w, proj_w, D, hidden, chunk, dtype);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fb = static_cast<const float*>(fc_b);
  const float* pb = static_cast<const float*>(proj_b);
  const float* ls = static_cast<const float*>(ln_s);
  const float* lb = static_cast<const float*>(ln_b);
  if (dtype == 0)
    return (int)run<float>(x, fc_w, fb, proj_w, pb, ls, lb, out, lnx, h, M,
                           D, hidden, chunk, act, routes, s);
  if (dtype == 1)
    return (int)run<__nv_bfloat16>(x, fc_w, fb, proj_w, pb, ls, lb, out, lnx,
                                   h, M, D, hidden, chunk, act, routes, s);
  return (int)cudaErrorInvalidValue;
}
