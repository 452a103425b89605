// Tensor-core building blocks shared by the bf16 attention kernels B1
// (flash_attention.cu), B2 / B11 (window_attention.cuh), B3 (cross_t2i.cu)
// and B4 (cross_i2t_tail.cu): the sm_80+
// warp-level mma.sync m16n8k16 bf16 product with f32 accumulation,
// ldmatrix fragment loads from shared memory, and cp.async copies from
// device memory into shared memory with zero fill.
//
// Fragment layouts of mma.sync.m16n8k16 (lane = threadIdx.x % 32, g =
// lane / 4, c = lane % 4; each 32-bit register holds two bf16, the lower
// column in the low half):
//   A (16 x 16, row-major): a0 = (g, 2c..2c+1), a1 = (g + 8, 2c..),
//                           a2 = (g, 8 + 2c..), a3 = (g + 8, 8 + 2c..)
//   B (16 x 8, k x n):      b0 = (k 2c..2c+1, n g), b1 = (k 8 + 2c.., n g)
//   C (16 x 8, f32):        c0, c1 = (g, 2c..2c+1), c2, c3 = (g + 8, 2c..)
// So the C fragments of two neighbouring n8 score tiles are, element for
// element, the A fragment of the next product over those 16 keys.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// d += a (16 x 16) * b (16 x 8)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8 and receives, of each, row lane / 4, columns 2 (lane % 4)
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// the same, each matrix transposed: lane receives rows 2 (lane % 4) and
// 2 (lane % 4) + 1 of column lane / 4
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// two transposed matrices (lanes 0-15 give the row addresses)
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p))
      : "memory");
}

// two bf16 values -> one register (lo in the low half)
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  const __nv_bfloat162 h = __halves2bfloat162(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// e / l, given rl = 1 / l: the product and one Newton step, which rounds
// like the division (e in [0, 1], l >= 1) without its slow-path branch
__device__ __forceinline__ float div_by_sum(float e, float l, float rl) {
  const float q0 = e * rl;
  return fmaf(fmaf(-q0, l, e), rl, q0);
}

// two floats -> one register of two bf16 (round to nearest even)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// copy 2 << vshift bytes (vshift 3: 16, 2: 8, 1: 4) from device memory to
// shared memory, or write zeros there when !ok (src is then not read); a
// single element (vshift 0) is a plain load and store
__device__ __forceinline__ void copy_async(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, bool ok,
                                           int vshift) {
  const uint32_t d = smem_addr(dst);
  switch (vshift) {
    case 3:
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   ::"r"(d), "l"(src), "r"(ok ? 16 : 0) : "memory");
      break;
    case 2:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   ::"r"(d), "l"(src), "r"(ok ? 8 : 0) : "memory");
      break;
    case 1:
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   ::"r"(d), "l"(src), "r"(ok ? 4 : 0) : "memory");
      break;
    default:
      *dst = ok ? *src : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a (row stride sl, unit column stride) bf16 matrix
// -> shared memory (row stride lds), columns [0, hd); rows at or past nvalid
// are zero-filled. Issued by team_n threads (team_tid of them), 1 << vshift
// elements each; hd is a multiple of 1 << vshift.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int lds,
                                          const __nv_bfloat16* src,
                                          long long sl, int r0, int rows,
                                          int nvalid, int hd, int vshift,
                                          int team_tid, int team_n) {
  const int per_row = hd >> vshift;
  for (int i = team_tid; i < rows * per_row; i += team_n) {
    const int r = i / per_row;
    const int col = (i - r * per_row) << vshift;
    const bool ok = r0 + r < nvalid;
    copy_async(dst + r * lds + col, src + (ok ? r0 + r : 0) * sl + col, ok,
               vshift);
  }
}

// The widest copy (log2 of elements: 3 = 16 bytes ... 0 = 2 bytes) that
// every row start of the operands allows: each pointer and each stride (in
// elements) and hd itself must be multiples of it.
inline int vector_shift(const void* const* ptrs, int n_ptrs,
                        const long long* strides, int n_strides, int hd) {
  for (int s = 3; s > 0; --s) {
    const long long w = 1LL << s;
    bool ok = hd % w == 0;
    for (int i = 0; i < n_ptrs; ++i)
      ok = ok && reinterpret_cast<uintptr_t>(ptrs[i]) % (2 * w) == 0;
    for (int i = 0; i < n_strides; ++i) ok = ok && strides[i] % w == 0;
    if (ok) return s;
  }
  return 0;
}

}  // namespace
