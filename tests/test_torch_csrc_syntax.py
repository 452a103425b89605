"""The hand-written CUDA sources (``ovo_tpu_torch/csrc``) read as C++.

They compile only where the CUDA toolkit is (``nvcc`` on the card's
machine). Here each ``.cu`` goes through the host compiler's syntax pass
instead (``g++ -fsyntax-only``, templates instantiated), after the launch
brackets ``<<<...>>>`` are removed and with a header of CUDA stand-ins
(qualifiers, built-in indices, the intrinsics the sources call, the
runtime calls they make) in place of the toolkit's. That catches a typo,
an undeclared name or a template that does not instantiate before a run
on the card; it says nothing of PTX, registers or what the kernels
compute. The shared headers (``*.cuh``) go through the same pass on
their own. Skipped where no g++ is installed.
"""
import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "ovo_tpu_torch" / "csrc"
SOURCES = sorted(p.name for p in CSRC.glob("*.cu"))
HEADERS = sorted(p.name for p in CSRC.glob("*.cuh"))

STANDINS = r"""
#pragma once
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <math.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
#define __shared__
#define __restrict__
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
struct __nv_bfloat16 { unsigned short x; };
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
struct float2 { float x, y; };
struct float4 { float x, y, z, w; };
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float4 make_float4(float a, float b, float c, float d) {
  return {a, b, c, d};
}
inline __nv_bfloat16 __float2bfloat16_rn(float) { return {}; }
inline float __bfloat162float(__nv_bfloat16) { return 0; }
inline __nv_bfloat162 __floats2bfloat162_rn(float, float) { return {}; }
inline __nv_bfloat162 __halves2bfloat162(__nv_bfloat16, __nv_bfloat16) {
  return {};
}
inline float2 __bfloat1622float2(__nv_bfloat162) { return {}; }
inline float __low2float(__nv_bfloat162) { return 0; }
inline float __high2float(__nv_bfloat162) { return 0; }
inline size_t __cvta_generic_to_shared(const void*) { return 0; }
inline float __uint_as_float(unsigned) { return 0; }
inline unsigned __float_as_uint(float) { return 0; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float rsqrtf(float x) { return x; }
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
inline float __shfl_xor_sync(unsigned, float v, int) { return v; }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
"""


@pytest.fixture(scope="module")
def host_tree(tmp_path_factory):
    """The sources without their launch brackets, and the stand-ins for the
    toolkit's headers, in one directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ for the syntax pass")
    root = tmp_path_factory.mktemp("csrc")
    for p in list(CSRC.glob("*.cu")) + list(CSRC.glob("*.cuh")):
        (root / p.name).write_text(re.sub(r"<<<[^>]*>>>", "", p.read_text()))
    (root / "cuda_bf16.h").write_text(STANDINS)
    (root / "cuda_runtime.h").write_text("#pragma once\n")
    return root


@pytest.mark.parametrize("name", SOURCES)
def test_cuda_source_parses_as_cpp(host_tree, name):
    proc = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-fsyntax-only", "-w", "-I",
         str(host_tree), "-include", "cuda_bf16.h", str(host_tree / name)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]


@pytest.mark.parametrize("name", HEADERS)
def test_cuda_header_parses_alone_and_is_built(host_tree, name):
    """Each shared header reads as C++ on its own (its templates are
    instantiated where a source includes it), and some source includes
    it, so that a kernel build compiles it and its hash covers it."""
    proc = subprocess.run(
        ["g++", "-x", "c++", "-std=c++17", "-fsyntax-only", "-w", "-I",
         str(host_tree), "-include", "cuda_bf16.h", str(host_tree / name)],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert any(f'#include "{name}"' in (CSRC / src).read_text()
               for src in SOURCES + HEADERS)
