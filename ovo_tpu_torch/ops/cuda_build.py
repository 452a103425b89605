"""Build and load the hand-written Hopper kernels.

Each ``ovo_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``. Libraries land in ``build/ovo_tpu_torch/`` at the repo
root (git-ignored), named by a hash of their source, so a stale build is
never reused. Nothing is compiled at import: the first launch builds, or a
caller builds every kernel up front with :func:`build_all` (all ``nvcc``
processes started together).

Every wrapper counts its kernel launches here (:func:`count_launch`), so a
run can show that the main path went through the kernels; while a profiler
runs they are also counted under the innermost program span
(``utils/trace.py``, ``port_launches.<span>``). A wrapper that
calls its C entry point through an :class:`Entry` pays for the ctypes
signature once, when the library loads, not on every launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

import torch

from ..utils import trace

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ovo_tpu_torch"
KERNELS = ("rope_packed_attention", "masked_pool", "flash_attention",
           "windowed_attention", "cross_t2i", "cross_i2t_tail",
           "fused_attention", "fused_attn_block", "fused_mlp_block",
           "cross_small_head", "cross_i2t_proj", "residual_layer_norm",
           "packed_heads_attention", "mask_tail")
# launches are counted per kernel: one per library, but for the libraries
# that hold two kernels (B9a / B9b, B8 / B14)
_TWO_KERNELS = {
    "cross_small_head": ("cross_small_head_t2i", "cross_small_head_i2t"),
    "residual_layer_norm": ("residual_layer_norm", "layer_norm_rows")}
LAUNCH_NAMES = tuple(n for k in KERNELS for n in _TWO_KERNELS.get(k, (k,)))
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_launches: Dict[str, int] = {name: 0 for name in LAUNCH_NAMES}


def count_launch(name: str) -> None:
    _launches[name] += 1
    trace.count_launch()


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("ovo_tpu_torch: nvcc not found; the CUDA kernels "
                       "build only on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) are part of every source's hash
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> float:
    """Compile every listed kernel that is not built yet, one ``nvcc`` per
    source, all started together. Returns the wall seconds taken; raises
    with the compiler's output if any build fails."""
    names = list(names or KERNELS)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    procs = []
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(BUILD_DIR / f"{name}.build.log", "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, log,
                      subprocess.Popen(cmd, stdout=log,
                                       stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc != 0:
            failed.append((name, (BUILD_DIR / f"{name}.build.log").read_text()))
        else:
            os.replace(tmp, out)
    if failed:
        msg = "\n".join(f"--- {n} ---\n{txt}" for n, txt in failed)
        raise RuntimeError(f"ovo_tpu_torch: kernel build failed:\n{msg}")
    return time.time() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"ovo_tpu_torch: {name} launch failed with "
                           f"cudaError_t {err}")


# The device and stream queries of Entry: torch's private raw-stream query
# builds no Stream object per launch; where a torch build lacks either
# private name, the public calls stand in (a few microseconds more a call).
_current_device = getattr(torch._C, "_cuda_getDevice", None) \
    or torch.cuda.current_device
_current_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
    or (lambda index: torch.cuda.current_stream(index).cuda_stream)


class Entry:
    """The C entry point ``symbol`` of kernel library ``lib``, its argument
    types (``argtypes``, the trailing stream left out) and ``int`` result
    set once, when the library is first loaded (built on first use, as
    :func:`library`). ``entry(index, *args)`` calls it on the current
    stream of CUDA device ``index`` and returns its ``cudaError_t``; the
    device is made current for the call only when it is not already. With
    ``stream=False`` the entry point takes no stream (a host-side query):
    ``entry.fn(*args)`` calls it."""

    __slots__ = ("lib", "symbol", "argtypes", "_fn")

    def __init__(self, lib: str, symbol: str, argtypes: Sequence, *,
                 stream: bool = True):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [*argtypes, *([ctypes.c_void_p] if stream else [])]
        self._fn = None

    @property
    def fn(self):
        """The ctypes function, its signature set (loads the library)."""
        if self._fn is None:
            fn = getattr(library(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def __call__(self, index: int, *args) -> int:
        fn = self.fn
        # the device is initialized: it holds the caller's tensors
        if index == _current_device():
            return fn(*args, _current_raw_stream(index))
        with torch.cuda.device(index):
            return fn(*args, _current_raw_stream(index))
