"""Masked single-query attention pooling: kernel B6 and its plain version.

Port of ``ovo_tpu/ops/masked_pool.py``. TextRegion pools one region
embedding per mask from the ViT patch grid with the PE probe head: one query
per mask, tokens SHARED across masks as (H, L, D) keys/values, and a per-mask
(M, L) key mask.

``masked_pool`` launches the hand-written kernel ``csrc/masked_pool.cu`` on
CUDA tensors (the tokens split into spans, :func:`pool_span`, each span's
partial softmax in an f32 workspace, then their combine) and runs
:func:`masked_pool_plain` on CPU tensors.
``masked_single_query_attention`` is the dispatcher the models call.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def masked_pool_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      key_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain PyTorch version of kernel B6 (``_pool_kernel`` semantics):
    q (M, H, D), k/v (H, L, D), key_mask (M, L) bool/u8 (nonzero = attend)
    -> (M, H, D). All math in f32; masked scores -1e30; max-subtracted
    softmax with the denominator clamped at 1e-30, so a fully masked row
    pools the uniform mean of v."""
    qf = q.float() * scale
    s = torch.einsum("mhd,hld->mhl", qf, k.float())
    s = torch.where(key_mask.bool()[:, None, :], s, torch.full_like(s, -1e30))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("mhl,hld->mhd", p, v.float()).to(q.dtype)


def masked_pool(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                key_mask: torch.Tensor, scale: float) -> torch.Tensor:
    """Kernel B6 wrapper. k and v may be strided views (unit stride on the
    last dim): the broadcast k of TextRegion and its head-transposed v are
    read in place. CPU tensors run :func:`masked_pool_plain`; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return masked_pool_plain(q, k, v, key_mask, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    M, H, D = q.shape
    if k.shape != (H, k.shape[1], D) or v.shape != k.shape:
        raise ValueError(f"k/v must be ({H}, L, {D}); got {tuple(k.shape)} "
                         f"/ {tuple(v.shape)}")
    L = k.shape[1]
    if key_mask.shape != (M, L):
        raise ValueError(f"key_mask must be ({M}, {L}), got "
                         f"{tuple(key_mask.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q/k/v must share f32 or bf16, got {q.dtype}, "
                         f"{k.dtype}, {v.dtype}")
    if key_mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"key_mask must be bool or uint8, got "
                         f"{key_mask.dtype}")
    if not (D % 16 == 0 and 16 <= D <= 128):
        raise ValueError(f"head dim {D} not a multiple of 16 in [16, 128]")
    for name, t in (("k", k), ("v", v), ("key_mask", key_mask), ("q", q)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not (q.is_contiguous() and key_mask.is_contiguous()
            and k.stride(2) == 1 and v.stride(2) == 1):
        raise ValueError("q and key_mask must be contiguous, k/v need unit "
                         "stride on the head dim")
    mask_u8 = key_mask.view(torch.uint8) if key_mask.dtype == torch.bool \
        else key_mask
    span = pool_span(M, H, L, torch.cuda.get_device_properties(
        q.device).multi_processor_count)
    n_spans = -(-L // span)
    out = torch.empty((M, H, D), dtype=q.dtype, device=q.device)
    ws = torch.empty((n_spans * H * M * (D + 2),), dtype=torch.float32,
                     device=q.device)
    fn = cuda_build.library("masked_pool").ovo_masked_pool
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong] * 4 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), mask_u8.data_ptr(),
                 out.data_ptr(), ws.data_ptr(), M, H, L, D, k.stride(0),
                 k.stride(1), v.stride(0), v.stride(1), float(scale), span,
                 _DTYPES[q.dtype], stream)
    cuda_build.check(err, "masked_pool")
    cuda_build.count_launch("masked_pool")
    return out


def pool_span(M: int, H: int, L: int, n_sm: int) -> int:
    """Tokens per span of B6's split grid: the longest multiple of the
    kernel's 64-token chunk that still gives at least twice ``n_sm``
    blocks of (span, head, 128 masks), or one chunk where no span
    length does."""
    chunks = -(-L // 64)
    groups = -(-M // 128)
    return 64 * max(1, chunks * H * groups // (2 * n_sm))


def masked_single_query_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, key_mask: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """Dispatcher (``masked_pool.py:89-105``): q (M, H, D), k/v (H, L, D)
    shared tokens, key_mask (M, L) True = attend -> (M, H, D)."""
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    return masked_pool(q, k, v, key_mask, scale)
