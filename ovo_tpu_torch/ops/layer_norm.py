"""The fused residual + LayerNorm of the SAM decoder's image side (norm4):
kernel B8 and its plain version.

Port of ``ovo_tpu/ops/layer_norm.py:148`` (``residual_layer_norm`` ->
``_res_ln_call``): LayerNorm(x + res) over the last axis with the sum,
the statistics (``mean((x - mean)^2)``, two passes) and the affine in f32,
and one cast of the output to x's dtype. A batch-1 residual is read
through a batch stride of 0, never broadcast in memory.

The reference gates its kernel with ``res_ln_fits`` (a lane-tileable C, a
row block within the VMEM budget, and at least 65536 rows to beat XLA's
dispatch); the CUDA kernel takes any C that is a multiple of 4 up to 1024,
so inside the decoder's unfused and proj routes norm4 always launches it
on the card.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 1024


def residual_layer_norm_plain(x: torch.Tensor, res: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of kernel B8 (``_res_ln_kernel``)."""
    xf = x.float() + res.float()
    mean = xf.mean(dim=-1, keepdim=True)
    cen = xf - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    y = cen * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def residual_layer_norm(x: torch.Tensor, res: torch.Tensor,
                        scale: torch.Tensor, bias: torch.Tensor,
                        eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm(x + res) over the last axis: x (B, L, C), res (B or 1, L,
    C), scale / bias (C,) -> (B, L, C) in x's dtype.

    CPU tensors run :func:`residual_layer_norm_plain`; CUDA tensors launch
    kernel B8 (``csrc/residual_layer_norm.cu``) or raise."""
    if x.dim() != 3 or res.dim() != 3 or res.shape[1:] != x.shape[1:] \
            or res.shape[0] not in (1, x.shape[0]):
        raise ValueError(f"residual_layer_norm: x (B, L, C) and res (B or 1, "
                         f"L, C) expected, got {tuple(x.shape)} / "
                         f"{tuple(res.shape)}")
    B, L, C = x.shape
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"residual_layer_norm: scale / bias must be ({C},)")
    if x.device.type == "cpu":
        return residual_layer_norm_plain(x, res, scale, bias, eps)
    if x.device.type != "cuda" or x.dtype not in _DTYPES:
        raise ValueError(f"residual_layer_norm: kernel takes f32 / bf16 CUDA "
                         f"tensors, got {x.dtype} on {x.device}")
    if res.device != x.device or res.dtype != x.dtype:
        raise ValueError("residual_layer_norm: res must share x's device and "
                         "dtype")
    if C % 4 or C > MAX_C:
        raise ValueError(f"residual_layer_norm: C must be a multiple of 4 up "
                         f"to {MAX_C}, got {C}")
    if not (x.is_contiguous() and res.is_contiguous()):
        raise ValueError("residual_layer_norm: x and res must be contiguous")
    g, b = scale.float().contiguous(), bias.float().contiguous()
    if g.device != x.device or b.device != x.device:
        raise ValueError(f"residual_layer_norm: scale / bias must be on "
                         f"{x.device}")
    if any(t.data_ptr() % 16 for t in (x, res, g, b)):
        raise ValueError("residual_layer_norm: inputs must be 16-byte "
                         "aligned")
    out = torch.empty_like(x)
    fn = cuda_build.library("residual_layer_norm").ovo_residual_layer_norm
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    r_sb = L * C if res.shape[0] > 1 else 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), res.data_ptr(), g.data_ptr(), b.data_ptr(),
                 out.data_ptr(), B, L, C, r_sb, float(eps), _DTYPES[x.dtype],
                 stream)
    cuda_build.check(err, "residual_layer_norm")
    cuda_build.count_launch("residual_layer_norm")
    return out
