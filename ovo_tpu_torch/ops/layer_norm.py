"""Row LayerNorms: the fused residual + LayerNorm of the SAM decoder's
image side (norm4, kernel B8) and the plain row LayerNorm (kernel B14),
each with its plain version.

B8 is the port of ``ovo_tpu/ops/layer_norm.py:148`` (``residual_layer_norm`` ->
``_res_ln_call``): LayerNorm(x + res) over the last axis with the sum,
the statistics (``mean((x - mean)^2)``, two passes) and the affine in f32,
and one cast of the output to x's dtype. A batch-1 residual is read
through a batch stride of 0, never broadcast in memory.

The reference gates its kernel with ``res_ln_fits`` (a lane-tileable C, a
row block within the VMEM budget, and at least 65536 rows to beat XLA's
dispatch); the CUDA kernel takes any C that is a multiple of 4 up to 1024,
so inside the decoder's unfused and proj routes norm4 always launches it
on the card.

B14 is the port of ``ovo_tpu/ops/layer_norm.py:82`` (``layer_norm_rows`` ->
``_ln_call``): the same LayerNorm without the residual, over the last axis
of any leading shape, C up to 2048. The reference wires it into no tower
(its shape gate ``fits`` is kept here, as the reference has it, for the
callers that drive it by name); nothing in the port's towers calls it.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 1024          # B8
ROWS_MAX_C = 2048     # B14
# the reference's TPU gate (scoped-VMEM budget of a row block)
_VMEM_BUDGET = 12 * 1024 * 1024


def _ln_f32(xf: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            eps: float) -> torch.Tensor:
    """LayerNorm of an f32 tensor over its last axis: two-pass statistics
    (``mean((x - mean)^2)``) and the affine in f32."""
    mean = xf.mean(dim=-1, keepdim=True)
    cen = xf - mean
    var = (cen * cen).mean(dim=-1, keepdim=True)
    return cen * torch.rsqrt(var + eps) * scale.float() + bias.float()


def residual_layer_norm_plain(x: torch.Tensor, res: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of kernel B8 (``_res_ln_kernel``)."""
    return _ln_f32(x.float() + res.float(), scale, bias, eps).to(x.dtype)


def layer_norm_rows_plain(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor, eps: float = 1e-5
                          ) -> torch.Tensor:
    """Plain PyTorch version of kernel B14 (``_ln_kernel``)."""
    return _ln_f32(x.float(), scale, bias, eps).to(x.dtype)


def _row_block(c: int, itemsize: int):
    for rb in (1024, 512, 256, 128, 64, 32, 16, 8):
        if 2 * itemsize * (2 * rb * c) + 4 * rb * c <= _VMEM_BUDGET:
            return rb
    return None


def fits(rows: int, c: int, itemsize: int) -> bool:
    """The reference's shape gate of ``layer_norm_rows``
    (``ovo_tpu/ops/layer_norm.py:74``): a lane-tileable C, a row block
    within the TPU's VMEM budget, and at least 1024 rows."""
    return c % 128 == 0 and rows >= 1024 and _row_block(c, itemsize) \
        is not None


# ovo_layer_norm_rows(x, scale, bias, out, rows, C, eps, dtype, sdtype)
_LN_ROWS = cuda_build.Entry(
    "residual_layer_norm", "ovo_layer_norm_rows",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, ctypes.c_int])


# ovo_residual_layer_norm(x, res, scale, bias, out, B, L, C, r_sb, eps, dtype)
_RES_LN = cuda_build.Entry(
    "residual_layer_norm", "ovo_residual_layer_norm",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_float, ctypes.c_int])


def layer_norm_rows(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of ``x`` (any leading shape), scale /
    bias (C,): the statistics and the affine in f32, one cast to x's dtype.

    CPU tensors run :func:`layer_norm_rows_plain`; CUDA tensors launch
    kernel B14 (``csrc/residual_layer_norm.cu``, ``ovo_layer_norm_rows``)
    or raise. The kernel reads f32 or bf16 scale / bias as they are (the
    two in one dtype; any other pair is cast to f32 first)."""
    if x.dim() < 1:
        raise ValueError("layer_norm_rows: x needs a last axis")
    C = x.shape[-1]
    if scale.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"layer_norm_rows: scale / bias must be ({C},)")
    if not x.is_cuda:
        if x.device.type == "cpu":
            return layer_norm_rows_plain(x, scale, bias, eps)
        raise ValueError(f"layer_norm_rows: kernel takes CUDA tensors, got "
                         f"{x.device}")
    dt = _DTYPES.get(x.dtype)
    if dt is None:
        raise ValueError(f"layer_norm_rows: kernel takes f32 / bf16, got "
                         f"{x.dtype}")
    if C % 4 or C > ROWS_MAX_C:
        raise ValueError(f"layer_norm_rows: C must be a multiple of 4 up to "
                         f"{ROWS_MAX_C}, got {C}")
    if not x.is_contiguous():
        raise ValueError("layer_norm_rows: x must be contiguous")
    if scale.dtype != bias.dtype or scale.dtype not in _DTYPES:
        scale, bias = scale.float(), bias.float()
    scale, bias = scale.contiguous(), bias.contiguous()
    index = x.get_device()
    if scale.get_device() != index or bias.get_device() != index:
        raise ValueError(f"layer_norm_rows: scale / bias must be on "
                         f"{x.device}")
    out = torch.empty_like(x)
    px, pg, pb = x.data_ptr(), scale.data_ptr(), bias.data_ptr()
    if (px | pg | pb) % 16:
        raise ValueError("layer_norm_rows: inputs must be 16-byte aligned")
    if x.numel() == 0:
        return out
    cuda_build.check(_LN_ROWS(index, px, pg, pb, out.data_ptr(),
                              x.numel() // C, C, float(eps), dt,
                              _DTYPES[scale.dtype]), "layer_norm_rows")
    cuda_build.count_launch("layer_norm_rows")
    return out


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
    r_sb = L * C if res.shape[0] > 1 else 0
    cuda_build.check(_RES_LN(x.get_device(), x.data_ptr(), res.data_ptr(),
                             g.data_ptr(), b.data_ptr(), out.data_ptr(), B, L,
                             C, r_sb, float(eps), _DTYPES[x.dtype]),
                     "residual_layer_norm")
    cuda_build.count_launch("residual_layer_norm")
    return out
