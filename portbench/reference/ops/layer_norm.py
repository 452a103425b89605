"""Plain LayerNorms (the port's ``ops/layer_norm.py`` plain versions,
frozen)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


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


residual_layer_norm = residual_layer_norm_plain
layer_norm_rows = layer_norm_rows_plain
