"""Plain fused mask tail (the port's ``ops/mask_tail.py`` plain version,
frozen)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


def gelu_tanh_bf16(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` on a bf16 tensor, each op
    rounded to bf16 in JAX's order: ``0.5 * (1 + tanh(sqrt(2/pi) * (x +
    0.044715 * x**3)))``, then ``x * cdf``. (A Python-float factor of a bf16
    tensor multiplies in f32 and rounds once, so the pre-rounded constants
    give JAX's bf16 products.)"""
    x3 = x * (x * x)
    cdf = 0.5 * (1.0 + torch.tanh(_GELU_S * (x + _GELU_A * x3)))
    return x * cdf


def fused_mask_tail_plain(up1g: torch.Tensor, w2q: torch.Tensor,
                          b2: torch.Tensor, hr0q: torch.Tensor,
                          hyper: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel B13 (``_mask_tail_kernel``), per
    tap: f32 product, bf16 cast, + b2, + hr0q[tap] (each rounded), bf16
    tanh-gelu, f32 hypernet dot. -> (B, 4, R, C) f32."""
    hyp_t = hyper.float().transpose(1, 2)                    # (B, c2, C)
    taps = []
    for t in range(4):
        y = torch.matmul(up1g.float(), w2q[t].float()).to(torch.bfloat16)
        y = gelu_tanh_bf16(y + b2 + hr0q[t])
        taps.append(torch.matmul(y.float(), hyp_t))
    return torch.stack(taps, dim=1)


def gather_hr0q(hr0: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """The (4H, 4W, c2) raster high-res skip -> (4, H*W*4, c2) in the
    kernel's (tap, (h, w, i, j) row, channel) order."""
    c2 = hr0.shape[-1]
    return hr0.reshape(H, 2, 2, W, 2, 2, c2).permute(
        2, 5, 0, 3, 1, 4, 6).reshape(4, H * W * 4, c2)


def mask_tail_to_raster(masks4: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, 4, H*W*4, C) kernel output -> raster (B, C, 4H, 4W) f32."""
    B, _, _, C = masks4.shape
    m = masks4.reshape(B, 2, 2, H, W, 2, 2, C)     # (b, p, q, h, w, i, j, c)
    m = m.permute(0, 7, 3, 5, 1, 4, 6, 2)          # (b, c, h, i, p, w, j, q)
    return m.reshape(B, C, 4 * H, 4 * W)


def fused_mask_tail(up1g, w2q, b2, hr0q, hyper, *, H, W):
    return fused_mask_tail_plain(up1g, w2q, b2, hr0q, hyper, H=H, W=W)
