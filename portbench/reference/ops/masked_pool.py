"""Plain masked attention pool (the port's ``ops/masked_pool.py`` plain
version, frozen)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch


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


def masked_single_query_attention(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, key_mask: torch.Tensor,
                                  scale: Optional[float] = None
                                  ) -> torch.Tensor:
    """q (M, H, D), k/v (H, L, D) shared tokens, key_mask (M, L) True =
    attend -> (M, H, D)."""
    from .attention import note

    note("masked_pool", q=tuple(q.shape), v=tuple(v.shape), dtype=q.dtype)
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    return masked_pool_plain(q, k, v, key_mask, scale)
