"""Learned 3-descriptor merger and its train step (port of
``ovo_tpu/models/merger.py``).

A transformer encoder over the three candidate CLIP vectors of a segment
(global / masked crop / bbox crop), an MLP head giving one logit per token,
softmax weights, the weighted sum, L2-normalized. Its attention has head size
144 (1152 / 8), which the reference routes to XLA: here the plain route of
``ops/attention.dot_product_attention``, on either device. So neither the
forward nor the train step (autograd through that forward, then
``torch.optim.Adam``) launches a kernel. The trained ``model.pt`` loads
through ``models/convert.py``.
"""
from __future__ import annotations


import torch
from torch import nn

from . import layers as L


class _Head(nn.Module):
    def __init__(self, d_model: int, mlp_hidden: int, device=None):
        super().__init__()
        self.fc = L.Linear(d_model, mlp_hidden, device=device)
        self.proj = L.Linear(mlp_hidden, 1, device=device)


class MergerParams(nn.Module):
    """Parameters named as the JAX merger tree (``blocks.i.*``,
    ``head.fc``, ``head.proj``)."""

    def __init__(self, d_model: int = 1152, depth: int = 5, n_heads: int = 8,
                 mlp_hidden: int = 512, device=None):
        super().__init__()
        self.blocks = nn.ModuleList(
            L.Block(d_model, n_heads, mlp_ratio=4.0, device=device)
            for _ in range(depth))
        self.head = _Head(d_model, mlp_hidden, device)


@torch.no_grad()
def init_merger(generator: torch.Generator, d_model: int = 1152,
                depth: int = 5, n_heads: int = 8, mlp_hidden: int = 512,
                device=None) -> MergerParams:
    """Random weights with the reference's stds (``merger.init_merger``),
    drawn from ``generator`` on its device."""
    m = MergerParams(d_model, depth, n_heads, mlp_hidden, device=device)
    for blk in m.blocks:
        L.init_block_(blk, generator)
    L.init_linear_(m.head.fc, generator)
    L.init_linear_(m.head.proj, generator)
    return m


def merger_forward(params: MergerParams, clips: torch.Tensor,
                   n_heads: int = 8) -> torch.Tensor:
    """clips (B, 3, D) -> fused (B, D): transformer over the 3 tokens,
    per-token scalar -> softmax weights -> weighted sum -> normalize.
    Differentiable: the train step's forward."""
    x = clips
    for blk in params.blocks:
        x = L.transformer_block(blk, x, n_heads)
    logits = params.head.proj(torch.relu(params.head.fc(x)))[..., 0]
    w = torch.softmax(logits, dim=-1)                      # (B, 3)
    fused = torch.einsum("bk,bkd->bd", w.float(), clips.float())
    return fused / torch.linalg.vector_norm(
        fused, dim=-1, keepdim=True).clamp_min(1e-12)


@torch.no_grad()
def merger_apply(params: MergerParams, clips: torch.Tensor,
                 n_heads: int = 8) -> torch.Tensor:
    """:func:`merger_forward` for inference (no autograd graph)."""
    return merger_forward(params, clips, n_heads)


class LearnedMerger:
    def __init__(self, params: MergerParams, n_heads: int = 8):
        self.params = params
        self.n_heads = n_heads

    def __call__(self, clips: torch.Tensor) -> torch.Tensor:
        return merger_apply(self.params, clips, self.n_heads)
