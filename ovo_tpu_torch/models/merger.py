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

import os
from typing import Callable, Optional

import torch
from torch import nn

from .. import resolve_device
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


def merger_loss(params: MergerParams, clips: torch.Tensor,
                target: torch.Tensor, n_heads: int = 8) -> torch.Tensor:
    """Cosine-distance regression against target descriptors (how the
    reference's merger was trained offline): the batch mean of
    ``1 - cos(fused, target / max(|target|, 1e-12))``."""
    fused = merger_forward(params, clips, n_heads)
    tgt = target / torch.linalg.vector_norm(
        target, dim=-1, keepdim=True).clamp_min(1e-12)
    return (1.0 - (fused * tgt).sum(dim=-1)).mean()


def make_train_step(params: MergerParams, lr: float, n_heads: int = 8,
                    grad_hook: Optional[Callable[[MergerParams], None]] = None
                    ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """A step ``(clips, target) -> loss`` that updates ``params`` in place
    with Adam (``optax.adam(lr)``'s function: b1 0.9, b2 0.999, eps 1e-8
    added to the bias-corrected sqrt(v), rounded in another order).
    ``grad_hook(params)`` runs between ``backward()`` and the update (the
    data-parallel step averages the gradients across ranks there); without
    it the step is single-device. No kernel is differentiated: the head size
    is 144, so attention takes the plain route on either device; on the
    card a head size that would take a kernel route raises (the kernels
    have no backward)."""
    from ..ops.attention import MAX_HEAD_DIM

    dev = next(params.parameters()).device
    hd = params.blocks[0].attn.qkv.w.shape[0] // n_heads \
        if len(params.blocks) else MAX_HEAD_DIM + 1
    if dev.type != "cpu" and hd <= MAX_HEAD_DIM:
        raise ValueError(
            f"head size {hd}: attention on {dev} would take a kernel route, "
            f"which has no backward; the train step differentiates the "
            f"plain route (head size above {MAX_HEAD_DIM}, as the merger's "
            f"144)")
    params.requires_grad_(True)
    optimizer = torch.optim.Adam(params.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)

    def train_step(clips: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = merger_loss(params, clips, target, n_heads)
        loss.backward()
        if grad_hook is not None:
            grad_hook(params)
        optimizer.step()
        return loss.detach()

    return train_step


class LearnedMerger:
    def __init__(self, params: MergerParams, n_heads: int = 8):
        self.params = params
        self.n_heads = n_heads

    def __call__(self, clips: torch.Tensor) -> torch.Tensor:
        return merger_apply(self.params, clips, self.n_heads)


def load_merger(path: Optional[str], device="cuda",
                seed: int = 0) -> LearnedMerger:
    """The reference's trained merger if ``path/model.pt`` exists (loaded as
    the reference loads it: ``torch.load``, ``convert_merger_state_dict``),
    else seeded random weights of the same structure on ``device``."""
    dev = resolve_device(device)
    if path and os.path.exists(os.path.join(path, "model.pt")):
        from .convert import convert_merger_state_dict
        from .convert_jax import merger_from_jax_params

        sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                        weights_only=False)
        return merger_from_jax_params(convert_merger_state_dict(sd), dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return LearnedMerger(init_merger(gen, device=dev))
