"""Text towers for the CLIP family (port of ``ovo_tpu/models/text.py``).

A causal CLIP encoder pooled at the EOT (argmax) token, or a bidirectional
SigLIP encoder pooled at the last token; the projection may carry a bias
(open_clip SigLIP). Parameters are named as the JAX ``params["text"]`` tree.
Attention goes through ``ops/attention.dot_product_attention``: kernel B2 for
SigLIP's 64 tokens, the plain route for causal towers.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from . import layers as L


@dataclasses.dataclass(frozen=True)
class TextConfig:
    vocab_size: int = 49408
    context_length: int = 32
    width: int = 1024
    depth: int = 24
    n_heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024
    causal: bool = True
    pool: str = "argmax"      # argmax (CLIP EOT) | last | mean
    act: str = "gelu"         # gelu | quick_gelu (DFN '-qg' cards)
    dtype: torch.dtype = torch.float32


class TextTransformer(nn.Module):
    """Embedding table, learned positions, pre-LN blocks, final norm and
    projection; ``proj_bias`` only when the converted params carry it."""

    def __init__(self, cfg: TextConfig, device=None,
                 proj_bias: bool = False):
        super().__init__()
        self.cfg = cfg
        self.tok_embed = L._param((cfg.vocab_size, cfg.width), torch.float32,
                                device)
        self.pos = L._param((cfg.context_length, cfg.width), torch.float32,
                          device)
        self.blocks = nn.ModuleList(
            L.Block(cfg.width, cfg.n_heads, cfg.mlp_ratio, dtype=cfg.dtype,
                    device=device) for _ in range(cfg.depth))
        self.ln_final = L.LayerNorm(cfg.width, device=device)
        self.proj = L._param((cfg.width, cfg.embed_dim), torch.float32, device)
        self.proj_bias = L._param((cfg.embed_dim,), torch.float32, device) \
            if proj_bias else None


@torch.no_grad()
def init_text(cfg: TextConfig, generator: torch.Generator,
              device=None) -> TextTransformer:
    """Random weights with the reference's stds (``text.init_text``), drawn
    from ``generator`` on its device."""
    m = TextTransformer(cfg, device=device)
    g = generator
    L._normal(m.tok_embed, 0.02, g)
    L._normal(m.pos, 0.01, g)
    for blk in m.blocks:
        L.init_block_(blk, g)
    L.init_layer_norm_(m.ln_final)
    L._normal(m.proj, cfg.width ** -0.5, g)
    return m


@torch.no_grad()
def encode_text(model: TextTransformer, cfg: TextConfig,
                tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, context_length) integer ids on the model's device ->
    (B, embed_dim), unnormalized."""
    x = model.tok_embed[tokens.long()].to(cfg.dtype)
    x = x + model.pos.to(x.dtype)
    for blk in model.blocks:
        x = L.transformer_block(blk, x, cfg.n_heads, causal=cfg.causal,
                                act=cfg.act)
    x = model.ln_final(x)
    if cfg.pool == "argmax":
        idx = tokens.argmax(dim=-1)               # EOT has the highest id
        pooled = x[torch.arange(x.shape[0], device=x.device), idx]
    elif cfg.pool == "last":
        pooled = x[:, -1]
    else:
        pooled = x.mean(dim=1)
    out = pooled @ model.proj.to(pooled.dtype)
    if model.proj_bias is not None:
        out = out + model.proj_bias.to(out.dtype)
    return out


def text_from_jax_params(cfg: TextConfig, np_tree,
                         device=None) -> TextTransformer:
    """Text tower from the JAX ``params["text"]`` tree (numpy leaves)."""
    from .convert_jax import load_jax_params

    model = TextTransformer(cfg, device=device,
                            proj_bias=np_tree.get("proj_bias") is not None)
    return load_jax_params(model, np_tree, device)
