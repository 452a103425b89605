"""Shared transformer building blocks (port of ``ovo_tpu/models/layers.py``).

Modules keep the JAX param tree's names (``ln1.scale``, ``attn.qkv.w``, ...)
so ``models/convert_jax.py`` fills them by path, and linear weights keep the
JAX layout ``(d_in, d_out)`` with ``y = x @ w``. Matmul weights and biases
live in the compute dtype (the reference casts them to it on every call, so
the numbers are the same); LayerNorm params stay f32, as the reference's
statistics and affine run in f32. Self-attention with RoPE goes through
kernel B5 (``ops/attention.rope_packed_attention``); without RoPE through
``ops/attention.dot_product_attention`` (kernel B10, B2 or B1, or the plain
route for causal attention and head sizes above 128).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import (apply_rope, dot_product_attention,
                             rope_packed_attention, xla_attention)

def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Statistics and affine in f32, result in x's dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf gelu for f32, tanh approximation for bf16 (the reference's
    choice: the two agree after bf16 rounding)."""
    if x.dtype == torch.bfloat16:
        return F.gelu(x, approximate="tanh")
    return F.gelu(x)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


ACTS = {"gelu": gelu, "quick_gelu": quick_gelu}


def rope2d_freqs(grid_h: int, grid_w: int, head_dim: int,
                 theta: float = 10000.0, n_prefix: int = 0,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of shape (n_prefix + grid_h*grid_w, head_dim/2), f32.
    Half of the rotated dims follow x, half y; prefix tokens (cls) get the
    identity rotation."""
    if head_dim % 4:
        raise ValueError(f"head_dim {head_dim} not a multiple of 4")
    quarter = head_dim // 4
    ar = torch.arange(quarter, dtype=torch.float32, device=device)
    freqs = 1.0 / torch.pow(theta, ar / quarter)
    ys, xs = torch.meshgrid(
        torch.arange(grid_h, dtype=torch.float32, device=device),
        torch.arange(grid_w, dtype=torch.float32, device=device),
        indexing="ij")
    ang = torch.cat([xs.reshape(-1, 1) * freqs[None, :],
                     ys.reshape(-1, 1) * freqs[None, :]], dim=-1)
    if n_prefix:
        ang = torch.cat([ang.new_zeros((n_prefix, ang.shape[-1])), ang])
    return torch.cos(ang), torch.sin(ang)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` (d_in, d_out), the JAX layout."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.b = _param((d_out,), dtype, device) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.w, self.b)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)
        self.bias = _param((d,), torch.float32, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class Mlp(nn.Module):
    def __init__(self, width: int, hidden: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.fc = Linear(width, hidden, dtype=dtype, device=device)
        self.proj = Linear(hidden, width, dtype=dtype, device=device)


class Attention(nn.Module):
    """Self-attention with a merged qkv projection."""

    def __init__(self, width: int, dtype=torch.float32, device=None):
        super().__init__()
        self.qkv = Linear(width, 3 * width, dtype=dtype, device=device)
        self.out = Linear(width, width, dtype=dtype, device=device)


class Block(nn.Module):
    """Pre-LN transformer block with optional LayerScale (ls1 / ls2)."""

    def __init__(self, width: int, n_heads: int, mlp_ratio: float = 4.0,
                 layer_scale: Optional[float] = None, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.n_heads = n_heads
        self.ln1 = LayerNorm(width, device=device)
        self.attn = Attention(width, dtype=dtype, device=device)
        self.ln2 = LayerNorm(width, device=device)
        self.mlp = Mlp(width, int(width * mlp_ratio), dtype=dtype,
                       device=device)
        if layer_scale is not None:
            self.ls1 = _param((width,), torch.float32, device)
            self.ls2 = _param((width,), torch.float32, device)
        else:
            self.ls1 = self.ls2 = None


def mlp(p: Mlp, x: torch.Tensor, act=gelu) -> torch.Tensor:
    return p.proj(act(p.fc(x)))


def multi_head_attention(p: Attention, x: torch.Tensor, n_heads: int,
                         rope: Optional[Tuple[torch.Tensor,
                                              torch.Tensor]] = None,
                         causal: bool = False, attn_impl: str = "auto",
                         n_valid: Optional[int] = None) -> torch.Tensor:
    """Self-attention over x (B, L, D). Under ``attn_impl="auto"`` a RoPE
    layer goes through kernel B5 (packed qkv in, token-major out), whose
    wrapper raises on a CUDA tensor it cannot take, and a layer without
    RoPE goes through ``dot_product_attention`` on either device.
    ``attn_impl="xla"`` runs the composed plain path (``xla_attention``),
    with or without RoPE, on the CPU only: it is the reference the CPU tests
    hold the kernel routes against. ``n_valid``: the real token count when
    the caller pre-padded the token axis for the whole tower (padded keys
    are masked)."""
    if attn_impl not in ("auto", "xla"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    kernel = rope is not None and attn_impl == "auto" and not causal
    plain = attn_impl == "xla" or (rope is not None and not kernel)
    B, L, D = x.shape
    hd = D // n_heads
    qkv = p.qkv(x)
    # a tensor-parallel rank's qkv holds its own heads only
    # (parallel/mesh.tp_shard_tower)
    Dq = qkv.shape[-1] // 3
    hq = Dq // hd
    if kernel:
        cos, sin = rope
        o = rope_packed_attention(qkv, cos[:L].contiguous(),
                                  sin[:L].contiguous(), heads=hq,
                                  kv_len=n_valid)
        return p.out(o)

    def heads(t):
        return t.reshape(B, L, hq, hd).transpose(1, 2)

    q, k, v = (heads(t) for t in qkv.split(Dq, dim=-1))
    mask = None
    if n_valid is not None and n_valid < L:
        mask = (torch.arange(L, device=x.device) < n_valid)[None, None,
                                                            None, :]
    if rope is not None:
        cos, sin = rope
        q = apply_rope(q, cos[:L], sin[:L])
        k = apply_rope(k, cos[:L], sin[:L])
    if plain:
        if causal and mask is None:
            mask = torch.ones((L, L), dtype=torch.bool,
                              device=x.device).tril()[None, None]
        o = xla_attention(q, k, v, mask=mask)
    else:
        o = dot_product_attention(q, k, v, mask=mask, causal=causal)
    return p.out(o.transpose(1, 2).reshape(B, L, Dq))


def transformer_block(p: Block, x: torch.Tensor, n_heads: int,
                      rope: Optional[Tuple[torch.Tensor,
                                           torch.Tensor]] = None,
                      causal: bool = False, attn_impl: str = "auto",
                      act: str = "gelu",
                      n_valid: Optional[int] = None) -> torch.Tensor:
    h = multi_head_attention(p.attn, p.ln1(x), n_heads, rope=rope,
                             causal=causal, attn_impl=attn_impl,
                             n_valid=n_valid)
    if p.ls1 is not None:
        h = h * p.ls1.to(h.dtype)
    x = x + h
    h = mlp(p.mlp, p.ln2(x), act=ACTS[act])
    if p.ls2 is not None:
        h = h * p.ls2.to(h.dtype)
    return x + h


# ---------------------------------------------------------------------------
# random init (same stds as layers.init_*; real weights come through
# models/convert_jax.py)
# ---------------------------------------------------------------------------

def _normal(t: torch.Tensor, std: float, gen: torch.Generator) -> None:
    t.copy_(torch.randn(t.shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std)


@torch.no_grad()
def init_linear_(p: Linear, gen: torch.Generator,
                 std: Optional[float] = None) -> None:
    _normal(p.w, std if std is not None else p.w.shape[0] ** -0.5, gen)
    if p.b is not None:
        p.b.zero_()


@torch.no_grad()
def init_layer_norm_(p: LayerNorm) -> None:
    p.scale.fill_(1.0)
    p.bias.zero_()


@torch.no_grad()
def init_block_(p: Block, gen: torch.Generator,
                layer_scale: Optional[float] = None) -> None:
    init_layer_norm_(p.ln1)
    init_linear_(p.attn.qkv, gen)
    init_linear_(p.attn.out, gen)
    init_layer_norm_(p.ln2)
    init_linear_(p.mlp.fc, gen)
    init_linear_(p.mlp.proj, gen)
    if p.ls1 is not None:
        p.ls1.fill_(layer_scale)
        p.ls2.fill_(layer_scale)
