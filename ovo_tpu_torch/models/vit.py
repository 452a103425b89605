"""Vision transformer for the PE / CLIP image towers (port of
``ovo_tpu/models/vit.py``).

Patchify (a stride-p convolution over HWIO weights, run as one f32 matmul
over unfolded patches), optional class token and learned absolute position
embedding, optional RoPE-2D, a pre-LN transformer stack and probe attention
pooling. ``forward_features`` gives the normalized token grid TextRegion
consumes; ``encode`` the pooled, projected embedding.

RoPE attention always goes through kernel B5's wrapper, so the token
stream is padded once for the whole tower to a multiple of 8 with the real
count passed as ``kv_len`` (``vit.py:160-185``); padded rows stay row-local
and are sliced off before ``ln_post``. Attention without RoPE (the SigLIP
and DFN towers) goes through ``ops/attention.dot_product_attention``, at the
SigLIP-384 length of 729 tokens kernel B10, with no padding.

The whole-block path (``attn_impl="fused_block"``, or ``OVO_FUSED_BLOCK=1``
under ``"auto"`` on the card) runs each block through kernels B12a and
B12b (``ops/fused_block.py``); towers with LayerScale take the per-layer
path. It needs no pad: keys past the real count are masked in the kernel.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Callable, Optional

import torch
from torch import nn

from ..ops.resize import bilinear_weight_mat
from . import layers as L


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 336
    patch_size: int = 14
    width: int = 1024
    depth: int = 24
    n_heads: int = 16
    mlp_ratio: float = 4.0
    embed_dim: int = 1024
    use_cls_token: bool = True
    use_abs_pos: bool = True
    use_rope2d: bool = False
    pool: str = "attn"              # cls | mean | attn
    layer_scale: Optional[float] = None
    ln_pre: bool = False
    act: str = "gelu"               # gelu | quick_gelu
    dtype: torch.dtype = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_tokens(self) -> int:
        return self.grid * self.grid + (1 if self.use_cls_token else 0)


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class PatchEmbed(nn.Module):
    """``w`` (p, p, 3, width) HWIO in the compute dtype, ``b`` f32 (the
    reference adds it to the f32 convolution output)."""

    def __init__(self, patch: int, width: int, dtype, device=None):
        super().__init__()
        self.w = _param((patch, patch, 3, width), dtype, device)
        self.b = _param((width,), torch.float32, device)


class AttnPool(nn.Module):
    """PE probe attention-pooling head; with ``mlp_hidden`` also the SigLIP
    MAP head's residual MLP (``ln2`` + ``mlp``, timm AttentionPoolLatent),
    present only when the converted params carry it. ``ln=False``: no norm
    on the keys' input (timm's MAP head, as converted)."""

    def __init__(self, width: int, dtype, device=None,
                 mlp_hidden: Optional[int] = None, ln: bool = True):
        super().__init__()
        self.probe = _param((1, width), torch.float32, device)
        self.ln = L.LayerNorm(width, device=device) if ln else None
        self.q = L.Linear(width, width, dtype=dtype, device=device)
        self.k = L.Linear(width, width, dtype=dtype, device=device)
        self.v = L.Linear(width, width, dtype=dtype, device=device)
        self.out = L.Linear(width, width, dtype=dtype, device=device)
        if mlp_hidden is not None:
            self.ln2 = L.LayerNorm(width, device=device)
            self.mlp = L.Mlp(width, mlp_hidden, dtype=dtype, device=device)
        else:
            self.ln2 = self.mlp = None


class VisionTransformer(nn.Module):
    """Parameters named as the JAX ``params["visual"]`` tree.
    ``map_mlp_hidden``: the hidden width of the SigLIP MAP head's MLP when
    the converted params carry one; ``pool_ln=False``: a pooling head
    without its keys' norm (a converted timm MAP head)."""

    def __init__(self, cfg: ViTConfig, device=None,
                 map_mlp_hidden: Optional[int] = None, pool_ln: bool = True):
        super().__init__()
        self.cfg = cfg
        dt = cfg.dtype
        self.patch = PatchEmbed(cfg.patch_size, cfg.width, dt, device)
        self.blocks = nn.ModuleList(
            L.Block(cfg.width, cfg.n_heads, cfg.mlp_ratio, cfg.layer_scale,
                    dtype=dt, device=device) for _ in range(cfg.depth))
        self.ln_post = L.LayerNorm(cfg.width, device=device)
        self.proj = _param((cfg.width, cfg.embed_dim), torch.float32, device)
        self.ln_pre = L.LayerNorm(cfg.width, device=device) \
            if cfg.ln_pre else None
        self.cls = _param((cfg.width,), torch.float32, device) \
            if cfg.use_cls_token else None
        self.pos = _param((cfg.n_tokens, cfg.width), torch.float32, device) \
            if cfg.use_abs_pos else None
        self.attn_pool = AttnPool(cfg.width, dt, device, map_mlp_hidden,
                                  pool_ln) if cfg.pool == "attn" else None


@torch.no_grad()
def init_vit(cfg: ViTConfig, generator: torch.Generator,
             device=None) -> VisionTransformer:
    """Random weights with the reference's stds (``vit.init_vit``), drawn
    from ``generator`` on its device."""
    m = VisionTransformer(cfg, device=device)
    g = generator
    L._normal(m.patch.w, 0.02, g)
    m.patch.b.zero_()
    for blk in m.blocks:
        L.init_block_(blk, g, cfg.layer_scale)
    L.init_layer_norm_(m.ln_post)
    L._normal(m.proj, cfg.width ** -0.5, g)
    if m.ln_pre is not None:
        L.init_layer_norm_(m.ln_pre)
    if m.cls is not None:
        L._normal(m.cls, 0.02, g)
    if m.pos is not None:
        L._normal(m.pos, 0.02, g)
    if m.attn_pool is not None:
        ap = m.attn_pool
        L._normal(ap.probe, 0.02, g)
        L.init_layer_norm_(ap.ln)
        for lin in (ap.q, ap.k, ap.v, ap.out):
            L.init_linear_(lin, g)
    return m


def _interp_pos_embed(pos: torch.Tensor, n_prefix: int, grid: int,
                      new_grid: int) -> torch.Tensor:
    if grid == new_grid:
        return pos
    prefix, grid_pos = pos[:n_prefix], pos[n_prefix:]
    # jax.image.resize's bilinear weights: scale_and_translate's with no
    # translation and the inverse scale rounded once from the exact ratio
    def f32(value):
        return torch.full((1,), value, dtype=torch.float32, device=pos.device)

    m = bilinear_weight_mat(grid, new_grid, f32(new_grid / grid), f32(0.0),
                            inv_scale=f32(1.0 / (new_grid / grid)))[0]
    g = grid_pos.float().reshape(grid, grid, -1)
    g = torch.einsum("hwc,hH->Hwc", g, m)
    g = torch.einsum("Hwc,wW->HWc", g, m).to(pos.dtype)
    return torch.cat([prefix, g.reshape(new_grid * new_grid, -1)])


def patchify(p: PatchEmbed, imgs: torch.Tensor, patch: int) -> torch.Tensor:
    """imgs (B, H, W, 3) -> (B, L, width): a VALID stride-``patch``
    convolution as one matmul over unfolded (kh, kw, c) patches, f32
    products of the compute-dtype values, + f32 bias, then the dtype."""
    B, H, W, C = imgs.shape
    gh, gw = H // patch, W // patch
    x = imgs[:, :gh * patch, :gw * patch]
    x = x.reshape(B, gh, patch, gw, patch, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, gh * gw, patch * patch * C)
    w = p.w.to(imgs.dtype).reshape(patch * patch * C, -1)
    out = torch.matmul(x.float(), w.float()) + p.b.float()
    return out.to(imgs.dtype)


def forward_features(model: VisionTransformer, cfg: ViTConfig,
                     imgs: torch.Tensor, norm: bool = True,
                     attn_impl: str = "auto",
                     block_fn: Optional[Callable] = None) -> torch.Tensor:
    """imgs (B, H, W, 3) float in model input scale -> tokens
    (B, n_tokens, width); ``ln_post`` applied when ``norm``. ``block_fn``
    (``layers.transformer_block``'s signature) replaces the per-layer block,
    as the tensor-parallel tower does (``parallel/mesh.py``); the
    whole-block kernels are then not taken."""
    x = patchify(model.patch, imgs.to(cfg.dtype), cfg.patch_size)
    B, Lp, W = x.shape
    grid = int(round(Lp ** 0.5))
    n_prefix = 1 if cfg.use_cls_token else 0
    if cfg.use_cls_token:
        cls = model.cls.to(x.dtype).expand(B, 1, W)
        x = torch.cat([cls, x], dim=1)
    if cfg.use_abs_pos:
        pos = _interp_pos_embed(model.pos, n_prefix, cfg.grid, grid)
        x = x + pos.to(x.dtype)
    if cfg.ln_pre:
        x = model.ln_pre(x)
    rope = None
    if cfg.use_rope2d:
        hd = cfg.width // cfg.n_heads
        rope = L.rope2d_freqs(grid, grid, hd, n_prefix=n_prefix,
                              device=x.device)

    if block_fn is None and _use_fused_blocks(attn_impl, model, x.device):
        from ..ops.fused_block import fused_transformer_block

        for blk in model.blocks:
            x = fused_transformer_block(blk, x, cfg.n_heads, rope=rope,
                                        act=cfg.act)
        return model.ln_post(x) if norm else x
    if attn_impl == "fused_block":   # LayerScale blocks: per-layer kernels
        attn_impl = "auto"
    # pre-pad the token stream ONCE for the whole tower whenever attention
    # goes through the packed-RoPE wrapper (every RoPE layer under "auto",
    # on either device): padded keys are masked per layer via n_valid and
    # the pad is sliced off before ln_post
    n_valid = None
    if rope is not None and attn_impl == "auto":
        Lr = x.shape[1]
        if Lr % 8:
            padn = (-Lr) % 8
            x = torch.cat([x, x.new_zeros((B, padn, W))], dim=1)
            pad_t = rope[0].new_zeros((padn, rope[0].shape[-1]))
            rope = (torch.cat([rope[0], pad_t]), torch.cat([rope[1], pad_t]))
            n_valid = Lr
    block_fn = block_fn or L.transformer_block
    for blk in model.blocks:
        x = block_fn(blk, x, cfg.n_heads, rope=rope, attn_impl=attn_impl,
                     act=cfg.act, n_valid=n_valid)
    if n_valid is not None:
        x = x[:, :n_valid]
    if norm:
        x = model.ln_post(x)
    return x


def _use_fused_blocks(attn_impl: str, model: VisionTransformer,
                      device: torch.device) -> bool:
    """The whole-block kernels: an explicit ``attn_impl="fused_block"`` on
    either device, or ``OVO_FUSED_BLOCK=1`` under ``"auto"`` when the tokens
    are on the card (JAX: on a TPU). LayerScale blocks never (the kernels
    do not carry ls1 / ls2)."""
    if len(model.blocks) and model.blocks[0].ls1 is not None:
        return False
    if attn_impl == "fused_block":
        return True
    return (attn_impl == "auto" and device.type == "cuda"
            and os.environ.get("OVO_FUSED_BLOCK") == "1")


def attn_pool(p: AttnPool, x: torch.Tensor, n_heads: int,
              key_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Probe attention pooling over tokens x (B, L, D) -> (B, D)."""
    B, Lt, D = x.shape
    hd = D // n_heads
    q = p.q(p.probe.to(x.dtype).expand(B, 1, D))
    kin = p.ln(x) if p.ln is not None else x
    k = p.k(kin)
    v = p.v(x)
    qh = q.reshape(B, n_heads, hd)
    kh = k.reshape(B, Lt, n_heads, hd).transpose(1, 2)
    vh = v.reshape(B, Lt, n_heads, hd).transpose(1, 2)
    logits = torch.einsum("bhd,bhld->bhl", qh.float(), kh.float()) \
        * hd ** -0.5
    if key_mask is not None:
        logits = torch.where(key_mask[:, None, :], logits,
                             torch.full_like(logits, -1e30))
    wts = torch.softmax(logits, dim=-1).to(vh.dtype)
    o = torch.einsum("bhl,bhld->bhd", wts.float(), vh.float()).to(x.dtype)
    o = p.out(o.reshape(B, D))
    if p.mlp is not None:
        o = o + L.mlp(p.mlp, p.ln2(o))
    return o


def encode(model: VisionTransformer, cfg: ViTConfig, imgs: torch.Tensor,
           attn_impl: str = "auto", project: bool = True,
           block_fn: Optional[Callable] = None) -> torch.Tensor:
    """Pooled image embedding (B, embed_dim)."""
    x = forward_features(model, cfg, imgs, norm=True, attn_impl=attn_impl,
                         block_fn=block_fn)
    if cfg.pool == "attn":
        pooled = attn_pool(model.attn_pool, x, cfg.n_heads)
    elif cfg.pool == "cls":
        pooled = x[:, 0]
    else:
        start = 1 if cfg.use_cls_token else 0
        pooled = x[:, start:].mean(dim=1)
    if project:
        pooled = pooled @ model.proj.to(pooled.dtype)
    return pooled
