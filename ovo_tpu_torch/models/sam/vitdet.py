"""ViT-det image encoder, the SAM1 trunk (port of
``ovo_tpu/models/sam/vitdet.py``).

A 16x16 / stride-16 patch embed, an absolute position embedding (bicubic to
the token grid when it differs from the pretraining grid), pre-norm ViT
blocks with windowed attention except the global blocks, a decomposed
relative-position bias, and the LayerNorm2d neck to the 256-d SAM
embedding. NHWC feature maps, HWIO weights.

The reference computes the attention with plain einsums, outside any
kernel: the relative-position bias depends on the query, which no
fixed-bias kernel takes. So does the port, with the reference's rounding
points kept: q is scaled in the compute dtype; the scores and both bias
products are f32 products of compute-dtype operands (exact, with f32
sums: a bf16 ``torch.matmul`` would round them); the softmax is f32; the
weights are rounded to v's dtype before p . v, whose f32 result is rounded
to x's dtype before the out-projection. The global blocks' f32 score
tensors (16 heads x 4096^2 at ViT-H, 1 GiB) are updated in place and freed
before the next block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ... import to_device
from ...ops.patchify import patch_embed_nonoverlap
from ...ops.resize import _interp_matrix, resize_channels_last
from ..layers import layer_norm
from .hiera import _window_partition, _window_unpartition, lin, mlp, norm
from .params import Init

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTDetConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    global_blocks: Tuple[int, ...] = (2, 5, 8, 11)
    window_size: int = 14
    patch: int = 16
    mlp_ratio: float = 4.0
    out_chans: int = 256
    pretrain_grid: int = 64          # pos_embed's grid (1024 / 16)


VITDET_CONFIGS = {
    "vit_b": ViTDetConfig(),
    "vit_l": ViTDetConfig(embed_dim=1024, depth=24, num_heads=16,
                          global_blocks=(5, 11, 17, 23)),
    "vit_h": ViTDetConfig(embed_dim=1280, depth=32, num_heads=16,
                          global_blocks=(7, 15, 23, 31)),
    # tiny structural-test config; window 6 over a 16-token grid runs the
    # pad path (16 -> 18)
    "vit_test": ViTDetConfig(embed_dim=32, depth=3, num_heads=2,
                             global_blocks=(2,), window_size=6,
                             pretrain_grid=16),
}


def init_vitdet(init: Init, cfg: ViTDetConfig) -> Params:
    """The JAX package's ``init_vitdet`` tree: random leaves from the
    ``Init``'s generator (its shapes and stds), or zeros without one."""
    d, dh = cfg.embed_dim, cfg.embed_dim // cfg.num_heads
    hidden = int(d * cfg.mlp_ratio)
    blocks = []
    for i in range(cfg.depth):
        span = cfg.pretrain_grid if i in cfg.global_blocks else \
            cfg.window_size
        blocks.append({
            "norm1": init.layer_norm(d),
            "attn": {"qkv": init.linear(d, 3 * d),
                     "proj": init.linear(d, d),
                     "rel_pos_h": init.normal((2 * span - 1, dh), 0.02),
                     "rel_pos_w": init.normal((2 * span - 1, dh), 0.02)},
            "norm2": init.layer_norm(d),
            "mlp": {"fc": init.linear(d, hidden),
                    "proj": init.linear(hidden, d)},
        })
    g, out = cfg.pretrain_grid, cfg.out_chans
    return {
        "patch": {"w": init.normal((cfg.patch, cfg.patch, 3, d), 0.02),
                  "b": init.zeros(d)},
        "pos_embed": init.normal((g, g, d), 0.02),
        "blocks": blocks,
        "neck": {"conv1": {"w": init.normal((1, 1, d, out), 0.02)},
                 "ln1": init.layer_norm(out),
                 "conv2": {"w": init.normal((3, 3, out, out), 0.02)},
                 "ln2": init.layer_norm(out)},
    }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _rel_pos_table(rel_pos: torch.Tensor, size: int) -> torch.Tensor:
    """(L, dh) stored table -> (size, size, dh) lookup R[q, k] = table[q -
    k + size - 1], the table linearly interpolated to 2 * size - 1 rows
    first when its length differs (segment_anything's ``get_rel_pos``)."""
    need = 2 * size - 1
    if rel_pos.shape[0] != need:
        m = to_device(_interp_matrix(rel_pos.shape[0], need, "linear"),
                      rel_pos.device)
        rel_pos = m.T.to(rel_pos.dtype) @ rel_pos
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


def _attention(p: Params, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Rel-pos attention over token maps x (B, H, W, C), H and W the window
    or the whole grid. The decomposed bias depends on the query:
    s[b, (qh, qw), (kh, kw)] += q . Rh[qh, kh] + q . Rw[qw, kw]."""
    B, H, W, C = x.shape
    dh = C // heads
    qkv = lin(p["qkv"], x.reshape(B, H * W, C)).reshape(B, H * W, 3, heads,
                                                        dh)
    # heads fold into the batch, as segment_anything's reshape
    q, k, v = (qkv[:, :, i].transpose(1, 2).reshape(B * heads, H * W, dh)
               for i in range(3))
    # the scale rounded to the dtype, then the product: the reference's
    # weakly-typed Python scalar
    scale = torch.full((), dh ** -0.5, dtype=q.dtype, device=q.device)
    s = torch.matmul((q * scale).float(), k.float().transpose(1, 2))
    rh = _rel_pos_table(p["rel_pos_h"], H).to(q.dtype).float()
    rw = _rel_pos_table(p["rel_pos_w"], W).to(q.dtype).float()
    qs = q.reshape(B * heads, H, W, dh).float()
    s5 = s.view(B * heads, H, W, H, W)
    s5.add_(torch.einsum("bhwd,hkd->bhwk", qs, rh)[:, :, :, :, None])
    s5.add_(torch.einsum("bhwd,wkd->bhwk", qs, rw)[:, :, :, None, :])
    del qs, s5
    p_w = torch.softmax(s, dim=-1)
    del s
    p_w = p_w.to(v.dtype).float()
    o = torch.matmul(p_w, v.float()).to(x.dtype)
    del p_w
    o = o.reshape(B, heads, H * W, dh).transpose(1, 2).reshape(B, H, W, C)
    return lin(p["proj"], o)


def _conv1x1(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Bias-free 1x1 convolution: f32 products of the dtype's values, the
    result rounded to x's dtype."""
    w = p["w"].to(x.dtype)[0, 0]
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def _conv3x3(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Bias-free 3x3 / pad-1 convolution as one f32 matmul over the nine
    shifted maps (the HWIO weight flattens in the same (dy, dx, c) order),
    rounded to x's dtype."""
    B, H, W, C = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1)).float()
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + W]
                      for dy in range(3) for dx in range(3)], dim=-1)
    w = p["w"].to(x.dtype).reshape(9 * C, -1).float()
    return torch.matmul(cols, w).to(x.dtype)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def vitdet_forward(params: Params, cfg: ViTDetConfig,
                   imgs: torch.Tensor) -> torch.Tensor:
    """imgs (B, S, S, 3) normalized -> (B, S/16, S/16, out_chans): patch
    embed, position embedding, blocks, LayerNorm2d neck."""
    x = patch_embed_nonoverlap(imgs, params["patch"]["w"].to(imgs.dtype),
                               params["patch"].get("b"))
    B, H, W, _ = x.shape
    pos = params["pos_embed"]
    if tuple(pos.shape[:2]) != (H, W):
        pos = resize_channels_last(pos, (H, W), kind="cubic")
    x = x + pos.to(x.dtype)
    for i, blk in enumerate(params["blocks"]):
        xn = norm(blk["norm1"], x)
        if i in cfg.global_blocks:
            att = _attention(blk["attn"], xn, cfg.num_heads)
        else:
            ws = cfg.window_size
            xw, (Hp, Wp) = _window_partition(xn, ws)
            att = _window_unpartition(
                _attention(blk["attn"], xw, cfg.num_heads), ws, Hp // ws,
                Wp // ws, (H, W), B)
        x = x + att
        x = x + mlp(blk["mlp"], norm(blk["norm2"], x))
    n = params["neck"]
    # LayerNorm2d: per-pixel channel statistics, eps 1e-6
    x = _conv1x1(n["conv1"], x)
    x = layer_norm(x, n["ln1"]["scale"], n["ln1"]["bias"], eps=1e-6)
    x = _conv3x3(n["conv2"], x)
    return layer_norm(x, n["ln2"]["scale"], n["ln2"]["bias"], eps=1e-6)
