"""Hiera hierarchical image encoder, the SAM2 trunk (port of
``ovo_tpu/models/sam/hiera.py``).

A 7x7 / stride-4 patch embed, four stages with dim and head doubling and
2x2 query pooling at the stage transitions, windowed attention everywhere
but the global blocks, and an interpolated background pos-embed plus a
tiled window pos-embed. A stage-transition block keeps the previous stage's
window size (its queries pool 2x inside each window). Global blocks run
through kernel B1 and window blocks through kernel B2
(``ops/attention.dot_product_attention``), the reference's route
(``window_attn="heads"``); ``window_attn="packed"`` sends every window
block that passes the reference's ``use_packed_heads`` gate through kernel
B11 (``ops/attention.packed_heads_attention``) instead, on the head-packed
(B, L, heads * hd) layout. Feature maps are NHWC; the residual stream keeps
the reference's persistent blocked window layout.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops.attention import (dot_product_attention, packed_heads_attention,
                              use_packed_heads)
from ...ops.patchify import patch_embed_s4
from ...ops.resize import resize_channels_last
from ..layers import gelu, layer_norm, linear
from .params import Init

Params = Dict[str, Any]
WINDOW_ATTN = ("heads", "packed")


@dataclasses.dataclass(frozen=True)
class HieraConfig:
    embed_dim: int = 144
    num_heads: int = 2
    stages: Tuple[int, ...] = (2, 6, 36, 4)
    global_att_blocks: Tuple[int, ...] = (23, 33, 43)
    window_spec: Tuple[int, ...] = (8, 4, 14, 7)
    window_pos_size: int = 7          # background pos embed spatial size
    q_stride: int = 2
    dim_mul: float = 2.0
    head_mul: float = 2.0
    mlp_ratio: float = 4.0

    @property
    def depth(self) -> int:
        return sum(self.stages)

    @property
    def stage_ends(self) -> Tuple[int, ...]:
        ends, total = [], 0
        for s in self.stages:
            total += s
            ends.append(total - 1)
        return tuple(ends)

    def block_layout(self):
        """Per block: (dim_in, dim_out, heads_out, window_size, do_pool);
        window size 0 marks a global block."""
        layout = []
        dim, heads = self.embed_dim, self.num_heads
        stage = 0  # current stage BEFORE any transition at block i
        for i in range(self.depth):
            ws = self.window_spec[stage]
            do_pool = (i - 1) in self.stage_ends[:-1]
            dim_out, heads_out = dim, heads
            if do_pool:
                dim_out = int(dim * self.dim_mul)
                heads_out = int(heads * self.head_mul)
                stage += 1
            if i in self.global_att_blocks:
                ws = 0
            layout.append((dim, dim_out, heads_out, ws, do_pool))
            dim, heads = dim_out, heads_out
        return layout


HIERA_CONFIGS = {
    "hiera_t": HieraConfig(embed_dim=96, num_heads=1, stages=(1, 2, 7, 2),
                           global_att_blocks=(5, 7, 9)),
    "hiera_s": HieraConfig(embed_dim=96, num_heads=1, stages=(1, 2, 11, 2),
                           global_att_blocks=(7, 10, 13)),
    "hiera_b+": HieraConfig(embed_dim=112, num_heads=2, stages=(2, 3, 16, 3),
                            global_att_blocks=(12, 16, 20)),
    "hiera_l": HieraConfig(),
    # tiny structural-test config
    "hiera_test": HieraConfig(embed_dim=32, num_heads=2, stages=(1, 1, 2, 1),
                              global_att_blocks=(3,),
                              window_spec=(8, 4, 4, 2), window_pos_size=4),
}


def init_hiera(init: Init, cfg: HieraConfig) -> Params:
    blocks = []
    for din, dout, heads, ws, do_pool in cfg.block_layout():
        hidden = int(dout * cfg.mlp_ratio)
        blk = {
            "norm1": init.layer_norm(din),
            "attn": {"qkv": init.linear(din, 3 * dout),
                     "proj": init.linear(dout, dout)},
            "norm2": init.layer_norm(dout),
            "mlp": {"fc": init.linear(dout, hidden),
                    "proj": init.linear(hidden, dout)},
        }
        if din != dout:
            blk["proj"] = init.linear(din, dout)
        blocks.append(blk)
    wp, w0, C = cfg.window_pos_size, cfg.window_spec[0], cfg.embed_dim
    return {
        "patch": {"w": init.normal((7, 7, 3, C), 0.02), "b": init.zeros(C)},
        "pos_embed": init.normal((wp, wp, C), 0.02),
        "pos_embed_window": init.normal((w0, w0, C), 0.02),
        "blocks": blocks,
    }


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def lin(p: Params, x: torch.Tensor) -> torch.Tensor:
    return linear(x, p["w"], p.get("b"))


def norm(p: Params, x: torch.Tensor) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"])


def mlp(p: Params, x: torch.Tensor, act=gelu) -> torch.Tensor:
    return lin(p["proj"], act(lin(p["fc"], x)))


def _window_partition(x: torch.Tensor, ws: int
                      ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B*nW, ws, ws, C) with zero padding."""
    B, H, W, C = x.shape
    ph, pw = (-H) % ws, (-W) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def _pad_mask(B: int, Hc: int, Wc: int, ws: int, device) -> torch.Tensor:
    """1.0 over real tokens, 0.0 over window padding, in the blocked
    layout (B*nW, ws, ws, 1)."""
    return _window_partition(torch.ones((B, Hc, Wc, 1), device=device),
                             ws)[0]


def _window_unpartition(xw: torch.Tensor, ws: int, n_wh: int, n_ww: int,
                        out_hw: Tuple[int, int], B: int) -> torch.Tensor:
    C = xw.shape[-1]
    x = xw.reshape(B, n_wh, n_ww, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, n_wh * ws, n_ww * ws, C)
    return x[:, :out_hw[0], :out_hw[1]]


def _max_pool2x(x: torch.Tensor, stride: int) -> torch.Tensor:
    """MaxPool2d(kernel=stride, stride=stride) on NHWC, VALID."""
    B, H, W, C = x.shape
    Ho, Wo = H // stride, W // stride
    x = x[:, :Ho * stride, :Wo * stride]
    return x.reshape(B, Ho, stride, Wo, stride, C).amax(dim=(2, 4))


def _mh_attention(p: Params, x: torch.Tensor, heads: int, dout: int,
                  q_pool: Optional[int], *, packed: bool = False
                  ) -> torch.Tensor:
    """MultiScaleAttention over token maps x (B, H, W, Cin): qkv -> optional
    2x2 max-pool of q -> attention -> proj. Returns (B, H', W', dout). The
    head-split q / k / v are strided views of the qkv projection; the
    kernels read them in place and write token-major output. ``packed``:
    kernel B11 on the (B, L, dout) column slices where its gate takes the
    shape, else :func:`dot_product_attention` on the head views."""
    B, H, W, _ = x.shape
    qkv = lin(p["qkv"], x.reshape(B, H * W, -1)).reshape(B, H * W, 3, dout)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    Hq, Wq = H, W
    if q_pool:
        qs = _max_pool2x(q.reshape(B, H, W, dout), q_pool)
        Hq, Wq = qs.shape[1], qs.shape[2]
        q = qs.reshape(B, Hq * Wq, dout)
    hd = dout // heads

    def split(t):
        return t.reshape(B, t.shape[1], heads, hd).transpose(1, 2)

    if packed and use_packed_heads(q.shape[1], k.shape[1], dout, heads):
        o = packed_heads_attention(q, k, v, heads=heads)
    else:
        o = dot_product_attention(split(q), split(k), split(v))
        o = o.transpose(1, 2).reshape(B, Hq * Wq, dout)
    return lin(p["proj"], o).reshape(B, Hq, Wq, dout)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def hiera_forward(params: Params, cfg: HieraConfig, imgs: torch.Tensor, *,
                  window_attn: str = "heads") -> List[torch.Tensor]:
    """imgs (B, H, W, 3) normalized -> stage-end feature maps
    [(B, H_s, W_s, C_s)], highest resolution first. ``window_attn``: the
    window blocks' attention, ``"heads"`` (the reference's: B2 on head
    views) or ``"packed"`` (B11 on the head-packed layout)."""
    if window_attn not in WINDOW_ATTN:
        raise ValueError(f"window_attn {window_attn!r} is not one of "
                         f"{WINDOW_ATTN}")
    x = patch_embed_s4(imgs, params["patch"]["w"].to(imgs.dtype),
                       params["patch"]["b"])
    B, H, W, C = x.shape
    pos = resize_channels_last(params["pos_embed"], (H, W), kind="cubic")
    win = params["pos_embed_window"]
    tiled = win.repeat(-(-H // win.shape[0]), -(-W // win.shape[1]), 1)
    x = x + (pos + tiled[:H, :W]).to(x.dtype)

    # The residual stream stays in the blocked window layout (B*nW, ws, ws,
    # C) across runs of same-window blocks: LN / MLP / residual are
    # position-wise and window attention is window-local, so only window
    # size changes, global blocks and stage outputs re-layout. Window
    # padding is re-zeroed after norm1, so the numbers are those of
    # partitioning every block anew.
    layout = cfg.block_layout()
    outputs: List[torch.Tensor] = []
    lws = 0            # current blocked window size; 0 = spatial layout
    Hc, Wc = H, W      # true spatial extent of the token map
    Hp = Wp = 0        # window-padded extent while blocked

    def unblock(t: torch.Tensor, ws: int) -> torch.Tensor:
        return _window_unpartition(t, ws, Hp // ws, Wp // ws, (Hc, Wc), B)

    for i, (blk, (din, dout, heads, ws, do_pool)) in enumerate(
            zip(params["blocks"], layout)):
        if ws > 0 and lws != ws:
            if lws:
                x = unblock(x, lws)
            x, (Hp, Wp) = _window_partition(x, ws)
            lws = ws
        elif ws == 0 and lws:
            x = unblock(x, lws)
            lws = 0

        xn = norm(blk["norm1"], x)
        if lws and (Hp != Hc or Wp != Wc):
            # pads collect residual garbage while the layout persists;
            # attention keys must see exact zeros
            xn = xn * _pad_mask(B, Hc, Wc, lws, xn.device).to(xn.dtype)
        shortcut = x
        if din != dout:
            shortcut = lin(blk["proj"], xn)
        if do_pool:
            shortcut = _max_pool2x(shortcut, cfg.q_stride)
        att = _mh_attention(blk["attn"], xn, heads, dout,
                            cfg.q_stride if do_pool else None,
                            packed=ws > 0 and window_attn == "packed")
        if do_pool:
            Hc, Wc = Hc // cfg.q_stride, Wc // cfg.q_stride
            if lws:
                Hp, Wp = Hp // cfg.q_stride, Wp // cfg.q_stride
                lws //= cfg.q_stride

        x = shortcut + att
        x = x + mlp(blk["mlp"], norm(blk["norm2"], x))
        if i in cfg.stage_ends:
            outputs.append(unblock(x, lws) if lws else x)
    return outputs
