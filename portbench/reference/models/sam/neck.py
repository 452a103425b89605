"""FPN neck (port of ``ovo_tpu/models/sam/neck.py``): per-level 1x1
convolutions to the decoder width and a nearest-neighbor top-down pass on
the two highest-resolution levels (SAM2's fpn_top_down_levels [2, 3]). NHWC
feature maps, HWIO weights."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from .params import Init

Params = Dict[str, Any]


def init_neck(init: Init, channel_list: Tuple[int, ...],
              d_model: int = 256) -> Params:
    return {"convs": [{"w": init.normal((1, 1, c, d_model), c ** -0.5),
                       "b": init.zeros(d_model)} for c in channel_list]}


def conv1x1(p: Params, x: torch.Tensor) -> torch.Tensor:
    """1x1 convolution, f32 accumulation cast back to x's dtype, then the
    bias in x's dtype (the reference's preferred_element_type=f32)."""
    w = p["w"].to(x.dtype)[0, 0]
    out = torch.matmul(x.float(), w.float()).to(x.dtype)
    return out + p["b"].to(x.dtype)


def _resize_nearest(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, h, w, C) -> (B, H, W, C), nearest with half-pixel centers."""
    h, w = x.shape[1], x.shape[2]
    H, W = hw

    def src(n_in, n_out):
        i = torch.arange(n_out, device=x.device, dtype=torch.float64)
        return ((i + 0.5) * (n_in / n_out)).floor().long().clamp_(0, n_in - 1)

    return x.index_select(1, src(h, H)).index_select(2, src(w, W))


def neck_forward(params: Params, feats: List[torch.Tensor],
                 top_down_levels: Tuple[int, ...] = (2, 3)
                 ) -> List[torch.Tensor]:
    """feats: trunk outputs, highest resolution first [(B, H, W, C)].
    Returns same-order d_model maps; the levels in ``top_down_levels``
    (counted from the lowest resolution) add the upsampled coarser level."""
    n = len(feats)
    lateral = [conv1x1(conv, f) for f, conv in zip(feats, params["convs"])]
    outs: List[torch.Tensor] = [None] * n
    prev = None
    for i in range(n - 1, -1, -1):
        x = lateral[i]
        if prev is not None and (n - 1) - i in top_down_levels:
            x = x + _resize_nearest(prev, (x.shape[1], x.shape[2]))
        outs[i] = x
        prev = x
    return outs
