"""Prompt encoder (port of ``ovo_tpu/models/sam/prompt.py``): point prompts
to sparse embeddings with a random-Fourier positional encoding and learned
positive / negative / not-a-point embeddings; the dense positional grid."""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from .params import Init

Params = Dict[str, Any]


def init_prompt_encoder(init: Init, d_model: int = 256) -> Params:
    return {
        "pe_gaussian": init.normal((2, d_model // 2), 1.0),
        # 0: negative point, 1: positive point, 2/3: box corners
        "point_embeds": init.normal((4, d_model), 0.02),
        "not_a_point": init.normal((d_model,), 0.02),
        "no_mask": init.zeros(d_model),
    }


def pe_encode(params: Params, coords01: torch.Tensor) -> torch.Tensor:
    """Fourier features of [0, 1] coords (..., 2) -> (..., d_model), f32."""
    x = (2.0 * coords01 - 1.0) @ params["pe_gaussian"]
    x = 2.0 * math.pi * x
    return torch.cat([torch.sin(x), torch.cos(x)], dim=-1)


def pe_grid(params: Params, h: int, w: int) -> torch.Tensor:
    """Dense positional encoding over an (h, w) grid -> (h, w, d_model)."""
    dev = params["pe_gaussian"].device
    ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return pe_encode(params, torch.stack([gx, gy], dim=-1))


def encode_points(params: Params, points01: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
    """points01 (B, N, 2) in [0, 1] (x, y); labels (B, N): 1 positive, 0
    negative, -1 padding -> sparse embeddings (B, N+1, d) with the appended
    not-a-point entry SAM adds when no box prompt is present."""
    B = points01.shape[0]
    pts = torch.cat([points01, points01.new_zeros((B, 1, 2))], dim=1)
    labs = torch.cat([labels, torch.full((B, 1), -1, dtype=labels.dtype,
                                         device=labels.device)], dim=1)
    pe = pe_encode(params, pts)
    emb = params["point_embeds"]
    type_embed = torch.where((labs == 1)[..., None], emb[1], emb[0])
    return torch.where((labs == -1)[..., None],
                       params["not_a_point"][None, None, :], pe + type_embed)
