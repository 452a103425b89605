"""The encoders' patch embeds as one matmul each (port of
``ovo_tpu/ops/patchify.py``).

A stride == kernel convolution (the ViT-det's 16x16 / stride 16) takes
non-overlapping patches: a reshape to (B, Ho, Wo, k * k * Cin) and one
matmul. A 7x7 / stride-4 / pad-3 convolution (Hiera's) is a 2x2 / stride-1
convolution over 4x4-blocked channels after space-to-depth by the stride:
the 2x2 neighborhood is gathered with four unit-stride slices and
contracted in one matmul against the tap-rearranged, zero-padded kernel.
NHWC in, NHWC out, HWIO weights; the product accumulates in f32 and is cast
back, as the reference's ``preferred_element_type=f32``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def patch_embed_nonoverlap(imgs: torch.Tensor, w: torch.Tensor,
                           b: Optional[torch.Tensor]) -> torch.Tensor:
    """imgs (B, H, W, Cin), w (k, k, Cin, C) HWIO with H, W multiples of k
    -> (B, H/k, W/k, C) in imgs' dtype, the bias added in that dtype."""
    k = w.shape[0]
    B, H, W, Cin = imgs.shape
    if w.shape[1] != k or H % k or W % k:
        raise ValueError(f"patch_embed_nonoverlap takes a square kernel "
                         f"dividing H, W; got {tuple(imgs.shape)}, "
                         f"{tuple(w.shape)}")
    x = imgs.reshape(B, H // k, k, W // k, k, Cin).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, H // k, W // k, k * k * Cin)
    wf = w.reshape(k * k * Cin, -1).to(imgs.dtype)
    out = torch.matmul(x.float(), wf.float()).to(imgs.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out


def patch_embed_s4(imgs: torch.Tensor, w: torch.Tensor,
                   b: Optional[torch.Tensor]) -> torch.Tensor:
    """imgs (B, H, W, Cin) with H, W multiples of 4; w (7, 7, Cin, C) HWIO
    -> (B, H/4, W/4, C) in imgs' dtype."""
    B, H, W, Cin = imgs.shape
    if H % 4 or W % 4 or tuple(w.shape[:2]) != (7, 7):
        raise ValueError(f"patch_embed_s4 takes H, W % 4 == 0 and a 7x7 "
                         f"kernel; got {tuple(imgs.shape)}, {tuple(w.shape)}")
    C = w.shape[-1]
    Ho, Wo = H // 4, W // 4
    # pad 3 front / 5 back: tap dy = 0 aligns with block phase 0, and the
    # back reaches a multiple of 4 (the 8th tap phase is zero)
    p = F.pad(imgs, (0, 0, 3, 5, 3, 5))
    Hb, Wb = Ho + 2, Wo + 2
    x = p.reshape(B, Hb, 4, Wb, 4, Cin).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(B, Hb, Wb, 16 * Cin)
    cat = torch.cat([x[:, 0:Ho, 0:Wo], x[:, 0:Ho, 1:Wo + 1],
                     x[:, 1:Ho + 1, 0:Wo], x[:, 1:Ho + 1, 1:Wo + 1]], dim=-1)
    # (7, 7, Cin, C) -> zero-pad to (8, 8) -> (bi, bj, phase_y, phase_x,
    # Cin, C): index (bi, bj, p, q, c) reads tap (4 bi + p, 4 bj + q)
    wpad = F.pad(w, (0, 0, 0, 0, 0, 1, 0, 1))
    wf = wpad.reshape(2, 4, 2, 4, Cin, C).permute(0, 2, 1, 3, 4, 5)
    wf = wf.reshape(64 * Cin, C).to(imgs.dtype)
    out = torch.matmul(cat.float(), wf.float()).to(imgs.dtype)
    if b is not None:
        out = out + b.to(out.dtype)
    return out
