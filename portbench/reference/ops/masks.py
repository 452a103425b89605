"""Mask post-processing on the device (port of ``ovo_tpu/ops/masks.py``).

OVO's mask NMS with the full pairwise intersection matrix as one f32 matmul
(exact for 0/1 masks) and the threshold logic vectorized, keeping the
reference's quirks (``ovo_tpu/ops/masks.py:10-15``):

  - ``tril(diagonal=1)`` for the lower inner-overlap matrix (the
    superdiagonal included);
  - keep = (column max of the strict-upper IoU <= iou_thr) & score / inner
    gates;
  - when nothing passes a gate, the top 3 by score pass it (the evident
    intent of the reference's fallback).

All shapes are fixed (N masks with a validity flag), every branch is a
device-side ``torch.where``, and nothing synchronizes with the host.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .segment_mxu import table_lookup_int


def mask_nms(masks: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             *, iou_thr: float = 0.7, score_thr: float = 0.1,
             inner_thr: float = 0.2) -> torch.Tensor:
    """masks (N, *spatial) bool in any consistent spatial order; scores (N,);
    valid (N,) -> keep (N,) bool in the original mask order."""
    N = masks.shape[0]
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-s, stable=True)
    s_ord = s[order]
    v_ord = valid[order]

    flat = masks.reshape(N, -1).float()[order]
    area = flat.sum(dim=1)
    inter = flat @ flat.T                          # pairwise overlap, exact
    union = area[:, None] + area[None, :] - inter
    pair_valid = v_ord[:, None] & v_ord[None, :]
    zero = torch.zeros((), dtype=inter.dtype, device=inter.device)
    iou = torch.where(pair_valid & (union > 0),
                      inter / union.clamp_min(1e-9), zero)

    safe_area = area.clamp_min(1e-9)
    frac_r = inter / safe_area[:, None]            # inter / area_row
    frac_c = inter / safe_area[None, :]            # inter / area_col
    inner = torch.where((frac_r < 0.5) & (frac_c >= 0.85) & pair_valid,
                        1.0 - frac_c * frac_r, zero)

    rows = torch.arange(N, device=masks.device)
    strict_upper = rows[:, None] < rows[None, :]
    iou_max = torch.where(strict_upper, iou, zero).amax(dim=0)
    inner_u = torch.where(strict_upper, inner, zero).amax(dim=0)
    # reference: tril(inner, diagonal=1) -> rows >= cols - 1
    inner_l = torch.where(rows[:, None] >= rows[None, :] - 1, inner,
                          zero).amax(dim=0)

    keep = iou_max <= iou_thr
    top3 = rows < 3

    def gate(ok):
        # if nothing valid passes, the top 3 by score do
        return torch.where((ok & v_ord).any(), ok, top3)

    keep_ord = (keep & gate(s_ord > score_thr)
                & gate(inner_u <= 1.0 - inner_thr)
                & gate(inner_l <= 1.0 - inner_thr) & v_ord)
    out = torch.empty_like(keep_ord)
    out[order] = keep_ord
    return out


def masks_to_seg_map(masks: torch.Tensor, stability: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """Rasterize kept masks (N, H, W) into an (H, W) int32 seg map, overlaps
    won by the higher stability (mask2segmap: masks sorted by stability
    descending, the earlier mask wins). Values index the original mask axis;
    -1 = unassigned."""
    N = masks.shape[0]
    s = torch.where(valid, stability,
                    torch.full_like(stability, float("-inf")))
    inv = torch.argsort(-s, stable=True)           # inv[rank] = mask index
    ordered = (masks & valid[:, None, None])[inv]  # masks in rank order
    # per pixel: the covering mask of smallest rank (argmax returns the
    # first maximal index); N where none covers
    best = ordered.to(torch.uint8).argmax(dim=0)
    best = torch.where(ordered.any(dim=0), best, torch.full_like(best, N))
    tbl = torch.cat([inv.to(torch.int32),
                     torch.full((1,), -1, dtype=torch.int32,
                                device=masks.device)])
    return table_lookup_int(best.reshape(-1), tbl).reshape(best.shape)


def compact_masks(keep: torch.Tensor, masks: torch.Tensor,
                  scores: torch.Tensor, stability: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Stable-compact kept masks to the front of the padded axis: (masks,
    scores, stability, valid) with kept entries first, in original order."""
    order = torch.argsort((~keep).to(torch.int32), stable=True)
    return masks[order], scores[order], stability[order], keep[order]
