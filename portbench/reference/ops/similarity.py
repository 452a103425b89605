"""Embedding similarity and multi-crop CLIP fusion (port of
``ovo_tpu/ops/similarity.py``)."""
from __future__ import annotations

import torch


def clip_cosine_similarity(txt_embeds: torch.Tensor,
                           img_embeds: torch.Tensor) -> torch.Tensor:
    """(Q, D) x (N, D) -> (N, Q) plain dot products in f32 (both sides are
    normalized by the callers)."""
    return img_embeds.float() @ txt_embeds.to(img_embeds.dtype).float().T


def siglip_similarity(txt_embeds: torch.Tensor, img_embeds: torch.Tensor,
                      logit_scale: torch.Tensor,
                      logit_bias: torch.Tensor) -> torch.Tensor:
    """SigLIP sigmoid similarity: sigmoid(cos * exp(scale) + bias)."""
    logits = clip_cosine_similarity(txt_embeds, img_embeds)
    return torch.sigmoid(logits * torch.exp(logit_scale) + logit_bias)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)


def _cos(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (_normalize(a) * _normalize(b)).sum(dim=-1)


def fuse_clips(clip_g: torch.Tensor, clip_seg: torch.Tensor,
               clip_bbox: torch.Tensor, embed_type: str, w_masked: float,
               w_global: float) -> torch.Tensor:
    """Multi-crop descriptor fusion: combine the global-image, masked-crop
    and bbox-crop vectors per segment. All inputs (N, D), normalized;
    returns (N, D). ``hovsg`` and ``concept_fusion`` take a softmax over
    the mask axis -- every row, padded mask slots included, as the
    reference does."""
    if embed_type in ("hovsg", "fixed_weights"):
        clip_l = _normalize(clip_seg * w_masked + clip_bbox * (1.0 - w_masked))
        if embed_type == "fixed_weights":
            wg = w_global
        else:
            wg = torch.softmax(_cos(clip_g, clip_l), dim=0)[:, None]
        return _normalize(clip_g * wg + clip_l * (1.0 - wg))
    if embed_type == "adaptive_weights":
        w_local = (_cos(clip_seg, clip_bbox) * w_masked)[:, None]
        clip_l = _normalize(clip_seg * w_local + clip_bbox * (1.0 - w_local))
        wg = (_cos(clip_g, clip_l) * w_global)[:, None]
        return _normalize(clip_g * wg + clip_l * (1.0 - wg))
    if embed_type == "concept_fusion":
        wg = torch.softmax(_cos(clip_g, clip_bbox), dim=0)[:, None]
        return _normalize(wg * clip_g + (1.0 - wg) * clip_bbox)
    return clip_seg                                       # vanilla
