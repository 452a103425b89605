"""Backend factories: mask sources and embedders from the ``semantic``
config section (port of ``ovo_tpu/factory.py``): precomputed masks
(``sam.precomputed: true``) or the live SAM2 automatic mask generator, and
the embedder of ``clip.embed_type`` -- TextRegion, or a crop embedder for
``vanilla``, ``fixed_weights``, ``adaptive_weights``, ``hovsg``,
``concept_fusion`` and ``learned``."""
from __future__ import annotations

import os
from typing import Any, Dict, Optional


def build_mask_source(semantic_cfg: Dict[str, Any],
                      scene_name: Optional[str] = None, device="cuda"):
    sam_cfg = semantic_cfg.get("sam", {})
    max_masks = int(semantic_cfg.get("capacity", {}).get("n_masks", 96))
    if not sam_cfg.get("precomputed", False):
        from .models.sam import build_sam_mask_source

        return build_sam_mask_source(sam_cfg, max_masks=max_masks,
                                     device=device)
    if not scene_name:
        raise ValueError("precomputed masks require a scene_name")
    from .data.masks import PrecomputedMaskSource

    return PrecomputedMaskSource(
        os.path.join(sam_cfg["masks_base_path"], scene_name),
        max_masks=max_masks, device=device)


def build_embedder(semantic_cfg: Dict[str, Any], device="cuda"):
    clip_cfg = semantic_cfg.get("clip", {})
    from .models.clip import build_clip_embedder

    return build_clip_embedder(clip_cfg, clip_cfg.get("embed_type", "vanilla"),
                               device=device)
