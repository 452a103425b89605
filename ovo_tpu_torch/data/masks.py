"""Mask sources and a recorded embedder (port of ``ovo_tpu/data/masks.py``).

Precomputed masks use the reference's per-frame layout
(``{frame:04d}_seg_map_default.npy`` / ``{frame:04d}_bmap_default.npy``),
read with numpy alone. Every source returns fixed-shape tensors on its
device: (seg_map (H, W) i32, binary_maps (M, H, W) bool, valid (M,) bool),
masks past ``max_masks`` dropped and seg ids re-indexed to the padded axis.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device, to_device


def pad_masks(seg_map: np.ndarray, binary_maps: np.ndarray, max_masks: int
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad / truncate a (possibly empty) mask set to the fixed mask axis."""
    h, w = seg_map.shape
    n = binary_maps.shape[0] if binary_maps.ndim == 3 else 0
    out_seg = np.full((h, w), -1, np.int32)
    out_b = np.zeros((max_masks, h, w), bool)
    valid = np.zeros(max_masks, bool)
    keep = min(n, max_masks)
    if keep:
        out_b[:keep] = binary_maps[:keep]
        valid[:keep] = True
        sm = seg_map.astype(np.int64)
        out_seg = np.where((sm >= 0) & (sm < keep), sm, -1).astype(np.int32)
    return out_seg, out_b, valid


def _upload(seg, b, valid, device):
    return (to_device(seg, device), to_device(b, device),
            to_device(valid, device))


class PrecomputedMaskSource:
    """Loads the reference's precomputed per-frame masks."""

    def __init__(self, masks_path: str, max_masks: int = 96, device="cuda"):
        self.masks_path = masks_path
        self.max_masks = max_masks
        self.device = resolve_device(device)

    def get_masks(self, image, frame_id: int):
        map_path = os.path.join(self.masks_path,
                                f"{frame_id:04d}_seg_map_default.npy")
        if not os.path.exists(map_path):
            print(f"No precomputed mask for frame {frame_id}")
            return None, None, np.zeros(self.max_masks, bool)
        seg_map = np.load(map_path)
        bmap_path = os.path.join(self.masks_path,
                                 f"{frame_id:04d}_bmap_default.npy")
        if os.path.exists(bmap_path):
            binary = np.load(bmap_path)
        else:
            n = int(seg_map.max()) + 1
            binary = np.stack([seg_map == i for i in range(n)]) if n > 0 \
                else np.zeros((0, *seg_map.shape), bool)
        return _upload(*pad_masks(seg_map, binary, self.max_masks),
                       self.device)

    def save_masks(self, seg_map: np.ndarray, binary_maps: np.ndarray,
                   frame_id: int) -> None:
        os.makedirs(self.masks_path, exist_ok=True)
        np.save(os.path.join(self.masks_path,
                             f"{frame_id:04d}_seg_map_default"), seg_map)
        np.save(os.path.join(self.masks_path,
                             f"{frame_id:04d}_bmap_default"), binary_maps)


class CallableMaskSource:
    """Wraps any fn(image, frame_id) -> (seg_map, binary_maps) numpy pair
    (synthetic scenes, GT-mask runs)."""

    def __init__(self, fn, max_masks: int = 96, device="cuda"):
        self.fn = fn
        self.max_masks = max_masks
        self.device = resolve_device(device)

    def get_masks(self, image, frame_id: int):
        out = self.fn(image, frame_id)
        if out is None:
            return None, None, np.zeros(self.max_masks, bool)
        seg_map, binary = out
        return _upload(*pad_masks(np.asarray(seg_map), np.asarray(binary),
                                  self.max_masks), self.device)

    def get_masks_batch(self, images, frame_ids):
        """The reference's loop fallback: each image through ``get_masks``
        (an empty frame as an all-invalid slot set), stacked, so the
        pipeline's ``sam.batch`` path runs with recorded or synthetic
        masks."""
        h, w = np.asarray(images[0]).shape[:2]
        segs, bs, vs = [], [], []
        for img, fid in zip(images, frame_ids):
            seg, b, valid = self.get_masks(img, fid)
            if seg is None:
                seg, b, valid = _upload(
                    np.full((h, w), -1, np.int32),
                    np.zeros((self.max_masks, h, w), bool),
                    np.zeros((self.max_masks,), bool), self.device)
            segs.append(seg)
            bs.append(b)
            vs.append(valid)
        return torch.stack(segs), torch.stack(bs), torch.stack(vs)


class RecordedEmbedder:
    """Embedder backed by a lookup: label -> unit vector (tests and
    recorded-descriptor runs)."""

    def __init__(self, clip_dim: int, mask_label_fn, label_embeds: np.ndarray,
                 text_embeds: Optional[dict] = None, device="cuda"):
        self.clip_dim = clip_dim
        self.mask_label_fn = mask_label_fn
        self.label_embeds = np.asarray(label_embeds, np.float32)
        self.text_embeds = text_embeds or {}
        self.device = resolve_device(device)

    def embed_masks(self, image, fused_maps, valid):
        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) \
                else np.asarray(x)

        labels = self.mask_label_fn(host(image), host(fused_maps),
                                    host(valid))
        out = self.label_embeds[np.clip(labels, 0, len(self.label_embeds) - 1)]
        return to_device(out, self.device)

    def embed_text(self, texts):
        return to_device(np.stack([self.text_embeds[t] for t in texts]),
                         self.device)

    def similarity(self, txt_embeds, ins_desc):
        from ..ops.similarity import clip_cosine_similarity

        return clip_cosine_similarity(txt_embeds, ins_desc)
