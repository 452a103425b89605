"""The crop embedder's pieces and the vision cards the benchmark runs,
frozen from the port's ``models/clip.py``: ``VisionModel`` (an image tower
with its normalization), ``roi_crops`` and ``CropCLIPEmbedder``. No text
tower: the benchmark issues no text query."""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .. import to_device
from ..ops.resize import resize_channels_last, scale_and_translate
from ..ops.similarity import _normalize, fuse_clips
from . import vit as vit_mod
from .vit import ViTConfig

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class VisionCard:
    name: str
    vision: ViTConfig
    mean: Tuple[float, float, float] = OPENAI_MEAN
    std: Tuple[float, float, float] = OPENAI_STD
    clip_dim: int = 1024


class VisionModel:
    """An image tower on one device with its input normalization."""

    def __init__(self, cfg: VisionCard, visual: vit_mod.VisionTransformer):
        self.cfg = cfg
        self.visual = visual
        self.device = next(visual.parameters()).device
        self._mean = torch.tensor(cfg.mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(cfg.std, dtype=torch.float32,
                                 device=self.device)

    def preprocess(self, images: torch.Tensor) -> torch.Tensor:
        """images (..., H, W, 3) float in [0, 1] -> normalized model
        input at the tower's resolution."""
        size = self.cfg.vision.image_size
        if images.shape[-3] != size or images.shape[-2] != size:
            lead = images.shape[:-3]
            flat = images.reshape((-1,) + tuple(images.shape[-3:]))
            flat = resize_channels_last(flat, (size, size))
            images = flat.reshape(tuple(lead) + (size, size, 3))
        return (images - self._mean) / self._std

    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return vit_mod.encode(self.visual, self.cfg.vision,
                              self.preprocess(images))


@torch.no_grad()
def roi_crops(image: torch.Tensor, masks: torch.Tensor, *, out_size: int,
              bbox_margin: int = 50) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each mask: (a) the masked-object crop on a black background,
    square-padded around its bbox and resized to (out_size, out_size); (b)
    the bbox crop grown by ``bbox_margin`` px (clipped to the image),
    resized with no padding. image (H, W, 3) f32 in [0, 1]; masks (M, H, W)
    bool. Returns (seg_imgs, bbox_imgs), each (M, s, s, 3) f32. Bboxes are
    computed on the device (an empty mask becomes (0, 0, 1, 1)), so nothing
    waits on the host."""
    H, W = image.shape[:2]
    dev = image.device
    rows, cols = masks.any(dim=2), masks.any(dim=1)          # (M, H), (M, W)
    ridx = torch.arange(H, device=dev)
    cidx = torch.arange(W, device=dev)
    y0 = torch.where(rows, ridx, H).amin(dim=1)
    y1 = torch.where(rows, ridx, -1).amax(dim=1)
    x0 = torch.where(cols, cidx, W).amin(dim=1)
    x1 = torch.where(cols, cidx, -1).amax(dim=1)
    empty = ~rows.any(dim=1)
    zero, one = torch.zeros_like(x0), torch.ones_like(x0)
    w = torch.where(empty, one, x1 + 1 - x0)
    h = torch.where(empty, one, y1 + 1 - y0)
    x0, y0 = torch.where(empty, zero, x0), torch.where(empty, zero, y0)

    # 1 / (out_size / window) as the reference's compiled program evaluates
    # it, window * f32(1 / out_size): the sample positions then agree to the
    # last bit (a mask's edge moves with one f32 step of them)
    rcp = torch.full((), 1.0 / out_size, dtype=torch.float32, device=dev)
    # out_size / x as a true quotient (a Python number over a tensor is
    # computed as number * (1 / x), another rounding)
    size = torch.full((), float(out_size), dtype=torch.float32, device=dev)

    def window(nh_, nw_):
        return torch.stack([nh_.float() * rcp, nw_.float() * rcp], dim=1)

    # (a) masked image, bbox centered in a square window, resized
    masked = torch.where(masks[..., None], image, torch.zeros_like(image))
    side = torch.maximum(w, h).float()
    sx0 = x0.float() - (side - w.float()) / 2
    sy0 = y0.float() - (side - h.float()) / 2
    s = size / side
    seg = scale_and_translate(masked, (out_size, out_size),
                              torch.stack([s, s], dim=1),
                              -torch.stack([sy0 * s, sx0 * s], dim=1),
                              inv_scale=window(side, side))

    # (b) the bbox grown by the margin, clipped to the image, resized
    nx0 = torch.clamp(x0 - bbox_margin, min=0)
    ny0 = torch.clamp(y0 - bbox_margin, min=0)
    nw = torch.minimum(w + (x0 - nx0) + bbox_margin, W - nx0)
    nh = torch.minimum(h + (y0 - ny0) + bbox_margin, H - ny0)
    sy, sx = size / nh.float(), size / nw.float()
    bbox = scale_and_translate(image, (out_size, out_size),
                               torch.stack([sy, sx], dim=1),
                               -torch.stack([ny0.float() * sy,
                                             nx0.float() * sx], dim=1),
                               inv_scale=window(nh, nw))
    return seg, bbox


class CropCLIPEmbedder:
    """The vanilla and multi-crop fusion pipelines: ``vanilla`` embeds the
    masked crop; the others also embed the bbox crop and the whole image
    and fuse the three (``fixed_weights``, ``adaptive_weights``, ``hovsg``,
    ``concept_fusion``, or ``learned`` through the merger)."""

    def __init__(self, model: VisionModel, embed_type: str = "vanilla",
                 mask_res: int = 336, w_masked: float = 0.4418,
                 w_global: float = 0.1, merger=None):
        self.model = model
        self.device = model.device
        self.clip_dim = model.cfg.clip_dim
        self.embed_type = embed_type
        self.mask_res = mask_res
        self.w_masked = w_masked
        self.w_global = w_global
        self.merger = merger

    @torch.no_grad()
    def embed_masks(self, image, binary_maps, valid) -> torch.Tensor:
        """image (H, W, 3) u8 (host or device); binary_maps (M, H, W) bool
        -> (M, clip_dim) f32 unit descriptors."""
        img = to_device(image, self.device).float() / 255.0
        masks = to_device(binary_maps, self.device)
        seg_imgs, bbox_imgs = roi_crops(img, masks, out_size=self.mask_res)
        clip_seg = _normalize(self.model.encode_image(seg_imgs))
        if self.embed_type == "vanilla":
            return clip_seg
        clip_bbox = _normalize(self.model.encode_image(bbox_imgs))
        clip_g = _normalize(self.model.encode_image(img[None]))
        clip_g = clip_g.expand_as(clip_seg)
        if self.embed_type == "learned":
            if self.merger is None:
                raise ValueError("learned fusion needs a merger")
            return self.merger(torch.stack([clip_g, clip_seg, clip_bbox],
                                           dim=1))
        return fuse_clips(clip_g, clip_seg, clip_bbox, self.embed_type,
                          self.w_masked, self.w_global)
