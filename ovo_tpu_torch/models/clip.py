"""CLIP-family model cards, the image and text towers, and the per-segment
embedders (port of ``ovo_tpu/models/clip.py``).

  - ``MODEL_REGISTRY``: every card of the reference, with its text tower,
    normalization constants and similarity (cosine, or SigLIP's sigmoid);
  - ``CLIPModel``: towers + ``logit_scale`` / ``logit_bias`` + tokenizer on
    one device, with ``preprocess``, ``encode_image``, ``encode_text`` and
    ``similarity``;
  - ``roi_crops``: per mask, the masked crop square-padded on black and the
    bbox crop grown by a margin, resized on the device with no host sync;
  - ``CropCLIPEmbedder``: the vanilla and multi-crop pipelines (global +
    masked crop + bbox crop fused by fixed / adaptive / hovsg / concept
    fusion weights or the learned merger); ``TextRegionEmbedder`` lives in
    ``models/textregion.py``; ``build_clip_embedder`` picks one from the
    config's clip section.

The SigLIP image towers run their self-attention through kernel B10
(``ops/attention.fused_attention``); PE's through B5.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from .. import resolve_device, to_device
from ..ops.resize import resize_channels_last, scale_and_translate
from ..ops.similarity import (_normalize, clip_cosine_similarity,
                              fuse_clips, siglip_similarity)
from . import text as text_mod
from . import vit as vit_mod
from .text import TextConfig
from .tokenizers import get_tokenizer
from .vit import ViTConfig

OPENAI_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_STD = (0.26862954, 0.26130258, 0.27577711)
SIGLIP_MEAN = (0.5, 0.5, 0.5)
SIGLIP_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class CLIPModelConfig:
    name: str
    vision: ViTConfig
    text: TextConfig
    mean: Tuple[float, float, float] = OPENAI_MEAN
    std: Tuple[float, float, float] = OPENAI_STD
    siglip: bool = False           # sigmoid similarity w/ scale+bias
    clip_dim: int = 1024


def _siglip_text(vocab_size: int) -> TextConfig:
    return TextConfig(vocab_size=vocab_size, context_length=64, width=1152,
                      depth=27, n_heads=16, mlp_ratio=3.7362, embed_dim=1152,
                      causal=False, pool="last")


def _siglip_vision(image_size: int, patch_size: int) -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=patch_size,
                     width=1152, depth=27, n_heads=16, mlp_ratio=3.7362,
                     embed_dim=1152, use_cls_token=False, use_abs_pos=True,
                     pool="attn")


def _clip_text(width: int, depth: int, heads: int, act: str = "gelu"
               ) -> TextConfig:
    return TextConfig(vocab_size=49408, context_length=77, width=width,
                      depth=depth, n_heads=heads, embed_dim=width,
                      causal=True, pool="argmax", act=act)


def _dfn_vision(image_size: int, patch_size: int, width: int, depth: int,
                heads: int, embed_dim: int) -> ViTConfig:
    return ViTConfig(image_size=image_size, patch_size=patch_size,
                     width=width, depth=depth, n_heads=heads,
                     embed_dim=embed_dim, use_cls_token=True,
                     use_abs_pos=True, pool="cls", ln_pre=True,
                     act="quick_gelu")


# the published model cards the reference selects from, as the JAX
# package's registry has them
MODEL_REGISTRY: Dict[str, CLIPModelConfig] = {
    "PE-Core-L14-336": CLIPModelConfig(
        name="PE-Core-L14-336",
        vision=ViTConfig(image_size=336, patch_size=14, width=1024, depth=24,
                         n_heads=16, embed_dim=1024, use_cls_token=True,
                         use_abs_pos=True, use_rope2d=True, pool="attn",
                         dtype=torch.bfloat16),
        text=TextConfig(vocab_size=49408, context_length=32, width=1024,
                        depth=24, n_heads=16, embed_dim=1024, causal=True,
                        pool="argmax"),
        clip_dim=1024),
    "SigLIP-384": CLIPModelConfig(
        name="SigLIP-384", vision=_siglip_vision(384, 14),
        text=_siglip_text(32000), mean=SIGLIP_MEAN, std=SIGLIP_STD,
        siglip=True, clip_dim=1152),
    "ViT-H-14": CLIPModelConfig(
        name="ViT-H-14",
        vision=ViTConfig(image_size=224, patch_size=14, width=1280, depth=32,
                         n_heads=16, embed_dim=1024, use_cls_token=True,
                         use_abs_pos=True, pool="cls", ln_pre=True),
        text=TextConfig(vocab_size=49408, context_length=77, width=1024,
                        depth=24, n_heads=16, embed_dim=1024, causal=True,
                        pool="argmax"),
        clip_dim=1024),
    # hf-hub:timm/ViT-SO400M-14-SigLIP @ 224
    "SigLIP": CLIPModelConfig(
        name="SigLIP", vision=_siglip_vision(224, 14),
        text=_siglip_text(32000), mean=SIGLIP_MEAN, std=SIGLIP_STD,
        siglip=True, clip_dim=1152),
    # hf-hub:timm/ViT-SO400M-16-SigLIP2-384: patch 16, Gemma 256k vocabulary
    "SigLIP2-384": CLIPModelConfig(
        name="SigLIP2-384", vision=_siglip_vision(384, 16),
        text=_siglip_text(256000), mean=SIGLIP_MEAN, std=SIGLIP_STD,
        siglip=True, clip_dim=1152),
    # hf-hub:apple/DFN2B-CLIP-ViT-B-16: OpenAI-CLIP architecture, quick-gelu
    "ViT-B-16-qg": CLIPModelConfig(
        name="ViT-B-16-qg", vision=_dfn_vision(224, 16, 768, 12, 12, 512),
        text=TextConfig(vocab_size=49408, context_length=77, width=512,
                        depth=12, n_heads=8, embed_dim=512, causal=True,
                        pool="argmax", act="quick_gelu"),
        clip_dim=512),
    # hf-hub:apple/DFN2B-CLIP-ViT-L-14-39B
    "ViT-L-14-qg": CLIPModelConfig(
        name="ViT-L-14-qg", vision=_dfn_vision(224, 14, 1024, 24, 16, 768),
        text=_clip_text(768, 12, 12, "quick_gelu"), clip_dim=768),
    # hf-hub:apple/DFN5B-CLIP-ViT-H-14
    "ViT-H-14-qg": CLIPModelConfig(
        name="ViT-H-14-qg", vision=_dfn_vision(224, 14, 1280, 32, 16, 1024),
        text=_clip_text(1024, 24, 16, "quick_gelu"), clip_dim=1024),
    # hf-hub:apple/DFN5B-CLIP-ViT-H-14-378
    "ViT-H-14-378qg": CLIPModelConfig(
        name="ViT-H-14-378qg",
        vision=_dfn_vision(378, 14, 1280, 32, 16, 1024),
        text=_clip_text(1024, 24, 16, "quick_gelu"), clip_dim=1024),
}
# the reference spells the PE card with an extra dash
MODEL_REGISTRY["PE-Core-L-14-336"] = MODEL_REGISTRY["PE-Core-L14-336"]
# test-scale model for structural tests and smoke runs
MODEL_REGISTRY["tiny-test"] = CLIPModelConfig(
    name="tiny-test",
    vision=ViTConfig(image_size=64, patch_size=16, width=64, depth=2,
                     n_heads=4, embed_dim=32, use_cls_token=True,
                     use_abs_pos=True, pool="attn"),
    text=TextConfig(vocab_size=1024, context_length=16, width=64, depth=2,
                    n_heads=4, embed_dim=32, causal=True, pool="argmax"),
    clip_dim=32)
# PE-Core structure at test scale (RoPE-2D + cls + abs-pos + probe pool, f32)
MODEL_REGISTRY["tiny-pe"] = CLIPModelConfig(
    name="tiny-pe",
    vision=ViTConfig(image_size=64, patch_size=16, width=64, depth=3,
                     n_heads=4, embed_dim=32, use_cls_token=True,
                     use_abs_pos=True, use_rope2d=True, pool="attn"),
    text=TextConfig(vocab_size=1024, context_length=16, width=64, depth=3,
                    n_heads=4, embed_dim=32, causal=True, pool="argmax"),
    clip_dim=32)

Card = Union[str, CLIPModelConfig]


def _card(name: Card) -> CLIPModelConfig:
    return name if isinstance(name, CLIPModelConfig) else MODEL_REGISTRY[name]


class CLIPModel:
    """Image + text towers, logit scale / bias and the tokenizer on one
    device."""

    def __init__(self, cfg: CLIPModelConfig,
                 visual: vit_mod.VisionTransformer, device="cuda",
                 text: Optional[text_mod.TextTransformer] = None,
                 logit_scale: float = math.log(1 / 0.07),
                 logit_bias: Optional[float] = None, tokenizer=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.visual = visual.to(self.device)
        self.text = text.to(self.device) if text is not None else None
        bias = logit_bias if logit_bias is not None else (
            -10.0 if cfg.siglip else 0.0)
        self.logit_scale = torch.full((), float(logit_scale),
                                      dtype=torch.float32, device=self.device)
        self.logit_bias = torch.full((), float(bias), dtype=torch.float32,
                                     device=self.device)
        self.tokenizer = tokenizer or get_tokenizer(
            context_length=cfg.text.context_length, card=cfg)
        self._mean = torch.tensor(cfg.mean, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(cfg.std, dtype=torch.float32,
                                 device=self.device)

    @classmethod
    def random_init(cls, name: Card, seed: int = 0,
                    device="cuda") -> "CLIPModel":
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (the reference's stds; numbers differ from JAX's PRNG). ``name``:
        a registry card or a ``CLIPModelConfig``."""
        dev = resolve_device(device)
        cfg = _card(name)
        gen = torch.Generator(device=dev).manual_seed(seed)
        visual = vit_mod.init_vit(cfg.vision, gen, device=dev)
        text = text_mod.init_text(cfg.text, gen, device=dev)
        return cls(cfg, visual, dev, text=text)

    @classmethod
    def from_jax_params(cls, name: Card, params: Dict[str, Any],
                        device="cuda", tokenizer=None) -> "CLIPModel":
        """Model from the JAX package's param tree (numpy leaves), e.g.
        ``ovo_tpu``'s ``CLIPModel.params`` converted with ``np.asarray``, or
        a converted checkpoint (``models/convert.py``): the ``visual`` tree
        (with the SigLIP MAP head's MLP when present, its keys' norm when
        not None) and, when present, ``text``, ``logit_scale`` and
        ``logit_bias``."""
        from .convert_jax import load_jax_params

        dev = resolve_device(device)
        cfg = _card(name)
        pool = params["visual"].get("attn_pool") or {}
        hidden = (pool["mlp"]["fc"]["w"].shape[1]
                  if pool.get("mlp") is not None else None)
        visual = vit_mod.VisionTransformer(
            cfg.vision, device=dev, map_mlp_hidden=hidden,
            pool_ln=pool.get("ln") is not None)
        load_jax_params(visual, params["visual"], dev)
        text = (text_mod.text_from_jax_params(cfg.text, params["text"], dev)
                if params.get("text") is not None else None)
        kw = {k: float(params[k]) for k in ("logit_scale", "logit_bias")
              if params.get(k) is not None}
        return cls(cfg, visual, dev, text=text, tokenizer=tokenizer, **kw)

    # -- preprocessing (resize + normalize) ------------------------------
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

    # -- encoders ---------------------------------------------------------
    @torch.no_grad()
    def encode_image(self, images: torch.Tensor) -> torch.Tensor:
        return vit_mod.encode(self.visual, self.cfg.vision,
                              self.preprocess(images))

    @torch.no_grad()
    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        if self.text is None:
            raise ValueError(f"{self.cfg.name}: no text tower loaded")
        tokens = to_device(self.tokenizer(list(texts)), self.device)
        return text_mod.encode_text(self.text, self.cfg.text, tokens)

    def similarity(self, txt_embeds: torch.Tensor,
                   img_embeds: torch.Tensor) -> torch.Tensor:
        if self.cfg.siglip:
            return siglip_similarity(txt_embeds, img_embeds,
                                     self.logit_scale, self.logit_bias)
        return clip_cosine_similarity(txt_embeds, img_embeds)


# ---------------------------------------------------------------------------
# Device ROI crops (the reference's segmap2segimg)
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Embedders
# ---------------------------------------------------------------------------

class BaseCLIPEmbedder:
    def __init__(self, model: CLIPModel):
        self.model = model
        self.device = model.device
        self.clip_dim = model.cfg.clip_dim

    def embed_text(self, texts: Sequence[str]) -> torch.Tensor:
        return _normalize(self.model.encode_text(texts))

    def similarity(self, txt_embeds: torch.Tensor,
                   ins_desc: torch.Tensor) -> torch.Tensor:
        return self.model.similarity(txt_embeds, ins_desc)


class CropCLIPEmbedder(BaseCLIPEmbedder):
    """The vanilla and multi-crop fusion pipelines: ``vanilla`` embeds the
    masked crop; the others also embed the bbox crop and the whole image
    and fuse the three (``fixed_weights``, ``adaptive_weights``, ``hovsg``,
    ``concept_fusion``, or ``learned`` through the merger)."""

    def __init__(self, model: CLIPModel, embed_type: str = "vanilla",
                 mask_res: int = 336, w_masked: float = 0.4418,
                 w_global: float = 0.1, merger=None):
        super().__init__(model)
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


def build_clip_embedder(clip_cfg: Dict[str, Any], embed_type: str,
                        device="cuda"):
    """Factory from the reference's clip config section: TextRegion, or a
    crop embedder for every other ``embed_type``, on a registry card; the
    open_clip / PE checkpoint at ``ckpt_path`` when it exists
    (``convert.load_clip_checkpoint``), else seeded random weights."""
    card = clip_cfg.get("model_card", "SigLIP-384").replace(
        "PE-Core-L-14-336", "PE-Core-L14-336")
    ckpt_path = clip_cfg.get("ckpt_path")
    if ckpt_path and os.path.exists(ckpt_path):
        from .convert import load_clip_checkpoint

        model = load_clip_checkpoint(card, ckpt_path, device=device)
    else:
        model = CLIPModel.random_init(card, device=device)
        if ckpt_path:
            print(f"[ovo_tpu_torch] WARNING: checkpoint {ckpt_path} not "
                  f"found; using random weights for {card}")
    if embed_type == "TextRegion":
        from .textregion import TextRegionEmbedder

        return TextRegionEmbedder(
            model,
            resize_method=clip_cfg.get("resize_method", "multi_resolution"),
            remove_global_patch=clip_cfg.get("remove_global_patch", False),
            project_and_normalize=clip_cfg.get("project_and_normalize", True))
    merger = None
    if embed_type == "learned":
        from .merger import load_merger

        merger = load_merger(clip_cfg.get("weights_predictor_path"),
                             device=model.device)
    return CropCLIPEmbedder(model, embed_type,
                            mask_res=clip_cfg.get("mask_res", 336),
                            w_masked=clip_cfg.get("w_masked", 0.4418),
                            w_global=clip_cfg.get("w_global", 0.1),
                            merger=merger)
