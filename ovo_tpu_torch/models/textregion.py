"""TextRegion per-segment embedding on the Perception-Encoder tower (port of
``ovo_tpu/models/textregion.py``).

  1. multi-resolution feature grid: the full image plus a crop grid
     (ceil-covering tiles of crop_size) run through the ViT as one batch;
     the global token grid is bilinearly upsampled to the tiled resolution
     and each tile's tokens blended in at half weight;
  2. per-mask soft feature masks: region masks bilinearly resized to the
     token grid, clamped to [0, 1];
  3. optional global-patch removal;
  4. masked attention pool with the PE probe head (q = probe, k = LN(mean
     of tokens) shared by every token, v = tokens, key mask = mask > 0)
     through kernel B6 (``ops/masked_pool``), tokens shared across masks;
  5. projection + L2 normalization in f32.

``embed_masks_batch`` runs the ViT once over the views of a micro-batch of
keyframes (B x (1 + crops)), then pools each keyframe's masks as
``embed_masks`` does.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..ops.masked_pool import masked_single_query_attention
from ..ops.resize import resize_channels_last, resize_planes
from ..utils import trace
from . import vit as vit_mod
from .clip import BaseCLIPEmbedder, CLIPModel, _normalize


class TextRegionEmbedder(BaseCLIPEmbedder):
    def __init__(self, model: CLIPModel,
                 resize_method: str = "multi_resolution",
                 remove_global_patch: bool = False,
                 global_patch_threshold: float = 0.07,
                 project_and_normalize: bool = True):
        super().__init__(model)
        self.resize_method = resize_method
        self.remove_global_patch = remove_global_patch
        self.global_patch_threshold = global_patch_threshold
        self.project_and_normalize = project_and_normalize
        self.crop_size = model.cfg.vision.image_size
        self.patch_size = model.cfg.vision.patch_size

    @torch.no_grad()
    def embed_masks(self, image, binary_maps, valid) -> torch.Tensor:
        """image (H, W, 3) u8 or f32 in [0, 1]; binary_maps (M, H, W) bool
        -> (M, clip_dim) f32 unit descriptors."""
        from .. import to_device

        img = to_device(image, self.device)
        if img.dtype not in (torch.uint8, torch.float32):
            img = img.float() / 255.0
        masks = to_device(binary_maps, self.device)
        return self._predict(img, masks)

    @torch.no_grad()
    def embed_masks_batch(self, images, binary_maps, valid) -> torch.Tensor:
        """images (B, H, W, 3), binary_maps (B, M, H, W) -> (B, M,
        clip_dim): one tower call over the B x (1 + crops) views."""
        from .. import to_device

        imgs = to_device(images, self.device)
        if imgs.dtype not in (torch.uint8, torch.float32):
            imgs = imgs.float() / 255.0
        masks = to_device(binary_maps, self.device)
        kw = self._program_kwargs(imgs.shape[1], imgs.shape[2])
        with trace.span("embedder.tower", n_kf=len(imgs)):
            views = [_textregion_views(img, **kw) for img in imgs]
            tokens = vit_mod.forward_features(
                self.model.visual, self.model.cfg.vision, torch.cat(views),
                norm=True).split([len(v) for v in views])
        pooled = []
        for tok, m in zip(tokens, masks):
            with trace.span("embedder.pool"):
                pooled.append(_textregion_pool(
                    self.model.visual, self.model.cfg.vision, tok, m, **kw))
        return torch.stack(pooled)

    def _program_kwargs(self, h: int, w: int) -> dict:
        ch, cw = self._crop_layout(h, w)
        return dict(mean=self.model._mean, std=self.model._std,
                    crop_size=self.crop_size, patch_size=self.patch_size,
                    crop_num_h=ch, crop_num_w=cw,
                    remove_global=self.remove_global_patch,
                    gp_threshold=self.global_patch_threshold,
                    project=self.project_and_normalize)

    def _crop_layout(self, h: int, w: int) -> Tuple[int, int]:
        if self.resize_method != "multi_resolution":
            return 0, 0
        return max(h // self.crop_size, 1), max(w // self.crop_size, 1)

    def _predict(self, image: torch.Tensor, masks: torch.Tensor
                 ) -> torch.Tensor:
        return _textregion_program(
            self.model.visual, self.model.cfg.vision, image, masks,
            **self._program_kwargs(image.shape[0], image.shape[1]))


@torch.no_grad()
def _textregion_program(visual: vit_mod.VisionTransformer, cfg,
                        image: torch.Tensor, masks: torch.Tensor,
                        **kw) -> torch.Tensor:
    with trace.span("embedder.tower"):
        inputs = _textregion_views(image, **kw)
        tokens = vit_mod.forward_features(visual, cfg, inputs, norm=True)
    with trace.span("embedder.pool"):
        return _textregion_pool(visual, cfg, tokens, masks, **kw)


def _textregion_views(image: torch.Tensor, *, mean: torch.Tensor,
                      std: torch.Tensor, crop_size: int, crop_num_h: int,
                      crop_num_w: int, **_) -> torch.Tensor:
    """The tower's input views of one image: the whole image, then the crop
    grid (ceil-covering tiles), each resized and normalized."""
    h, w = image.shape[:2]
    if image.dtype == torch.uint8:
        image = image.float() / 255.0

    def prep(img_hw3):
        x = resize_channels_last(img_hw3, (crop_size, crop_size))
        return (x - mean) / std

    if crop_num_h == 0:  # single-resolution path
        return prep(image)[None]
    crop_h, crop_w = -(-h // crop_num_h), -(-w // crop_num_w)
    views = [prep(image)]
    for hi in range(crop_num_h):
        for wi in range(crop_num_w):
            y1 = max(min(hi * crop_h + crop_h, h) - crop_h, 0)
            x1 = max(min(wi * crop_w + crop_w, w) - crop_w, 0)
            views.append(prep(image[y1:y1 + crop_h, x1:x1 + crop_w]))
    return torch.stack(views)


def _textregion_pool(visual: vit_mod.VisionTransformer, cfg,
                     tokens: torch.Tensor, masks: torch.Tensor, *,
                     crop_size: int, patch_size: int, crop_num_h: int,
                     crop_num_w: int, remove_global: bool,
                     gp_threshold: float, project: bool, **_
                     ) -> torch.Tensor:
    """One image's tower tokens (its views) and masks -> descriptors."""
    patch_num = crop_size // patch_size
    n_prefix = 1 if cfg.use_cls_token else 0
    if crop_num_h == 0:
        pph = ppw = patch_num
    else:
        pph, ppw = patch_num * crop_num_h, patch_num * crop_num_w
    tokens = tokens[:, n_prefix:]                       # drop cls

    if crop_num_h == 0:
        x_input = tokens[0]                             # (L, D)
    else:
        # upsample the global grid, blend each tile's tokens at half weight
        D = tokens.shape[-1]
        global_grid = tokens[0].reshape(patch_num, patch_num, D)
        canvas = resize_channels_last(global_grid, (pph, ppw))
        crop_id = 1
        for hi in range(crop_num_h):
            for wi in range(crop_num_w):
                tile = tokens[crop_id].reshape(patch_num, patch_num, D)
                y0, x0 = hi * patch_num, wi * patch_num
                win = canvas[y0:y0 + patch_num, x0:x0 + patch_num]
                canvas[y0:y0 + patch_num, x0:x0 + patch_num] = 0.5 * win + tile
                crop_id += 1
        x_input = canvas.reshape(pph * ppw, D)

    # soft feature masks: 2-tap bilinear downscale (no antialias)
    M = masks.shape[0]
    fmask = resize_planes(masks.float(), (pph, ppw))
    fmask = fmask.reshape(M, pph * ppw).clamp(0.0, 1.0)

    if remove_global:
        fmask = _remove_global_patch(x_input, fmask, gp_threshold)

    # masked attention pool with the probe head
    pool = visual.attn_pool
    n_heads = cfg.n_heads
    D = x_input.shape[-1]
    hd = D // n_heads
    # the token mean accumulates in f32 (jnp.mean upcasts bf16)
    k_in = pool.ln(x_input.float().mean(dim=0, keepdim=True).to(
        x_input.dtype))
    q = pool.q(pool.probe.to(x_input.dtype))                      # (1, D)
    k = pool.k(k_in)                                              # (1, D)
    v = pool.v(x_input)                                           # (L, D)
    Lt = v.shape[0]
    qh = q.reshape(1, n_heads, hd).expand(M, n_heads, hd).contiguous()
    kh = k.reshape(n_heads, 1, hd).expand(n_heads, Lt, hd)        # stride 0
    vh = v.reshape(Lt, n_heads, hd).transpose(0, 1)               # view
    pooled = masked_single_query_attention(qh, kh, vh, fmask > 0)
    pooled = pool.out(pooled.reshape(M, D))

    if not project:
        return pooled.float()
    # project + normalize in f32: descriptors are accumulated downstream
    region = pooled.float() @ visual.proj.float()
    return _normalize(region)


def _remove_global_patch(x_input: torch.Tensor, fmask: torch.Tensor,
                         threshold: float) -> torch.Tensor:
    """Zero mask weights of patches more similar to the outside of regions
    than the inside."""
    x = x_input.float()
    unit = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(
        1e-12)
    sim = unit @ unit.T                                   # (L, L)
    inside = (fmask > 0).float()                          # (M, L)
    p2r = sim @ inside.T                                  # (L, M)
    p2r_avg = p2r / inside.sum(dim=-1).clamp_min(1e-9)
    belong = (p2r_avg * inside.T).sum(dim=-1) / (inside.sum(dim=0) + 1e-9)
    outside = 1.0 - inside
    out_score = (p2r_avg * outside.T).sum(dim=-1) / (outside.sum(dim=0)
                                                     + 1e-9)
    diff = belong - out_score                             # (L,)
    return torch.where(diff[None, :] < threshold, torch.zeros_like(fmask),
                       fmask)
