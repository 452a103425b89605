"""SAM models: the SAM2 family (Hiera trunk + FPN neck) and the SAM1
family (ViT-det trunk with its own neck, the decoder without object-score
token and high-res skips), each with the prompt encoder and the mask
decoder, assembled for batched grid-prompted inference (port of
``ovo_tpu/models/sam/model.py``). ``encoder`` names the family: ``vit_*``
cards are SAM1 (the reference's ``sam_version: ""``), ``hiera_*`` SAM2.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ... import resolve_device
from ...ops.resize import resize_channels_last
from .decoder import decode_masks, init_mask_decoder
from .hiera import HIERA_CONFIGS, HieraConfig, hiera_forward, init_hiera
from .neck import conv1x1, init_neck, neck_forward
from .params import Init, ParamTree
from .prompt import encode_points, init_prompt_encoder, pe_grid

SAM_MEAN = (0.485, 0.456, 0.406)
SAM_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class SAMConfig:
    encoder: str = "hiera_l"
    image_size: int = 1024
    d_model: int = 256
    compute_dtype: str = "bfloat16"

    @property
    def family(self) -> str:
        """"sam1" for ViT-det encoders, "sam2" for Hiera."""
        return "sam1" if self.encoder.startswith("vit") else "sam2"

    @property
    def hiera(self) -> HieraConfig:
        return HIERA_CONFIGS[self.encoder]

    @property
    def dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


def init_sam(cfg: SAMConfig, gen: Optional[torch.Generator],
             device) -> Dict[str, Any]:
    """The param tree of the JAX package's ``SAMModel.random_init``:
    random leaves from ``gen``, or zeros without it. SAM1: the ViT-det
    trunk carries its own neck, and the decoder has neither the
    object-score token nor the high-res skip convolutions."""
    init = Init(gen, device)
    if cfg.family == "sam1":
        raise ValueError("the reference holds the SAM2 family only")
    hcfg = cfg.hiera
    channels = tuple(int(hcfg.embed_dim * hcfg.dim_mul ** i)
                     for i in range(4))
    return {"trunk": init_hiera(init, hcfg),
            "neck": init_neck(init, channels, cfg.d_model),
            "prompt": init_prompt_encoder(init, cfg.d_model),
            "decoder": init_mask_decoder(init, cfg.d_model)}


class SAMModel:
    def __init__(self, cfg: SAMConfig, params, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if not isinstance(params, ParamTree):
            params = ParamTree(params, cfg.dtype)
        self.params = params.to(self.device)
        self._mean = torch.tensor(SAM_MEAN, dtype=torch.float32,
                                  device=self.device)
        self._std = torch.tensor(SAM_STD, dtype=torch.float32,
                                 device=self.device)

    @classmethod
    def random_init(cls, encoder: str = "hiera_l", image_size: int = 1024,
                    seed: int = 0, device="cuda",
                    compute_dtype: str = "bfloat16") -> "SAMModel":
        """Random weights from a seeded ``torch.Generator`` on ``device``
        (the reference's shapes and stds; numbers differ from JAX's PRNG)."""
        cfg = SAMConfig(encoder=encoder, image_size=image_size,
                        compute_dtype=compute_dtype)
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return cls(cfg, init_sam(cfg, gen, dev), dev)

    # ------------------------------------------------------------------
    def resized_hw(self, h: int, w: int) -> Tuple[int, int]:
        """SAM1's ResizeLongestSide target (get_preprocess_shape: int(dim *
        S / max + 0.5))."""
        scale = self.cfg.image_size / max(h, w)
        return int(h * scale + 0.5), int(w * scale + 0.5)

    def point_scale(self, h: int, w: int) -> Tuple[float, float]:
        """(sx, sy) taking [0, 1] original-image points into the model's
        input square: SAM2 (square resize) the identity; SAM1 the top-left
        (nh, nw) the resized image fills."""
        if self.cfg.family != "sam1":
            return (1.0, 1.0)
        nh, nw = self.resized_hw(h, w)
        s = self.cfg.image_size
        return (nw / s, nh / s)

    def preprocess(self, image: torch.Tensor) -> torch.Tensor:
        """(H, W, 3) float [0, 1] -> (1, S, S, 3) normalized, compute
        dtype. SAM2: square resize (the SAM2 predictor's convention). SAM1:
        the longest side resized to S, aspect kept, then zero padding at
        the bottom and the right (zero is the normalized mean)."""
        s = self.cfg.image_size
        if self.cfg.family == "sam1":
            nh, nw = self.resized_hw(image.shape[0], image.shape[1])
            img = resize_channels_last(image, (nh, nw))
            img = F.pad((img - self._mean) / self._std,
                        (0, 0, 0, s - nw, 0, s - nh))
            return img[None].to(self.cfg.dtype)
        img = resize_channels_last(image, (s, s))
        return ((img - self._mean) / self._std)[None].to(self.cfg.dtype)

    def encode_images(self, images: torch.Tensor, *,
                      window_attn: str = "heads"
                      ) -> Tuple[torch.Tensor,
                                 Optional[List[torch.Tensor]]]:
        """(B, S, S, 3) preprocessed images -> (image_embeds (B, H16, W16,
        d), high_res [(B, H4, W4, 32), (B, H8, W8, 64)]): the trunk and the
        neck run once over the batch; ``window_attn`` picks the Hiera
        trunk's window attention (``hiera.hiera_forward``). SAM1 (ViT-det)
        has no high-res features: (embeds, None)."""
        if self.cfg.family == "sam1":
            raise ValueError("the reference holds the SAM2 family only")
        feats = hiera_forward(self.params["trunk"], self.cfg.hiera, images,
                              window_attn=window_attn)
        fpn = neck_forward(self.params["neck"], feats)
        # scalp: the lowest-resolution level (stride 32) is dropped
        s4, s8, s16 = fpn[0], fpn[1], fpn[2]
        dec = self.params["decoder"]
        return s16, [conv1x1(dec["conv_s0"], s4), conv1x1(dec["conv_s1"], s8)]

    def encode_image(self, image: torch.Tensor, *, window_attn: str = "heads"
                     ) -> Tuple[torch.Tensor, Optional[List[torch.Tensor]]]:
        """(1, S, S, 3) -> (image_embed (H16, W16, d), high_res [(H4, W4,
        32), (H8, W8, 64)], or None for SAM1) for the decoder
        (:meth:`encode_images`)."""
        embeds, high_res = self.encode_images(image, window_attn=window_attn)
        return embeds[0], (None if high_res is None
                           else [h[0] for h in high_res])

    def decode_grid(self, image_embed: torch.Tensor,
                    high_res: List[torch.Tensor], points01: torch.Tensor,
                    mask_channels=None, top_prompts=None, *,
                    route: Optional[str] = None,
                    mask_tail: str = "unfused") -> Dict[str, torch.Tensor]:
        """Batched single-point prompts: points01 (P, 2) in [0, 1] -> masks
        (P', C, H4, W4) logits + iou (P', C) over ``mask_channels`` (P' =
        top_prompts when the predicted-IoU gate is active); ``route`` and
        ``mask_tail`` pick the decoder's routes (``decoder.decode_masks``)."""
        H, W, _ = image_embed.shape
        P = points01.shape[0]
        sparse = encode_points(
            self.params["prompt"], points01[:, None, :],
            torch.ones((P, 1), dtype=torch.int32, device=points01.device))
        image_pe = pe_grid(self.params["prompt"], H, W)
        return decode_masks(self.params["decoder"], image_embed, image_pe,
                            sparse, high_res_feats=high_res,
                            mask_channels=mask_channels,
                            top_prompts=top_prompts, route=route,
                            mask_tail=mask_tail)
