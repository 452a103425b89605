"""The image towers and the two embedders the configurations run:
TextRegion over PE-Core (``embed_type: TextRegion``) and the paper's crop
descriptor over SigLIP with the learned merger (``embed_type: learned``).

A configuration file states its tower (``tower``: the ViT's sizes, its
normalization and descriptor width) and, for the crop descriptor, its
merger (``merger``). The program's tower is its own registry card of the
same name, checked against the file; the reference's is built from the
file's numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ..reference.models import clip as ref_clip
from ..reference.models import merger as ref_merger
from ..reference.models import textregion as ref_textregion
from ..reference.models import vit as ref_vit
from ..weights import load_module, module_weights

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def vit_config(tower: Dict[str, Any], dtype=None) -> ref_vit.ViTConfig:
    kw = {k: v for k, v in tower["vision"].items() if k != "dtype"}
    return ref_vit.ViTConfig(dtype=dtype or DTYPES[tower["vision"]["dtype"]],
                             **kw)


def make_weights(cfg: Dict[str, Any], gen: torch.Generator):
    """{"tower": name -> tensor, "merger": name -> tensor (crop descriptor
    only)} on the generator's device, each in the dtype the program holds
    it in."""
    skel = ref_vit.VisionTransformer(vit_config(cfg["tower"]), device="meta")
    out = {"tower": module_weights(skel, gen)}
    if "merger" in cfg:
        m = ref_merger.MergerParams(**cfg["merger"], device="meta")
        out["merger"] = module_weights(m, gen)
    return out


def _check_card(card, tower: Dict[str, Any]) -> None:
    """The program's card has the configuration's widths."""
    want = vit_config(tower)
    got = {f.name: getattr(card.vision, f.name)
           for f in dataclasses.fields(want)}
    diff = {k: (got[k], getattr(want, k)) for k in got
            if got[k] != getattr(want, k)}
    if diff or tuple(card.mean) != tuple(tower["mean"]) or \
            tuple(card.std) != tuple(tower["std"]) or \
            card.clip_dim != tower["clip_dim"]:
        raise ValueError(f"program card {card.name} differs from the "
                         f"configuration: {diff}")


def build_program(cfg: Dict[str, Any], weights, device: torch.device):
    from ovo_tpu_torch.models import vit
    from ovo_tpu_torch.models.clip import (MODEL_REGISTRY, CLIPModel,
                                           CropCLIPEmbedder)

    clip = cfg["program"]["semantic"]["clip"]
    card = MODEL_REGISTRY[clip["model_card"]]
    _check_card(card, cfg["tower"])
    visual = load_module(vit.VisionTransformer(card.vision, device=device),
                         weights["tower"])
    model = CLIPModel(card, visual, device)
    if clip["embed_type"] == "TextRegion":
        from ovo_tpu_torch.models.textregion import TextRegionEmbedder

        return TextRegionEmbedder(
            model, resize_method=clip.get("resize_method", "multi_resolution"),
            remove_global_patch=clip.get("remove_global_patch", False),
            project_and_normalize=clip.get("project_and_normalize", True))
    from ovo_tpu_torch.models.merger import LearnedMerger, MergerParams

    merger = LearnedMerger(load_module(
        MergerParams(**cfg["merger"], device=device), weights["merger"]),
        n_heads=cfg["merger"]["n_heads"])
    return CropCLIPEmbedder(model, clip["embed_type"],
                            mask_res=clip.get("mask_res", 336),
                            w_masked=clip.get("w_masked", 0.4418),
                            w_global=clip.get("w_global", 0.1), merger=merger)


class _RefMerger:
    def __init__(self, params, n_heads):
        self.params, self.n_heads = params, n_heads

    def __call__(self, clips):
        return ref_merger.merger_apply(self.params, clips, self.n_heads)


def build_reference(cfg: Dict[str, Any], weights, device: torch.device):
    """The reference embedder over the same weights, in float32."""
    tower = cfg["tower"]
    card = ref_clip.VisionCard(name=tower["name"],
                               vision=vit_config(tower, torch.float32),
                               mean=tuple(tower["mean"]),
                               std=tuple(tower["std"]),
                               clip_dim=tower["clip_dim"])
    visual = load_module(ref_vit.VisionTransformer(card.vision, device=device),
                         weights["tower"])
    model = ref_clip.VisionModel(card, visual)
    clip = cfg["program"]["semantic"]["clip"]
    if clip["embed_type"] == "TextRegion":
        return ref_textregion.TextRegionEmbedder(
            model, resize_method=clip.get("resize_method", "multi_resolution"),
            remove_global_patch=clip.get("remove_global_patch", False),
            project_and_normalize=clip.get("project_and_normalize", True))
    merger = _RefMerger(load_module(
        ref_merger.MergerParams(**cfg["merger"], device=device),
        weights["merger"]), cfg["merger"]["n_heads"])
    return ref_clip.CropCLIPEmbedder(model, clip["embed_type"],
                                     mask_res=clip.get("mask_res", 336),
                                     w_masked=clip.get("w_masked", 0.4418),
                                     w_global=clip.get("w_global", 0.1),
                                     merger=merger)


def descriptor_gap(prog: torch.Tensor, ref: torch.Tensor,
                   keep: torch.Tensor) -> float:
    """Largest 1 - cos between the program's and the reference's
    descriptors over the kept rows (0 when none is kept)."""
    if not bool(keep.any()):
        return 0.0
    a = torch.nn.functional.normalize(prog[keep].double(), dim=-1)
    b = torch.nn.functional.normalize(ref[keep].double(), dim=-1)
    return float((1.0 - (a * b).sum(dim=-1)).amax())


def cost_part(cfg: Dict[str, Any], batch: int, image_hw):
    """The embedder's share of a keyframe for ``costs.keyframe_costs``, in
    the tower's dtype on the meta device: TextRegion's views of a
    micro-batch through the tower and each image's masked pool; or the
    crop descriptor's masked, bbox and global views and the merger."""
    from ..costs import Part

    tower, clip = cfg["tower"], cfg["program"]["semantic"]["clip"]
    M = cfg["program"]["semantic"]["capacity"]["n_masks"]
    vcfg = vit_config(tower)
    H, W = image_hw

    def model():
        skel = ref_vit.VisionTransformer(vcfg, device="meta")
        card = ref_clip.VisionCard(name=tower["name"], vision=vcfg,
                                   mean=tuple(tower["mean"]),
                                   std=tuple(tower["std"]),
                                   clip_dim=tower["clip_dim"])
        return ref_clip.VisionModel(card, skel)

    if clip["embed_type"] == "TextRegion":
        def run():
            emb = ref_textregion.TextRegionEmbedder(model())
            kw = emb._program_kwargs(H, W)
            views = [ref_textregion._textregion_views(
                torch.empty((H, W, 3), device="meta"), **kw)
                for _ in range(batch)]
            tokens = ref_vit.forward_features(
                emb.model.visual, vcfg, torch.cat(views), norm=True
            ).split([len(v) for v in views])
            masks = torch.empty((M, H, W), dtype=torch.bool, device="meta")
            for tok in tokens:
                ref_textregion._textregion_pool(emb.model.visual, vcfg, tok,
                                                masks, **kw)

        return Part("embedder", vcfg.dtype, run, per=batch)

    def run():
        vm = model()
        s = clip.get("mask_res", 336)
        for _ in range(batch):
            vm.encode_image(torch.empty((M, s, s, 3), device="meta"))
            vm.encode_image(torch.empty((M, s, s, 3), device="meta"))
            vm.encode_image(torch.empty((1, H, W, 3), device="meta"))
            m = ref_merger.MergerParams(**cfg["merger"], device="meta")
            ref_merger.merger_apply(m, torch.empty(
                (M, 3, tower["clip_dim"]), device="meta"),
                cfg["merger"]["n_heads"])

    return Part("embedder", vcfg.dtype, run, per=batch)
