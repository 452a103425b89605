"""The SAM2 automatic mask source: seeded weights, the program's
``AutomaticMaskSource`` built on them, and the reference's judgement of
the masks the program produced."""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..reference.models.sam import amg as ref_amg
from ..reference.models.sam import model as ref_model
from ..reference.models.sam.decoder import init_mask_decoder
from ..reference.models.sam.hiera import init_hiera
from ..reference.models.sam.neck import init_neck
from ..reference.models.sam.prompt import init_prompt_encoder
from ..reference.ops.masks import masks_to_seg_map
from ..weights import SpecInit, tree_weights

CHUNK = 64          # candidate masks upsampled at a time when judging
# a program mask stands for a mask of the reference's own selection down
# to this IoU (mask NMS keeps no two masks above 0.8 of each other)
MATCH_IOU = 0.5
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def amg_kwargs(sam: Dict[str, Any], max_masks: int) -> Dict[str, Any]:
    """``AutomaticMaskSource``'s arguments from the config's ``sam``
    section, as the port's ``build_sam_mask_source`` reads them (SAM2)."""
    return dict(points_per_side=sam.get("points_per_side", 16),
                pred_iou_thresh=sam.get("pred_iou_th", 0.8),
                stability_thresh=sam.get("stability_score_th", 0.95),
                nms_iou_th=sam.get("nms_iou_th", 0.8),
                nms_score_th=sam.get("nms_score_th", 0.7),
                nms_inner_th=sam.get("nms_inner_th", 0.5),
                max_masks=max_masks,
                min_area=sam.get("min_mask_region_area", 0),
                min_area_mode=sam.get("min_area_mode", "connected"),
                gate_prompts=sam.get("gate_prompts", 128))


def _ref_cfg(sam, dtype="float32"):
    return ref_model.SAMConfig(encoder=sam["sam_encoder"],
                               image_size=sam.get("image_size", 1024),
                               compute_dtype=dtype)


def make_weights(sam: Dict[str, Any], gen: torch.Generator):
    """The SAM2 param tree (the reference's ``init_sam`` shapes and stds)
    on the generator's device, matmul weights in the compute dtype."""
    cfg = _ref_cfg(sam)
    init, h = SpecInit(), cfg.hiera
    channels = tuple(int(h.embed_dim * h.dim_mul ** i) for i in range(4))
    spec = {"trunk": init_hiera(init, h),
            "neck": init_neck(init, channels, cfg.d_model),
            "prompt": init_prompt_encoder(init, cfg.d_model),
            "decoder": init_mask_decoder(init, cfg.d_model)}
    return tree_weights(spec, gen, DTYPES[sam["compute_dtype"]])


def build_program(sam: Dict[str, Any], weights, max_masks: int,
                  device: torch.device):
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource
    from ovo_tpu_torch.models.sam.model import SAMConfig, SAMModel

    cfg = SAMConfig(encoder=sam["sam_encoder"],
                    image_size=sam.get("image_size", 1024),
                    compute_dtype=sam["compute_dtype"])
    return AutomaticMaskSource(SAMModel(cfg, weights, device),
                               **amg_kwargs(sam, max_masks))


class Reference:
    """The reference mask source over the same weights, in float32 (or,
    for the control, in the compute dtype under ``precision.lower``)."""

    def __init__(self, sam, weights, max_masks, device, dtype="float32"):
        self.model = ref_model.SAMModel(_ref_cfg(sam, dtype), weights, device)
        self.source = ref_amg.AutomaticMaskSource(
            self.model, **amg_kwargs(sam, max_masks))

    def encode(self, image: torch.Tensor):
        return self.model.encode_image(ref_amg._preprocess(self.model, image))

    def candidates(self, embed, high_res) -> torch.Tensor:
        """Every prompt's three multimask logits, ungated: (3P, h, w)."""
        out = self.model.decode_grid(embed, high_res, self.source.points,
                                     mask_channels=(1, 2, 3))
        m = out["masks"]
        return m.reshape(-1, m.shape[-2], m.shape[-1])

    def masks(self, image: torch.Tensor, embed=None, high_res=None):
        """The reference's own (seg, bmaps, valid) for one image."""
        if embed is None:
            embed, high_res = self.encode(image)
        seg, bmaps, valid, _ = ref_amg._amg_masks(
            self.model, embed, high_res, self.source.points,
            **self.source._amg_kwargs(tuple(image.shape[:2])))
        return seg, bmaps, valid


@torch.no_grad()
def nearest(masks: torch.Tensor, logits: torch.Tensor, out_hw,
            threshold: float = 0.0):
    """For each of ``masks`` (N, H, W) bool, the candidate of ``logits``
    (C, h, w), upsampled to the image and cut at ``threshold``, of largest
    IoU: (iou, pixels in one and not the other, candidate index) per mask.
    Counts are exact in float32 (TF32 off)."""
    flat = masks.reshape(masks.shape[0], -1).float()
    area = flat.sum(dim=1)
    best = torch.full((masks.shape[0],), -1.0, device=masks.device)
    xor = torch.zeros_like(best)
    idx = torch.zeros(masks.shape[0], dtype=torch.long, device=masks.device)
    for s in range(0, logits.shape[0], CHUNK):
        up = ref_amg.upsample_bilinear_matmul(logits[s:s + CHUNK], out_hw)
        cand = (up > threshold).reshape(up.shape[0], -1).float()
        inter = flat @ cand.T
        union = area[:, None] + cand.sum(dim=1)[None, :] - inter
        iou = torch.where(union > 0, inter / union.clamp_min(1.0),
                          torch.ones_like(inter))
        v, i = iou.max(dim=1)
        take = v > best
        pick = torch.gather(union - inter, 1, i[:, None])[:, 0]
        best = torch.where(take, v, best)
        xor = torch.where(take, pick, xor)
        idx = torch.where(take, i + s, idx)
    return best, xor, idx


@torch.no_grad()
def flipped_logits(masks: torch.Tensor, logits: torch.Tensor, idx, out_hw,
                   threshold: float = 0.0):
    """Where each mask and its nearest candidate disagree, the reference's
    |logit - threshold| over the candidate's mean |logit - threshold| on
    the image: how large a logit error the mask implies, in the
    candidate's own logit scale. Returns (sum over the differing pixels,
    their count, the largest), each summed or maxed over the masks."""
    total, count, worst = 0.0, 0, 0.0
    for j in range(masks.shape[0]):
        up = ref_amg.upsample_bilinear_matmul(logits[idx[j]][None],
                                              out_hw)[0] - threshold
        differ = masks[j] != (up > 0)
        if bool(differ.any()):
            v = up.abs()[differ] / up.abs().mean().clamp_min(1e-12)
            total += float(v.sum())
            count += int(v.numel())
            worst = max(worst, float(v.amax()))
    return total, count, worst


def boundary_px(masks: torch.Tensor) -> torch.Tensor:
    """(N,) pixels of each mask with a 4-neighbour outside it."""
    m = masks.float()[:, None]
    cross = torch.nn.functional.conv2d(
        m, torch.tensor([[[[0., 1., 0.], [1., 1., 1.], [0., 1., 0.]]]],
                        device=m.device), padding=1)
    return ((m > 0) & (cross < 5)).float().sum(dim=(1, 2, 3))


def match_reference(ref_masks: torch.Tensor, masks: torch.Tensor,
                    min_iou: float = MATCH_IOU) -> torch.Tensor:
    """Which of the reference's own selected masks (R, H, W) one of the
    program's ``masks`` (P, H, W) stands for: pairs taken greedily by
    largest IoU, each mask in at most one pair, down to ``min_iou``.
    Returns (R,) bool. Counts are exact in float32 (TF32 off)."""
    R, P = ref_masks.shape[0], masks.shape[0]
    matched = torch.zeros(R, dtype=torch.bool, device=ref_masks.device)
    if R == 0 or P == 0:
        return matched
    a = ref_masks.reshape(R, -1).float()
    b = masks.reshape(P, -1).float()
    inter = a @ b.T
    union = a.sum(dim=1)[:, None] + b.sum(dim=1)[None, :] - inter
    iou = torch.where(union > 0, inter / union.clamp_min(1.0),
                      torch.ones_like(inter)).cpu()
    for _ in range(min(R, P)):
        v, flat = iou.flatten().max(dim=0)
        if float(v) < min_iou:
            break
        r, p = divmod(int(flat), P)
        matched[r] = True
        iou[r, :] = -1.0
        iou[:, p] = -1.0
    return matched


def mask_gap(ref: Reference, image: torch.Tensor, bmaps: torch.Tensor,
             valid: torch.Tensor, memo=None) -> Dict[str, float]:
    """Judge one keyframe's masks against the reference for the same image
    and weights, both ways.

    Each valid mask of the program against the nearest (largest IoU) of
    the reference's 3P ungated candidates: ``logit_sum`` / ``logit_px`` /
    ``logit_max``, the logit error the masks imply at the pixels where
    they differ (:func:`flipped_logits`); ``xor_px`` / ``area_px``, those
    pixels and the masks' own; ``iou_gap``, the largest 1 - IoU;
    ``edge_px``, the largest differing pixels per pixel of a mask's edge.

    Each mask of the reference's own selection against the program's
    (:func:`match_reference`): ``missed``, of ``ref_masks``, those that
    none stands for, left out or swapped for another where scores nearly
    tie; ``short``, the masks the program's selection has fewer than the
    reference's (a swap leaves the count, a mask left out does not).
    ``memo``: a dict kept over calls for one image, so that the reference
    works out its candidates and selection for it once."""
    memo = {} if memo is None else memo
    with torch.no_grad():
        if not memo:
            embed, high_res = ref.encode(image)
            _, rb, rv = ref.masks(image, embed, high_res)
            memo.update(logits=ref.candidates(embed, high_res), rm=rb[rv])
        logits, rm = memo["logits"], memo["rm"]
        hw = tuple(image.shape[:2])
        mv = bmaps[valid]
        R, P = int(rm.shape[0]), int(mv.shape[0])
        g = {"logit_sum": 0.0, "logit_px": 0, "logit_max": 0.0,
             "xor_px": 0.0, "area_px": 0.0, "iou_gap": 0.0, "edge_px": 0.0,
             "valid_masks": P, "ref_masks": R,
             "missed": R - int(match_reference(rm, mv).sum()),
             "short": max(0, R - P)}
        if P:
            iou, xor, idx = nearest(mv, logits, hw)
            lsum, lpx, lmax = flipped_logits(mv, logits, idx, hw)
            edge = xor / boundary_px(mv).clamp_min(1.0)
            g.update(logit_sum=lsum, logit_px=lpx, logit_max=lmax,
                     iou_gap=float((1.0 - iou).amax()),
                     edge_px=float(edge.amax()), xor_px=float(xor.sum()),
                     area_px=float(mv.sum()))
        return g


def seg_mismatch(seg: torch.Tensor, bmaps: torch.Tensor,
                 valid: torch.Tensor) -> float:
    """Share of pixels where the program's seg map differs from the one
    its own masks give (slots in stability order, the earlier wins)."""
    M = bmaps.shape[0]
    order = -torch.arange(M, dtype=torch.float32, device=bmaps.device)
    want = masks_to_seg_map(bmaps, order, valid)
    return float((want != seg).float().mean())


def cost_part(cfg: Dict[str, Any], batch: int, image_hw):
    """The mask source's share of a keyframe for ``costs.keyframe_costs``:
    the trunk and neck over a micro-batch, then each image's gated grid
    decode, in the compute dtype on the meta device."""
    from ..costs import Part
    from ..weights import tree_map

    sam = cfg["program"]["semantic"]["sam"]
    dtype = DTYPES[sam["compute_dtype"]]
    H, W = image_hw

    def run():
        cfg_m = _ref_cfg(sam, sam["compute_dtype"])
        init, h = SpecInit(), cfg_m.hiera
        channels = tuple(int(h.embed_dim * h.dim_mul ** i) for i in range(4))
        spec = {"trunk": init_hiera(init, h),
                "neck": init_neck(init, channels, cfg_m.d_model),
                "prompt": init_prompt_encoder(init, cfg_m.d_model),
                "decoder": init_mask_decoder(init, cfg_m.d_model)}
        params = tree_map(lambda s: torch.empty(s.shape, device="meta"), spec)
        model = ref_model.SAMModel(cfg_m, params, "meta")
        imgs = torch.empty((batch, H, W, 3), device="meta")
        embeds, high_res = model.encode_images(
            torch.cat([ref_amg._preprocess(model, im) for im in imgs]))
        points = torch.empty((sam.get("points_per_side", 16) ** 2, 2),
                             device="meta")
        for b in range(batch):
            model.decode_grid(embeds[b], [t[b] for t in high_res], points,
                              mask_channels=(1, 2, 3),
                              top_prompts=sam.get("gate_prompts", 128))

    return Part("mask_source", dtype, run, per=batch)
