"""``correct``: the plain reference judges what the timed window produced.

For each keyframe drawn from the seed (``traffic["samples"]`` of them) and
one map frame, the numbers compared, each against its cell's limit
(``portbench/limits/<cell>.json``; a cell compares the numbers its file
gives a limit, the ones that separate its sound runs from the control):

- ``mask_logit_gap``: over every valid mask the program's mask source
  returned for the sampled keyframes, matched to the nearest (largest IoU)
  of the reference's 3 x 256 candidate masks for the same image and
  weights, the mean |reference logit| over the pixels where the two
  differ, each over its candidate's mean |logit|: the logit error the
  program's masks imply, in the logits' own scale (a mask's pixel count
  moves with its size, this does not);
- ``mask_logit_max``: the same, the largest over those pixels instead of
  their mean;
- ``mask_shortfall``: the other way round, against the reference's own
  selection for each judged keyframe (gates, top-C, NMS): the masks the
  program's selection has fewer than the reference's, summed, over the
  reference's. Near-tied scores swap a mask for another now and then (a
  swap leaves the count); a selection that leaves masks out does not;
- ``mask_missed`` (printed beside, for the record): the share of the
  reference's selected masks that no mask of the program stands for, one
  to one down to IoU 0.5: those left out and those swapped;
- ``seg_mismatch``: the share of pixels where the program's seg map differs
  from the one its own masks give;
- ``desc_cos_gap``: the largest 1 - cos between a kept descriptor of the
  program and the reference embedder's for the same image, on the fused
  masks and keep flags of the reference's association;
- ``assoc_mismatch``: the share of entries where the program's association
  (its fused masks too, and, on the fused path, its map insert) differs
  from the reference's: for the run's first associated keyframe, from the
  reference's own empty map and store, with the frames the program mapped
  before it inserted by the reference; for the sampled window keyframes,
  from the program's map and store just before each;
- ``insert_mismatch``: the share of map rows where the program's map insert
  of the sampled map frame differs from the reference's.

With ``control`` the same numbers are read for the reference put in the
program's place one precision step below the configuration's (float8 for
the bf16 models, TF32 for float32 work: ``reference/precision.py``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from . import check
from .parts import sam2_amg, towers
from .reference import precision
from .spec import merged


def context(cfg, traffic, dataset, device) -> Dict[str, Any]:
    pcfg = merged(cfg["program"], traffic["program"])
    semantic = pcfg["semantic"]
    clip, caps = semantic.get("clip", {}), semantic.get("capacity", {})
    n_top = int(clip.get("k_top_views", 0))
    return dict(device=device, semantic=semantic, mapping=pcfg["mapping"],
                dataset=dataset, clip_dim=int(cfg["tower"]["clip_dim"]),
                K=torch.from_numpy(np.asarray(dataset.intrinsics,
                                              np.float32)).to(device),
                unbounded_top_k=(n_top <= 0 or
                                 n_top > int(caps.get("top_k_slots", 16))))


class _Masks:
    """The mask comparison over keyframes: the mean logit gap over the
    differing pixels, and beside it the largest, the differing share of
    mask pixels, the largest 1 - IoU and edge displacement."""

    def __init__(self):
        self.xor = self.area = self.logit_sum = 0.0
        self.logit_px = self.missed = self.short = self.ref_masks = 0
        self.logit_max = self.iou_gap = self.edge_px = 0.0

    def add(self, g):
        self.xor += g["xor_px"]
        self.area += g["area_px"]
        self.logit_sum += g["logit_sum"]
        self.logit_px += g["logit_px"]
        self.logit_max = max(self.logit_max, g["logit_max"])
        self.iou_gap = max(self.iou_gap, g["iou_gap"])
        self.edge_px = max(self.edge_px, g["edge_px"])
        self.missed += g["missed"]
        self.short += g["short"]
        self.ref_masks += g["ref_masks"]

    @property
    def logit_gap(self) -> float:
        return self.logit_sum / self.logit_px if self.logit_px else 0.0

    def numbers(self) -> Dict[str, float]:
        """The numbers a cell may compare, by name."""
        return {"mask_logit_gap": self.logit_gap,
                "mask_logit_max": self.logit_max,
                "mask_shortfall": self.short / max(self.ref_masks, 1),
                "mask_missed": self.missed / max(self.ref_masks, 1)}

    def facts(self, prefix=""):
        return {prefix + "mask_logit_max": self.logit_max,
                prefix + "mask_pixel_gap": self.xor / max(self.area, 1.0),
                prefix + "mask_iou_gap": self.iou_gap,
                prefix + "mask_edge_px": self.edge_px}


def judge(cfg, traffic, weights, dataset, captured, descs, device,
          control: bool = False) -> Tuple[Dict[str, float], Dict[str, float]]:
    """(numbers, control numbers) over the sampled stages."""
    ctx = context(cfg, traffic, dataset, device)
    sam = ctx["semantic"]["sam"]
    n_masks = int(ctx["semantic"]["capacity"]["n_masks"])
    tower_dtype = cfg["tower"]["vision"]["dtype"]
    nums = {**_Masks().numbers(), "seg_mismatch": 0.0, "desc_cos_gap": 0.0,
            "assoc_mismatch": 0.0, "insert_mismatch": 0.0}
    ctrl = dict.fromkeys(nums, 0.0) if control else {}
    pix, ctrl_pix = _Masks(), _Masks()

    def worst(d, k, v):
        d[k] = max(d[k], float(v))

    with precision.exact():
        ref_sam = sam2_amg.Reference(sam, weights["sam"], n_masks, device)
        ref_emb = towers.build_reference(cfg, weights, device)
    for fid, c in captured.items():
        c = check.resident(c, device)
        if c is None or not {"bmaps", "map_in", "state_in"} & set(c):
            # a sampled stage the program never reached
            for k in nums:
                nums[k] = 1.0
            continue
        if "state_in" in c:
            out = check.ref_insert(c, ctx)
            worst(nums, "insert_mismatch",
                  check.insert_mismatch(out, c["state_out"]))
            if control:
                low = check.ref_insert(c, ctx, lower=True)
                worst(ctrl, "insert_mismatch", check.insert_mismatch(low, out))
            continue
        image = torch.from_numpy(dataset.segment_image(fid)).to(device)
        if "bmaps" in c:
            memo = {}
            with precision.exact():
                pix.add(sam2_amg.mask_gap(ref_sam, image, c["bmaps"],
                                          c["valid"], memo))
            worst(nums, "seg_mismatch",
                  sam2_amg.seg_mismatch(c["seg"], c["bmaps"], c["valid"]))
            if control:
                with torch.no_grad(), precision.lower(sam["compute_dtype"]):
                    _, cb, cv = ref_sam.masks(image)
                with precision.exact():
                    ctrl_pix.add(sam2_amg.mask_gap(ref_sam, image, cb, cv,
                                                   memo))
        if "map_in" not in c:
            for k in ("assoc_mismatch", "desc_cos_gap"):
                nums[k] = 1.0
            continue
        start = check.ref_start(c, ctx) if c.get("start") else None
        ref_out = check.ref_association(fid, c, ctx, start=start)
        worst(nums, "assoc_mismatch", check.assoc_mismatch(ref_out, c))
        rec = descs.get(fid)
        with torch.no_grad(), precision.exact():
            ref_d = ref_emb.embed_masks(image, ref_out["fused_maps"],
                                        ref_out["keep"])
        if rec is None:
            nums["desc_cos_gap"] = 1.0
        else:
            worst(nums, "desc_cos_gap",
                  towers.descriptor_gap(rec[1], ref_d, rec[2]))
        if control:
            low = check.ref_association(fid, c, ctx, lower=True, start=start)
            worst(ctrl, "assoc_mismatch", check.assoc_mismatch(low, ref_out))
            with torch.no_grad(), precision.lower(tower_dtype):
                low_d = ref_emb.embed_masks(image, ref_out["fused_maps"],
                                            ref_out["keep"])
            worst(ctrl, "desc_cos_gap",
                  towers.descriptor_gap(low_d, ref_d, ref_out["keep"]))
    for k, v in pix.numbers().items():
        nums[k] = max(nums[k], v)
    if control:
        ctrl.update(ctrl_pix.numbers())
        ctrl["diagnostics"] = {**pix.facts(), **ctrl_pix.facts("control_")}
        del ctrl["diagnostics"]["mask_logit_max"]
        del ctrl["diagnostics"]["control_mask_logit_max"]
    return nums, ctrl
