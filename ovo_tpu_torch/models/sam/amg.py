"""Automatic mask generation: grid-prompted segmentation of a keyframe on
the device (port of ``ovo_tpu/models/sam/amg.py``), for both SAM families.

  encode -> decode all P grid points in one batch -> multimask candidates
  (3P) -> iou / stability gates -> top-C by predicted IoU -> greedy box NMS
  -> OVO's mask NMS -> top-M by stability -> bilinear upsample to the image
  -> stability-ordered seg map.

SAM1 segments the padded square: its grid points are scaled into the
image's top-left box, its scores read logits with the pad suppressed, and
its upsample reads the raw logits through the composed interpolate -> crop
-> interpolate matrices.

Every stage is fixed-shape tensor code: no host synchronization between the
image upload and the returned (seg, binary maps, valid) tensors. The
greedy box NMS walks its candidates as device-side steps. The small-region
host pass (numpy + scipy) runs only when ``min_area`` asks for it, as
SAM1's defaults do (``min_mask_region_area`` 100) and SAM2's do not.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ... import resolve_device, to_device
from ...ops.masks import mask_nms, masks_to_seg_map
from ...utils import trace
from .model import SAMModel


def _bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """(src, dst) bilinear interpolation matrix, half-pixel centers, edges
    clamped: upsampling as two matmuls."""
    scale = src / dst
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    w_hi = (pos - lo).astype(np.float32)
    lo_c = np.clip(lo, 0, src - 1)
    hi_c = np.clip(lo + 1, 0, src - 1)
    m = np.zeros((src, dst), np.float32)
    m[lo_c, np.arange(dst)] += 1.0 - w_hi
    m[hi_c, np.arange(dst)] += w_hi
    return m


# device copies: an upload per call would be a pageable copy on the path
_device_mats: Dict[tuple, torch.Tensor] = {}


def _on_device(make, args: tuple, device: torch.device) -> torch.Tensor:
    """``make(*args)``'s matrix on ``device``, made and uploaded once."""
    key = (make.__name__, *args, str(device))
    m = _device_mats.get(key)
    if m is None:
        m = _device_mats[key] = to_device(make(*args), device)
    return m


def upsample_bilinear_matmul(x: torch.Tensor, out_hw: Tuple[int, int],
                             mats: Optional[Tuple[torch.Tensor,
                                                  torch.Tensor]] = None
                             ) -> torch.Tensor:
    """(M, h, w) -> (M, H, W) bilinear via separable f32 matmuls (TF32 off:
    mask boundaries sit where the interpolated logits cross 0). ``mats``:
    the per-axis (h, H), (w, W) matrices instead (SAM1's crop-composed
    ones)."""
    h, w = x.shape[-2:]
    if mats is None:
        mats = (_on_device(_bilinear_matrix, (h, out_hw[0]), x.device),
                _on_device(_bilinear_matrix, (w, out_hw[1]), x.device))
    mh, mw = mats
    y = torch.matmul(x.float().transpose(-1, -2), mh).transpose(-1, -2)
    return torch.matmul(y, mw)


def _sam1_upsample_matrix(src: int, full: int, crop: int, dst: int
                          ) -> np.ndarray:
    """(src, dst) matrix of SAM1's mask upsampling along one axis: logits
    (src) -> the model's input size (full), cropped to the image's extent
    (crop), -> the image's size (dst); the official postprocess_masks
    chain as one matmul."""
    m1 = _bilinear_matrix(src, full)[:, :crop]         # (src, crop)
    m2 = _bilinear_matrix(crop, dst)                   # (crop, dst)
    return m1 @ m2


def grid_points(points_per_side: int) -> np.ndarray:
    """Normalized [0, 1] grid point prompts (SAM AMG build_point_grid)."""
    offset = 1.0 / (2 * points_per_side)
    coords = np.linspace(offset, 1.0 - offset, points_per_side)
    gx, gy = np.meshgrid(coords, coords, indexing="xy")
    return np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)


def min_area_cells(min_area: float, valid_cells: int,
                   out_hw: Tuple[int, int]) -> float:
    """min_mask_region_area (original-resolution pixels) -> logit-resolution
    cells for the whole-mask ``area >`` gate."""
    if not min_area:
        return 0.0
    return min_area * valid_cells / float(out_hw[0] * out_hw[1])


def remove_small_regions(mask: np.ndarray, area_thresh: float, mode: str
                         ) -> Tuple[np.ndarray, bool]:
    """Connected-component small-region removal ("islands") or hole filling
    ("holes") on one bool mask, 8-connectivity (segment_anything's
    ``remove_small_regions``; scipy.ndimage labels as cv2 would). A whole
    mask is never dropped. Returns (mask, changed)."""
    from scipy import ndimage

    if mode not in ("holes", "islands"):
        raise ValueError(mode)
    correct_holes = mode == "holes"
    working = np.logical_xor(correct_holes, mask)
    regions, n_labels = ndimage.label(working, structure=np.ones((3, 3), bool))
    if n_labels == 0:
        return mask, False
    sizes = np.bincount(regions.ravel(), minlength=n_labels + 1)[1:]
    small = np.nonzero(sizes < area_thresh)[0] + 1
    if small.size == 0:
        return mask, False
    if correct_holes:
        fill = np.concatenate([[0], small])
    else:
        fill = np.setdiff1d(np.arange(1, n_labels + 1), small)
        if fill.size == 0:  # keep the largest region
            fill = np.asarray([int(np.argmax(sizes)) + 1])
    return np.isin(regions, fill), True


def _np_greedy_box_nms(boxes: np.ndarray, scores: np.ndarray,
                       iou_thresh: float) -> np.ndarray:
    """Host-side torchvision-semantics greedy NMS (stable score order)."""
    n = boxes.shape[0]
    order = np.argsort(-scores, kind="stable")
    keep = np.ones(n, bool)
    area = (np.maximum(boxes[:, 2] - boxes[:, 0], 0)
            * np.maximum(boxes[:, 3] - boxes[:, 1], 0))
    for oi in range(n):
        i = order[oi]
        if not keep[i]:
            continue
        for oj in range(oi + 1, n):
            j = order[oj]
            if not keep[j]:
                continue
            x0 = max(boxes[i, 0], boxes[j, 0])
            y0 = max(boxes[i, 1], boxes[j, 1])
            x1 = min(boxes[i, 2], boxes[j, 2])
            y1 = min(boxes[i, 3], boxes[j, 3])
            inter = max(x1 - x0, 0) * max(y1 - y0, 0)
            union = area[i] + area[j] - inter
            if union > 0 and inter / union > iou_thresh:
                keep[j] = False
    return keep


def postprocess_small_regions_host(bmaps: np.ndarray, valid: np.ndarray,
                                   min_area: float, nms_thresh: float
                                   ) -> Tuple[np.ndarray, np.ndarray, bool]:
    """The official ``postprocess_small_regions``: per mask, fill small holes
    then drop small islands at output resolution, then de-duplicate with a
    box NMS preferring unchanged masks. Host-side, as the reference runs it.
    Returns (fixed bmaps, new valid, any_changed)."""
    bmaps = np.array(bmaps, dtype=bool, copy=True)
    valid = np.array(valid, dtype=bool, copy=True)
    idx = np.nonzero(valid)[0]
    if idx.size == 0:
        return bmaps, valid, False
    scores = np.ones(idx.size, np.float32)
    any_changed = False
    for k, i in enumerate(idx):
        m, ch_h = remove_small_regions(bmaps[i], min_area, "holes")
        m, ch_i = remove_small_regions(m, min_area, "islands")
        if ch_h or ch_i:
            bmaps[i] = m
            scores[k] = 0.0   # prefer unchanged duplicates in the NMS
            any_changed = True
    if not any_changed:
        return bmaps, valid, False
    boxes = np.zeros((idx.size, 4), np.float32)
    for k, i in enumerate(idx):
        rows = np.any(bmaps[i], axis=1)
        cols = np.any(bmaps[i], axis=0)
        if rows.any():
            y = np.nonzero(rows)[0]
            x = np.nonzero(cols)[0]
            boxes[k] = [x[0], y[0], x[-1], y[-1]]
    keep = _np_greedy_box_nms(boxes, scores, nms_thresh)
    valid[idx[~keep]] = False
    bmaps &= valid[:, None, None]
    return bmaps, valid, True


def stability_score(logits: torch.Tensor, mask_threshold: float,
                    offset: float) -> torch.Tensor:
    """IoU between the masks thresholded at +- offset (SAM amg)."""
    hi = (logits > mask_threshold + offset).float().sum(dim=(-2, -1))
    lo = (logits > mask_threshold - offset).float().sum(dim=(-2, -1))
    return hi / lo.clamp_min(1.0)


def mask_boxes(masks: torch.Tensor) -> torch.Tensor:
    """(N, H, W) bool -> (N, 4) int32 xyxy boxes ([0, 0, 0, 0] if empty)."""
    N, H, W = masks.shape
    rows = masks.any(dim=2)
    cols = masks.any(dim=1)
    ridx = torch.arange(H, dtype=torch.int32, device=masks.device)
    cidx = torch.arange(W, dtype=torch.int32, device=masks.device)

    def lo(ok, idx, n):
        return torch.where(ok, idx, torch.full_like(idx, n)).amin(dim=1)

    def hi(ok, idx):
        return torch.where(ok, idx, torch.full_like(idx, -1)).amax(dim=1)

    box = torch.stack([lo(cols, cidx, W), lo(rows, ridx, H), hi(cols, cidx),
                       hi(rows, ridx)], dim=1)
    return torch.where(rows.any(dim=1)[:, None], box, torch.zeros_like(box))


def greedy_box_nms(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor, iou_thresh: float) -> torch.Tensor:
    """torchvision-style greedy NMS. Candidate i, in score order, suppresses
    every later candidate j with IoU > iou_thresh if it is itself kept: N
    device-side steps (two launches each, no host read)."""
    N = boxes.shape[0]
    s = torch.where(valid, scores, torch.full_like(scores, float("-inf")))
    order = torch.argsort(-s, stable=True)
    b = boxes[order].float()
    area = ((b[:, 2] - b[:, 0]).clamp_min(0)
            * (b[:, 3] - b[:, 1]).clamp_min(0))
    x0 = torch.maximum(b[:, None, 0], b[None, :, 0])
    y0 = torch.maximum(b[:, None, 1], b[None, :, 1])
    x1 = torch.minimum(b[:, None, 2], b[None, :, 2])
    y1 = torch.minimum(b[:, None, 3], b[None, :, 3])
    inter = (x1 - x0).clamp_min(0) * (y1 - y0).clamp_min(0)
    iou = inter / (area[:, None] + area[None, :] - inter).clamp_min(1e-9)
    idx = torch.arange(N, device=boxes.device)
    later = idx[None, :] > idx[:, None]
    # row i: 1 - [i suppresses j]; step i multiplies keep by it if i is kept
    spare = 1.0 - ((iou > iou_thresh) & later).float()
    keep = valid[order].float()
    ones = torch.ones(N, device=boxes.device)
    for i in range(N):
        keep.mul_(torch.lerp(ones, spare[i], keep[i]))
    out = torch.empty(N, dtype=torch.bool, device=boxes.device)
    out[order] = keep > 0
    return out


def _amg_program(model: SAMModel, image: torch.Tensor, points: torch.Tensor,
                 **kw):
    """One keyframe's masks: (seg (H, W) i32, bmaps (M, H, W) bool,
    valid (M,), stability (M,) with -inf at invalid slots)."""
    with trace.span("mask_source.encode"):
        encoded = model.encode_image(_preprocess(model, image))
    return _amg_masks(model, *encoded, points, **kw)


def _amg_program_batch(model: SAMModel, images: torch.Tensor,
                       points: torch.Tensor, frame_ids=None, **kw):
    """A micro-batch of keyframes (B, H, W, 3): the trunk and the neck run
    once over the B images, then each image's masks as
    :func:`_amg_program`'s; the four outputs stacked on a leading B.
    ``frame_ids``: the keyframes', for the program's spans."""
    B = images.shape[0]
    with trace.span("mask_source.encode", n_kf=B):
        embeds, high_res = model.encode_images(torch.cat(
            [_preprocess(model, img) for img in images]))
    outs = [_amg_masks(model, embeds[b],
                       None if high_res is None else [h[b] for h in high_res],
                       points, frame_id=None if frame_ids is None
                       else frame_ids[b], **kw) for b in range(B)]
    with trace.span("mask_source.stack", n_kf=B):
        return tuple(torch.stack(o) for o in zip(*outs))


def _preprocess(model: SAMModel, image: torch.Tensor) -> torch.Tensor:
    if image.dtype == torch.uint8:
        image = image.float() / 255.0
    return model.preprocess(image)


def _amg_masks(model: SAMModel, image_embed: torch.Tensor, high_res,
               points: torch.Tensor, *, pred_iou_thresh, stability_thresh,
               stability_offset, mask_threshold, box_nms_thresh, nms_iou_th,
               nms_score_th, nms_inner_th, max_masks, candidates, min_area,
               gate_prompts=None, out_hw: Tuple[int, int], frame_id=None):
    """The masks of one encoded image (the decoder onwards); ``out_hw`` is
    the original image's size. ``frame_id``: the keyframe's, for the
    program's spans (the enclosing span's when None)."""
    sam1 = model.cfg.family == "sam1"
    with trace.span("mask_source.decode", frame_id):
        if sam1:
            # the grid lives in the image's [0, 1] box, the top-left
            # (nh, nw) of the padded square
            sx, sy = model.point_scale(*out_hw)
            points = torch.stack([points[:, 0] * sx, points[:, 1] * sy],
                                 dim=1)
        # multimask outputs only (channels 1:4); the gate keeps the top
        # prompts by predicted IoU for the upscale tail
        out = model.decode_grid(image_embed, high_res, points,
                                mask_channels=(1, 2, 3),
                                top_prompts=gate_prompts)
        logits = out["masks"]                            # (P, 3, Hm, Wm)
        P, C, Hm, Wm = logits.shape
        logits = logits.reshape(P * C, Hm, Wm)
        iou = out["iou"].reshape(P * C)
        logits_raw = logits      # the upsample reads the unsuppressed ones
    with trace.span("mask_source.select", frame_id):
        if sam1:
            # the pad is suppressed for scoring only (the official AMG crops
            # before it scores); the upsample's composed matrices exclude
            # the pad and interpolate the real logits at the crop's edge
            nh, nw = model.resized_hw(*out_hw)
            s = model.cfg.image_size
            vh, vw = -(-nh * Hm // s), -(-nw * Wm // s)  # ceil at logit res
            dev = logits.device
            ok = ((torch.arange(Hm, device=dev) < vh)[:, None]
                  & (torch.arange(Wm, device=dev) < vw)[None, :])
            logits = logits.masked_fill(~ok, mask_threshold - 1e4)
            area_gate = min_area_cells(min_area, vh * vw, out_hw)
        else:
            area_gate = min_area_cells(min_area, Hm * Wm, out_hw)

        stab = stability_score(logits, mask_threshold, stability_offset)
        masks = logits > mask_threshold
        area = masks.sum(dim=(1, 2))
        keep = ((iou > pred_iou_thresh) & (stab >= stability_thresh)
                & (area > area_gate))

        # top-C candidates by predicted IoU (a fixed axis for the NMS
        # stages)
        neg = torch.full_like(iou, float("-inf"))
        sel = torch.argsort(-torch.where(keep, iou, neg),
                            stable=True)[:candidates]
        masks_c = masks[sel]
        iou_c = iou[sel]
        stab_c = stab[sel]
        valid_c = keep[sel]
    with trace.span("mask_source.box_nms", frame_id):
        valid_c = valid_c & greedy_box_nms(mask_boxes(masks_c), iou_c,
                                           valid_c, box_nms_thresh)
    with trace.span("mask_source.mask_nms", frame_id):
        # OVO's mask NMS with scores = stability * iou
        valid_c = valid_c & mask_nms(masks_c, stab_c * iou_c, valid_c,
                                     iou_thr=nms_iou_th,
                                     score_thr=nms_score_th,
                                     inner_thr=nms_inner_th)
    with trace.span("mask_source.upsample", frame_id):
        # final top-M by stability (mask2segmap's order)
        neg = torch.full_like(stab_c, float("-inf"))
        m_sel = torch.argsort(-torch.where(valid_c, stab_c, neg),
                              stable=True)[:max_masks]
        final_valid = valid_c[m_sel]
        final_stab = torch.where(final_valid, stab_c[m_sel], neg[m_sel])
        mats = (tuple(_on_device(_sam1_upsample_matrix,
                                 (n, model.cfg.image_size, crop, dst),
                                 logits.device)
                      for n, crop, dst in ((Hm, nh, out_hw[0]),
                                           (Wm, nw, out_hw[1])))
                if sam1 else None)
        lg_up = upsample_bilinear_matmul(logits_raw[sel][m_sel], out_hw,
                                         mats)
        bmaps = (lg_up > mask_threshold) & final_valid[:, None, None]
    with trace.span("mask_source.seg_map", frame_id):
        seg = masks_to_seg_map(bmaps, final_stab, final_valid)
    return seg, bmaps, final_valid, final_stab


class AutomaticMaskSource:
    """Mask source (``get_masks``) backed by a SAM model on its device."""

    def __init__(self, model: SAMModel, points_per_side: int = 16,
                 pred_iou_thresh: float = 0.8,
                 stability_thresh: float = 0.95,
                 stability_offset: float = 1.0, mask_threshold: float = 0.0,
                 box_nms_thresh: float = 0.7, nms_iou_th: float = 0.8,
                 nms_score_th: float = 0.7, nms_inner_th: float = 0.5,
                 max_masks: int = 96, candidates: int = 256,
                 min_area: int = 0, gate_prompts: int = 128,
                 min_area_mode: str = "connected"):
        if min_area_mode not in ("connected", "fast"):
            raise ValueError(f"min_area_mode {min_area_mode!r}")
        self.model = model
        self.device = model.device
        self.points = to_device(grid_points(points_per_side), self.device)
        self.pred_iou_thresh = pred_iou_thresh
        self.stability_thresh = stability_thresh
        self.stability_offset = stability_offset
        self.mask_threshold = mask_threshold
        self.box_nms_thresh = box_nms_thresh
        self.nms_iou_th = nms_iou_th
        self.nms_score_th = nms_score_th
        self.nms_inner_th = nms_inner_th
        self.max_masks = max_masks
        self.candidates = candidates
        self.min_area = min_area
        # "connected": the official small-region pass on the host, after the
        # program; "fast": the in-program whole-mask area gate
        self.min_area_mode = min_area_mode
        self.gate_prompts = gate_prompts or None

    def _amg_kwargs(self, out_hw):
        return dict(
            pred_iou_thresh=self.pred_iou_thresh,
            stability_thresh=self.stability_thresh,
            stability_offset=self.stability_offset,
            mask_threshold=self.mask_threshold,
            box_nms_thresh=self.box_nms_thresh,
            nms_iou_th=self.nms_iou_th, nms_score_th=self.nms_score_th,
            nms_inner_th=self.nms_inner_th, max_masks=self.max_masks,
            candidates=self.candidates,
            min_area=(0 if self.min_area_mode == "connected"
                      else self.min_area),
            gate_prompts=self.gate_prompts, out_hw=out_hw)

    def _small_regions(self, seg, bmaps, valid, stab):
        """The official small-region pass (host), then the seg map again
        from the fixed masks. No-op unless masks changed."""
        with trace.span("mask_source.small_regions"):
            with trace.wait("small_regions"):
                host = bmaps.cpu().numpy(), valid.cpu().numpy()
            bm, va, changed = postprocess_small_regions_host(
                *host, self.min_area, self.box_nms_thresh)
            if not changed:
                return seg, bmaps, valid
            bmaps = to_device(bm, self.device)
            valid = to_device(va, self.device)
            return masks_to_seg_map(bmaps, stab, valid), bmaps, valid

    @torch.no_grad()
    def get_masks(self, image, frame_id: Optional[int] = None):
        """image (H, W, 3) u8 (numpy or tensor) -> (seg (H, W) i32, binary
        maps (M, H, W) bool, valid (M,) bool) on the model's device."""
        with trace.span("mask_source.upload", frame_id):
            img = to_device(image, self.device)
        h, w = img.shape[:2]
        seg, bmaps, valid, stab = _amg_program(
            self.model, img, self.points, **self._amg_kwargs((h, w)))
        if self.min_area and self.min_area_mode == "connected":
            seg, bmaps, valid = self._small_regions(seg, bmaps, valid, stab)
        return seg, bmaps, valid

    @torch.no_grad()
    def get_masks_batch(self, images, frame_ids=None):
        """A micro-batch of keyframes in one trunk pass (masks are
        map-independent, so batching keeps per-keyframe semantics): images
        (B, H, W, 3) u8 -> (seg (B, H, W), binary maps (B, M, H, W), valid
        (B, M)) on the model's device."""
        with trace.span("mask_source.upload", n_kf=len(images)):
            imgs = to_device(images, self.device)
        h, w = imgs.shape[1:3]
        seg, bmaps, valid, stab = _amg_program_batch(
            self.model, imgs, self.points, frame_ids=frame_ids,
            **self._amg_kwargs((h, w)))
        if self.min_area and self.min_area_mode == "connected":
            outs = [self._small_regions(seg[b], bmaps[b], valid[b], stab[b])
                    for b in range(seg.shape[0])]
            seg, bmaps, valid = (torch.stack(o) for o in zip(*outs))
        return seg, bmaps, valid


def build_sam_mask_source(sam_cfg: Dict[str, Any], max_masks: int = 96,
                          device="cuda") -> AutomaticMaskSource:
    """Factory from the reference's sam config section: the checkpoint of
    the encoder's card under ``sam_ckpt_path`` when it exists
    (``convert_sam.load_sam_checkpoint``), else seeded random weights with
    a warning. ``sam_version: ""`` or a ``vit_*`` encoder is SAM1, with its
    defaults (stability 0.85, ``min_mask_region_area`` 100); SAM2's are
    0.95 and 0."""
    import os

    encoder = sam_cfg.get("sam_encoder", "hiera_l")
    version = sam_cfg.get("sam_version", "2.1")
    sam1 = version == "" or encoder.startswith("vit")
    # the reference's model cards: sam_vit_h_4b8939.pth etc. (SAM1, empty
    # sam_version), sam2.1_hiera_large.pt etc.
    cards = ({"vit_b": "vit_b_01ec64.pth", "vit_l": "vit_l_0b3195.pth",
              "vit_h": "vit_h_4b8939.pth", "vit_test": "vit_test.pth"}
             if sam1 else
             {"hiera_l": "hiera_large.pt", "hiera_t": "hiera_tiny.pt",
              "hiera_s": "hiera_small.pt", "hiera_b+": "hiera_base_plus.pt",
              "hiera_test": "hiera_test.pt"})
    ckpt_dir = sam_cfg.get("sam_ckpt_path", "")
    ckpt = os.path.join(ckpt_dir, f"sam{version}_"
                        + cards.get(encoder, f"{encoder}.pt"))
    dev = resolve_device(device)
    if os.path.exists(ckpt):
        from ..convert_sam import load_sam_checkpoint

        model = load_sam_checkpoint(encoder, ckpt, device=dev)
    else:
        if ckpt_dir:
            print(f"[ovo_tpu_torch] WARNING: SAM checkpoint {ckpt} not "
                  f"found; using random weights for {encoder}")
        model = SAMModel.random_init(
            encoder, image_size=sam_cfg.get("image_size", 1024), device=dev)
    return AutomaticMaskSource(
        model,
        points_per_side=sam_cfg.get("points_per_side", 16),
        pred_iou_thresh=sam_cfg.get("pred_iou_th", 0.8),
        stability_thresh=sam_cfg.get("stability_score_th",
                                     0.85 if sam1 else 0.95),
        nms_iou_th=sam_cfg.get("nms_iou_th", 0.8),
        nms_score_th=sam_cfg.get("nms_score_th", 0.7),
        nms_inner_th=sam_cfg.get("nms_inner_th", 0.5),
        max_masks=max_masks,
        min_area=sam_cfg.get("min_mask_region_area", 100 if sam1 else 0),
        min_area_mode=sam_cfg.get("min_area_mode", "connected"),
        gate_prompts=sam_cfg.get("gate_prompts", 128))
