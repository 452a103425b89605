"""Readings for a cell's mask limits, many seeds in one process.

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--seconds 51] [--budget-s 300]

For each seed it makes the cell's weights and frames as a run does, has
the program's mask source segment the keyframes a run with that seed
judges (its first keyframe and the window's sampled ones), each inside the
micro-batch the pipeline would give it, and judges them as ``judge`` does.
It prints one JSON line a seed with the mask numbers of the program, of a
fault planted in its output that leaves out every valid mask of a keyframe
but the first (its seg map redrawn from what is left), and, for the
control seeds, of the control (the reference one precision step below in
the program's place). The mapping and descriptor numbers need the whole
pipeline: ``run --control 1`` reads those. Stops starting seeds once
``--budget-s`` has passed.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time

import numpy as np
import torch

from . import judge, run, scene
from .parts import sam2_amg
from .reference import precision
from .reference.ops.masks import masks_to_seg_map
from .spec import load_cell, merged


def first_mask_only(bmaps: torch.Tensor, valid: torch.Tensor):
    """The planted fault: only a keyframe's first valid mask kept, and the
    seg map its masks give."""
    v = valid & (valid.int().cumsum(0) == 1)
    order = -torch.arange(bmaps.shape[0], dtype=torch.float32,
                          device=bmaps.device)
    return masks_to_seg_map(bmaps, order, v), v


def judged_keyframes(traffic, seed: int, seconds: float, seg_every: int,
                     batch: int):
    """The keyframes a run with ``seed`` judges (``run.run_cell``'s draw)."""
    warm = int(traffic["warmup_keyframes"]) * seg_every
    n_kf = run.window_keyframes(seconds, float(traffic["pace_kf_per_s"]),
                                batch)
    kfs = list(range(warm, warm + n_kf * seg_every, seg_every))
    rng = random.Random(seed)
    return [0] + sorted(rng.sample(kfs, min(int(traffic["samples"]),
                                            len(kfs))))


def read_seed(cfg, traffic, seed: int, seconds: float, control: bool,
              device) -> dict:
    pcfg = merged(cfg["program"], traffic["program"])
    semantic = pcfg["semantic"]
    sam = semantic["sam"]
    n_masks = int(semantic["capacity"]["n_masks"])
    batch = int(sam.get("batch", 1))
    seg_every = int(semantic.get("segment_every", 10))
    t0 = time.perf_counter()
    dataset = scene.ReplayDataset(traffic, seed, device)
    gen = torch.Generator(device=device).manual_seed(seed)
    weights = sam2_amg.make_weights(sam, gen)
    source = sam2_amg.build_program(sam, weights, n_masks, device)
    with precision.exact():
        ref = sam2_amg.Reference(sam, weights, n_masks, device)
    prog, fault, ctrl = judge._Masks(), judge._Masks(), judge._Masks()
    counts = []
    for fid in judged_keyframes(traffic, seed, seconds, seg_every, batch):
        k = fid // seg_every
        group = [f * seg_every for f in range(k - k % batch, k - k % batch
                                              + batch)]
        with torch.no_grad():
            if batch > 1:
                seg_b, bm_b, va_b = source.get_masks_batch(
                    np.stack([dataset.segment_image(f) for f in group]),
                    group)
                j = group.index(fid)
                seg, bmaps, valid = seg_b[j], bm_b[j], va_b[j]
            else:
                seg, bmaps, valid = source.get_masks(
                    dataset.segment_image(fid), fid)
        image = torch.from_numpy(dataset.segment_image(fid)).to(device)
        memo = {}
        with precision.exact():
            g = sam2_amg.mask_gap(ref, image, bmaps, valid, memo)
            prog.add(g)
            fseg, fvalid = first_mask_only(bmaps, valid)
            fault.add(sam2_amg.mask_gap(ref, image, bmaps, fvalid, memo))
        counts.append((g["valid_masks"], g["ref_masks"], g["missed"]))
        if control:
            with torch.no_grad(), precision.lower(sam["compute_dtype"]):
                _, cb, cv = ref.masks(image)
            with precision.exact():
                ctrl.add(sam2_amg.mask_gap(ref, image, cb, cv, memo))
        del seg, bmaps, valid, memo
    out = {"seed": seed, "program": prog.numbers(), "fault": fault.numbers(),
           "masks_prog_ref_missed": counts,
           "seconds": time.perf_counter() - t0}
    if control:
        out["control"] = ctrl.numbers()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--budget-s", type=float, default=float("inf"))
    args = ap.parse_args(argv)
    run._cache_env()
    _, _, cfg, traffic, _ = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("[calibrate] needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    from ovo_tpu_torch.ops import cuda_build

    cuda_build.build_all([k for k in cfg.get("prebuild_kernels", [])
                          if k in cuda_build.KERNELS])
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    t0 = time.perf_counter()
    for s in (int(s) for s in args.seeds.split(",")):
        if time.perf_counter() - t0 > args.budget_s:
            print(f"[calibrate] budget spent before seed {s}", flush=True)
            break
        rec = read_seed(cfg, traffic, s, args.seconds, s in ctrl, device)
        print(json.dumps({"workload": args.workload, **rec}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
