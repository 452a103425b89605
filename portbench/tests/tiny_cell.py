"""A cell at a size the CPU runs in seconds: the two configurations'
structure on the port's test-scale cards (SAM2 ``hiera_test`` at 128^2,
``tiny-pe`` / ``tiny-test`` towers, a 48 x 64 camera)."""
from __future__ import annotations

import copy
import json

from portbench.spec import HERE

CAM = {"H": 48, "W": 64, "fx": 40.0, "fy": 40.0, "cx": 31.5, "cy": 23.5,
       "depth_scale": 6553.5}
TOWERS = {
    "tiny-pe": {"name": "tiny-pe", "vision": {
        "image_size": 64, "patch_size": 16, "width": 64, "depth": 3,
        "n_heads": 4, "mlp_ratio": 4.0, "embed_dim": 32,
        "use_cls_token": True, "use_abs_pos": True, "use_rope2d": True,
        "pool": "attn", "layer_scale": None, "ln_pre": False, "act": "gelu",
        "dtype": "float32"},
        "mean": [0.48145466, 0.4578275, 0.40821073],
        "std": [0.26862954, 0.26130258, 0.27577711], "clip_dim": 32},
    "tiny-test": {"name": "tiny-test", "vision": {
        "image_size": 64, "patch_size": 16, "width": 64, "depth": 2,
        "n_heads": 4, "mlp_ratio": 4.0, "embed_dim": 32,
        "use_cls_token": True, "use_abs_pos": True, "use_rope2d": False,
        "pool": "attn", "layer_scale": None, "ln_pre": False, "act": "gelu",
        "dtype": "float32"},
        "mean": [0.48145466, 0.4578275, 0.40821073],
        "std": [0.26862954, 0.26130258, 0.27577711], "clip_dim": 32},
}
LIMITS = {"mask_logit_gap": 0.0, "mask_shortfall": 0.0, "seg_mismatch": 0.0,
          "desc_cos_gap": 1e-6,
          "assoc_mismatch": 0.0, "insert_mismatch": 0.0}


def tiny(config: str, batch: int, sam_dtype: str = "float32"):
    """(bench, cfg, traffic, limits) of a test-scale cell of
    ``config``'s structure at ``sam.batch`` ``batch``."""
    cfg = json.loads((HERE / "configs" / f"{config}.json").read_text())
    cfg = copy.deepcopy(cfg)
    sem = cfg["program"]["semantic"]
    sem["sam"].update(sam_encoder="hiera_test", image_size=128,
                      points_per_side=4, gate_prompts=8,
                      compute_dtype=sam_dtype)
    sem["capacity"].update(n_instances=64, n_masks=8)
    # a 48 x 64 frame's masks hold tens of map points, not hundreds
    sem["track_th"] = 5
    cfg["program"]["mapping"]["n_points_capacity"] = 2 ** 14
    if sem["clip"]["embed_type"] == "TextRegion":
        sem["clip"]["model_card"] = "tiny-pe"
        cfg["tower"] = TOWERS["tiny-pe"]
    else:
        sem["clip"]["model_card"] = "tiny-test"
        sem["clip"]["mask_res"] = 32
        cfg["tower"] = TOWERS["tiny-test"]
        cfg["merger"] = {"d_model": 32, "depth": 1, "n_heads": 2,
                         "mlp_hidden": 16}
    traffic = {"program": {"dataset_name": "replica", "cam": CAM,
                           "semantic": {"sam": {"batch": batch}}},
               "distinct_frames": 12, "warmup_keyframes": 2 * batch,
               "pace_kf_per_s": 10.0,
               "samples": 2}
    bench = {"end_to_end": [{"name": n} for n in
                            ("kf_per_s", "kf_latency_p95_ms", "peak_mem_gib",
                             "setup_s")],
             "per_layer": []}
    return bench, cfg, traffic, dict(LIMITS)
