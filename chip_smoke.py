"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises, so the script exits
non-zero and prints no result):

  gpu        the card's name and power limit, as nvidia-smi gives them
  build      compile every hand-written kernel from ovo_tpu_torch/csrc
  kernel     each kernel at the main path's shapes, in bf16 and f32, against
             its plain PyTorch version on the same inputs; kernel, plain and
             library times (CUDA events, median of 30 after warm-up) and the
             card's least time for the same work (B12's library column: the
             default route's block half, B5 and cuBLAS GEMMs, on the same
             input and weights; B13's the decoder's unfused tail); B7, B8
             and B9a / B9b at the 1280^2 decoder's shapes, shared and
             per-prompt image sides; B11 at Hiera-L's stage-1 and stage-3
             windows, B13 (bf16 only) at 128 and 256 prompts, B14 at its
             gated shapes (and, beside F.layer_norm's, its time a call in a
             run of calls back to back: the single call is mostly host
             time); B1-B7, B9a, B9b, B10, B11, B12a and B12b in bf16 also
             within ATTN_SHARE (B3: B3_SHARE, B12: B12_SHARE) outputs off
             by more than one bf16 step, which the wrong functions (B1's
             and B6's weights rounded once, B2's and B10's rounded before
             normalizing, B3's, B5's, B7's, B9a's and B9b's left unrounded,
             B4's
             attn left unrounded, B12b's h left in f32 or its gelu on erf,
             B12a's q and k rounded before RoPE or its weights left
             unrounded) must break; B14 in bf16 also within ATTN_SHARE (no
             wrong function: only its sums' order differs); B10 in f32
             also within B10_F32_TOL, which one TF32 product per f32
             product must break; B3, B4 and B7's library time is the whole
             function in library calls (cuBLAS projections, SDPA, B4's
             out-projection and F.layer_norm), B3 and B4's SDPA alone
             beside it; B3 and B4 also at SAM1's 7 decoder tokens (B3 on
             its fixed-width instance, which masks the eighth row) and B2
             at 7 x 7;
             B13's least time is the largest of its bytes and
             the exact gelu chain's instructions and MUFU operations per
             element (B13_CHAIN_OPS; its compiled loop from cuobjdump's SASS
             is reported beside it)
  reference  the online pipeline on a small synthetic scene with the tiny-pe
             card, on the card (kernels) and on the CPU (plain versions):
             equal point map and instances, descriptors within cosine 1e-4
  reference_amg  the SAM2 automatic-mask program on the hiera_test card at
             256^2 in f32, on the card (kernels) and on the CPU (plain
             versions): equal valid sets, seg maps equal but for < 0.1% of
             pixels (logits within rounding of 0), and the decoder's logits
             for every grid prompt within 2e-5 of the largest (its decoder
             takes the proj_tail route: B3 / B4)
  reference_sam1  the same on the SAM1 vit_test card (ViT-det trunk, the
             objectless decoder, the pad path on the 180 x 320 frame, the
             host small-region pass at min_mask_region_area 100), card
             against CPU; its decoder's 7 tokens take B2, B3 and B4
  reference_utility  the routes to B11 and B13 on the hiera_test card at
             256^2, card against CPU: the trunk with window_attn="packed"
             in f32 (features within 2e-4; B11 on every window block) and
             decode_grid(mask_tail="fused") in bf16 (B13; logits within 5%
             of the largest)
  utility_path  B11, B13 and B14 driven by name at full width: the Hiera-L
             trunk at 1024^2 in bf16, "packed" against "heads" (45 B11, 3
             B1, 0 B2); decode_grid at the AMG shape (top_prompts 128),
             mask_tail "fused" against "unfused" (one B13 per decode); B14
             at its gated shapes (4088 x 1024, 1024 x 1152)
  reference_batch  sam.batch 2 on the small scene (hiera_test masks,
             tiny-pe), card against CPU: equal map and instances,
             descriptors within cosine 1e-4, three flushes of two
  reference_decoder  decode_masks through each route of the two-way
             transformer (proj_tail: B3 / B4; proj: B3 / B7 / B8; unfused:
             B9a / B9b / B8): the hiera_test card's decoder in f32 on the
             card and on the CPU, every output within 2e-4 of the CPU's
             unfused route; then in bf16 at the 1280^2 AMG shape (256
             prompts, L 6400) on the card, the routes within a bf16 limit
             of each other; launch counts per route
  slice      OVOSemMap on a seeded 680x1200 synthetic scene with Replica
             intrinsics, precomputed-style masks (up to 96 per keyframe) and
             TextRegion on PE-Core-L14-336 at full width with random
             weights, a 2^21-point map; launch counts of every kernel
  amg_slice  the main path: the same run (the same scene, built once) with
             live masks from the SAM2 Hiera-L automatic mask generator at
             1024^2 (built from the config, seeded random bf16 weights,
             gates at 0); launch counts per keyframe, host syncs in the
             frame loop (none allowed); the decoder takes the proj_tail
             route (B3 3, B4 2, none of B7-B9)
  amg1280_slice  the same with SAM2 Hiera-L at image_size 1280 (80^2 = 6400
             image rows) on the scene's first 30 frames: the decoder takes
             the unfused route (per segmented keyframe B9a 3, B9b 2, B8 2,
             no B3 / B4 / B7; B1 3, B2 47), no host sync in the frame loop
  batch_slice  the amg_slice with sam.batch 2 on the scene's first 30
             frames: the trunk once per flush, one tower call per pair;
             launches per flush; the only host syncs in the frame loop are
             the flushes' validity reads
  multidevice_slice  the batch_slice with parallel {point_shard,
             shard_query, dp_embed} in a world of one on nccl (the process
             joins a one-rank group): the map, active ids, store and
             descriptors bit-equal to the batch_slice's, kf/s, collectives
             per keyframe; then python -m ovo_tpu_torch.parallel.dryrun with
             no arguments (nccl, a rank a card: a world of one here; wider
             worlds are held on the CPU by tests/test_torch_parallel.py)
  sam1_slice the amg_slice's first 30 frames with SAM1 (sam_version "",
             sam_encoder vit_h: the ViT-det at full width, 1024^2, seeded
             random bf16 weights, gates at 0, min_mask_region_area 100):
             the 680x1200 frames fill 580 x 1024 of the padded square; per
             segmented keyframe B2 2, B3 3, B4 2 (7 decoder tokens, the
             proj_tail route), no B1 (the trunk runs no kernel); the only
             host syncs in the frame loop are the small-region pass's
  orb_slice  the amg_slice with configs/ovo.yaml's own backbone, orbslam
             (configs/slam/orbslam/replica.yaml's gates, read through the
             port's config chain): the scene's first 30 frames out and back
             (59 frames, each with its own pose as GT), poses from the
             native tracker, mapping on its keyframes; the tracker OK on
             every frame, at least one big change followed by
             _rebuild_map and update_map, a culled keyframe's block and
             descriptors dropped, the blocks a disjoint ascending partition
             of [0, count); per segmented keyframe B1 3, B2 47, B3 3, B4 2,
             per tower call (one per segmented keyframe) B5 24, B6 1; the
             only host syncs in the frame loop are the ORB tier's (the
             count after each keyframe's insert, loop closure's two
             reads); tracker ms per frame (host), ms per update_map and
             _rebuild_map, fused and removed instances, the candidate
             pairs within 1e-5 of a gate
  reference_gaussian  OVOSemMap with the gaussian_slam backbone
             (configs/slam/gaussian_slam/replica.yaml's tracking: odometry
             init; small mapping knobs, REF_GAUSSIAN) on a 12-frame 96 x 160
             wall of varying depth with the tiny-pe card, on the card and on
             the CPU: one render of the CPU run's map and its gradients to
             all five inputs (2e-4; 1e-4 of the largest gradient), the
             frame-0 map's live slots equal, track_pose on one map from one
             pose within 1e-4 m, the runs' keyframes equal, live counts,
             poses and instance counts within REF_GAUSSIAN_LIMITS (about
             twice the largest spread seen between such runs)
  gaussian_slice  the amg_slice's first 11 frames with the Gaussian-SLAM
             backbone of configs/slam/gaussian_slam/replica.yaml at full
             width (capacity 2^20, k_per_tile 64 with escalation, 262,144
             seeds and 1000 iterations on frame 0, 100 on frames 5 and 10,
             60 pose iterations on frames 2-10 from the native odometry):
             the odometry built, every state tensor on the card, at least 8
             tracked frames and 2 mapped keyframes, the tracked poses within
             20 cm of GT; tracker ms per frame,
             mapper ms per keyframe (frame 0 apart), the final map's render
             forward and forward + backward ms, live gaussians, the
             k_per_tile used, launches per segmented keyframe (B1 3, B2 47,
             B3 3, B4 2; B5 24, B6 1 per tower call); the only host syncs in
             the frame loop are the tier's reads (splat.read_host), counted
             per frame and by caller
  checkpoint seeded random weights at full width under the official keys,
             torch.save'd and loaded through the factories:
             sam_vit_h_4b8939.pth (build_sam_mask_source), a PE-Core-L14-336
             open_clip checkpoint (build_clip_embedder, TextRegion), a
             merger model.pt (load_merger); each model's outputs bit-equal
             to the same tree's through from_jax_params; bytes, write and
             load-and-convert seconds
  merger_train  the learned merger's train step at full width (1152, depth
             5, 8 heads, head MLP 512; 1024 instances x 3 clips; Adam,
             MERGER_TRAIN): two steps on the card against the CPU (step
             1's loss within MERGER_LOSS_TOL, its gradients within
             MERGER_GRAD_REL of their norm, step 2's loss within
             MERGER_STEP2_TOL), then 20 steps; ms per step, peak memory,
             loss first and last; no kernel (head size 144 takes the plain
             attention route)
  reference_crop  the crop ``hovsg`` embedder on a SigLIP-structured card
             built here (no class token, attention pooling, 224^2 / 14 = 256
             tokens, so the tower takes kernel B10; bidirectional text
             tower), on the small scene, on the card and on the CPU, then
             classify_instances: equal map and instances, descriptors within
             cosine 1e-4, classes equal where the top-2 margin is above 1e-4
  crop_slice the paper's descriptor: the precomputed-mask slice with the
             clip section set to the learned merger over SigLIP-384 crops
             at full width (f32, random weights), the scene's first 30
             frames; 81 B10 launches per embedded keyframe (27 layers x the
             seg, bbox and global views), no other kernel, no host sync in
             the frame loop
  query      classify_instances over the crop_slice's map (SigLIP-384 text
             tower, 64 tokens: 27 B2 launches per class) and over the
             slice's map (PE's causal text tower: the plain route, no
             kernel); similarities finite and in [0, 1] for SigLIP
  viewer     the slice's precomputed masks on the scene's first 21 frames
             with vis.stream true: a spawned headless viewer, one scripted
             query; the exports written, the final clouds equal to the
             final map's bytes, the answer equal to
             Visualizer.query_values_per_point called directly, no host
             sync in the frame loop but the stream's reads and the query's;
             _close_stream's wall
  reference_cli  run_eval.main --run --segment --eval on a small PNG scene
             (64x96, 8 frames, hiera_test, the tiny-pe card, gates at 0) on
             the card under OVO_FUSED_BLOCK=1 (B12a / B12b) and with
             --device cpu, the same weights: equal map points and object
             ids, descriptors within cosine 1e-4, labels equal where the
             instance's top-2 margin is above 1e-4, equal metrics when the
             labels are equal; with profile_trace set, each run writes one
             Chrome trace, the card's naming the port's kernels; then
             --parallel_scenes 2 on two such scenes (a spawned process a
             scene on the card) against the serial run
  reference_orb  run_eval.main --run --segment --eval on a 64x96 PNG
             scene of 23 frames out and back (hiera_test, tiny-pe, gates at
             0) on configs/ovo.yaml's own orbslam backbone (tracker gates
             for the small scene in the scene's config), on the card and
             with --device cpu, the same weights: the same keyframes, big
             changes and culled set, equal count, point and object ids,
             points within 1e-5, the same active ids and fused pairs,
             descriptors within cosine 1e-4, labels equal where the top-2
             margin is above 1e-4
  cli        the user's command at full width: --run --segment --eval on a
             680x1200 PNG scene of 40 frames with a GT mesh, the
             configs/ovo.yaml chain from a copied config tree (vanilla
             backbone, debug and logging off, gates at 0), under
             OVO_FUSED_BLOCK=1: per embedded keyframe 24 B12a, 24 B12b, 1
             B6 and no B5 launches, B1-B4 as in the amg_slice; no host sync
             in the frame loop; a finite mIoU / mAcc; each phase's wall
  kernel_device  B5, B6, B1, B2, B11, B9a, B3, B4, B7, B9b, B13, B12a,
             B12b and B14 in bf16 and B10 in f32 at the kernel phase's
             shapes: the card's kernel time per call from a torch.profiler
             trace, beside SDPA's (B3 / B4 / B7: beside the whole function's
             library route; B12a / B12b: beside the default route's block
             half; B13: beside the decoder's unfused tail; B14: beside
             F.layer_norm); B7's and B9b's traces must name their
             tensor-core kernels (last, since a trace slows later launches);
             a call none of whose traces holds the card's events is timed
             by CUDA events over calls back to back and listed in
             ``untraced``
  kernels    the kernels with their launch counts on the path that runs
             them: the amg_slice (B1-B6), the crop_slice (B10), the cli
             (B12a / B12b), the amg1280_slice (B9a, B9b, B8), the
             reference_decoder's bf16 proj route (B7), the utility_path
             (B11, B13, B14)

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. The script imports nothing of JAX.

    python3 chip_smoke.py --profile PATH [--image-size 1280 | --crop | --cli
                                          | --sam1 | --orb | --gaussian]

runs only the amg_slice (the amg1280_slice, the crop_slice, the cli, the
sam1_slice, the orb_slice, the gaussian_slice) three times: untraced,
traced (the card's activity, torch.profiler; the kernel table written to
PATH; the cli's --run loop only, with B12's device time per embedded
keyframe; at 1280, B9b's device time per segmented keyframe), untraced
again.
"""
from __future__ import annotations

import collections
import copy
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

# the main path's configuration: configs/ovo.yaml <- configs/slam/vanilla/
# replica.yaml <- configs/Replica/replica.yaml, with the vanilla backbone,
# debug output off, and no live logging
REPLICA_CONFIG = {
    "dataset_name": "replica",
    "use_wandb": False,
    "debug": False,
    "debug_info": False,
    "slam": {"slam_module": "vanilla", "save_estimated_cam": True},
    "vis": {"stream": False, "show_stream": False},
    "mapping": {"map_every": 5, "n_points_capacity": 2 ** 21,
                "k_pooling": 3, "downscale_res": 2},
    "tracking": {"track_every": 1},
    "data": {"scene_name": "smoke0", "frame_limit": -1},
    "cam": {"H": 680, "W": 1200, "fx": 600.0, "fy": 600.0, "cx": 599.5,
            "cy": 339.5, "depth_scale": 6553.5},
    "semantic": {
        "segment_every": 10, "match_distance_th": 0.05, "track_th": 100,
        "depth_filter": True, "log": False, "kf_queue_delay": 10,
        "capacity": {"n_instances": 1024, "n_masks": 96, "top_k_slots": 16},
        "sam": {"precomputed": True},
        "clip": {"embed_type": "TextRegion", "model_card": "PE-Core-L14-336",
                 "mask_res": 336, "k_top_views": 10000,
                 "fusion": "avg_pooling"},
    },
}

# published dense peaks (NVIDIA data sheets): bf16 tensor FLOP/s, f32 (CUDA
# core) FLOP/s, HBM bytes/s, TF32 tensor FLOP/s (half the bf16 rate)
PEAKS = {
    "PCIe": (756e12, 51e12, 2.0e12, 378e12),
    "NVL": (835e12, 60e12, 3.9e12, 417.5e12),
    "SXM": (989e12, 67e12, 3.35e12, 494.7e12),
}
B5_SOURCE = "ovo_tpu_torch/csrc/rope_packed_attention.cu"
B6_SOURCE = "ovo_tpu_torch/csrc/masked_pool.cu"
B5_REPLACES = "ovo_tpu/ops/attention.py:326"
B6_REPLACES = "ovo_tpu/ops/masked_pool.py:61"
# the AMG slice's kernels: (launch-count name, source, TPU kernel)
AMG_KERNELS = {
    "flash_attention": ("ovo_tpu_torch/csrc/flash_attention.cu",
                        "ovo_tpu/ops/attention.py:155"),
    "windowed_attention": ("ovo_tpu_torch/csrc/windowed_attention.cu",
                           "ovo_tpu/ops/attention.py:395"),
    "cross_t2i": ("ovo_tpu_torch/csrc/cross_t2i.cu",
                  "ovo_tpu/ops/attention.py:1120"),
    "cross_i2t_tail": ("ovo_tpu_torch/csrc/cross_i2t_tail.cu",
                       "ovo_tpu/ops/attention.py:1075"),
}
# launches per segmented keyframe of Hiera-L + the two-way decoder: 3 global
# blocks; 45 window blocks + 2 token self-attentions; t2i in 2 layers + the
# final attention; i2t + norm4 in 2 layers
AMG_LAUNCHES_PER_KF = {"flash_attention": 3, "windowed_attention": 47,
                       "cross_t2i": 3, "cross_i2t_tail": 2}
# the decoder's other routes' kernels: (launch-count name, source, TPU
# kernel)
ROUTE_KERNELS = {
    "cross_small_head_t2i": ("ovo_tpu_torch/csrc/cross_small_head.cu",
                             "ovo_tpu/ops/attention.py:798"),
    "cross_small_head_i2t": ("ovo_tpu_torch/csrc/cross_small_head.cu",
                             "ovo_tpu/ops/attention.py:816"),
    "residual_layer_norm": ("ovo_tpu_torch/csrc/residual_layer_norm.cu",
                            "ovo_tpu/ops/layer_norm.py:148"),
    "cross_i2t_proj": ("ovo_tpu_torch/csrc/cross_i2t_proj.cu",
                       "ovo_tpu/ops/attention.py:1143"),
}
# at 1280^2 (L 6400) the bf16 decoder takes the unfused route: t2i in 2
# layers + the final attention through B9a, i2t through B9b and norm4
# through B8 in 2 layers; the trunk's launches are those of 1024^2
AMG1280_LAUNCHES_PER_KF = {"flash_attention": 3, "windowed_attention": 47,
                           "cross_small_head_t2i": 3,
                           "cross_small_head_i2t": 2,
                           "residual_layer_norm": 2}
# launches per decode on each route of the two-way transformer (B2: the
# token self-attention of both layers)
ROUTE_LAUNCHES = {
    "proj_tail": {"windowed_attention": 2, "cross_t2i": 3,
                  "cross_i2t_tail": 2},
    "proj": {"windowed_attention": 2, "cross_t2i": 3, "cross_i2t_proj": 2,
             "residual_layer_norm": 2},
    "unfused": {"windowed_attention": 2, "cross_small_head_t2i": 3,
                "cross_small_head_i2t": 2, "residual_layer_norm": 2}}
# the paper's descriptor (SURVEY.md section 6): SAM2 masks, SigLIP-384
# crops (masked, bbox, global) fused by the learned merger
CROP_CLIP = {"embed_type": "learned", "model_card": "SigLIP-384",
             "mask_res": 336, "k_top_views": 10000, "fusion": "avg_pooling"}
B10_SOURCE = "ovo_tpu_torch/csrc/fused_attention.cu"
B10_REPLACES = "ovo_tpu/ops/attention.py:218"
B12A_SOURCE = "ovo_tpu_torch/csrc/fused_attn_block.cu"
B12A_REPLACES = "ovo_tpu/ops/fused_block.py:106"
B12B_SOURCE = "ovo_tpu_torch/csrc/fused_mlp_block.cu"
B12B_REPLACES = "ovo_tpu/ops/fused_block.py:184"
# the kernels the reference wires into no route, driven by name in the
# utility_path phase: (launch-count name, source, TPU kernel)
UTILITY_KERNELS = {
    "packed_heads_attention": ("ovo_tpu_torch/csrc/packed_heads_attention.cu",
                               "ovo_tpu/ops/attention.py:499"),
    "mask_tail": ("ovo_tpu_torch/csrc/mask_tail.cu",
                  "ovo_tpu/ops/mask_tail.py:73"),
    "layer_norm_rows": ("ovo_tpu_torch/csrc/residual_layer_norm.cu",
                        "ovo_tpu/ops/layer_norm.py:82"),
}
# the Hiera-L trunk's launches per pass at 1024^2: 3 global blocks, 45
# window blocks (of AMG_LAUNCHES_PER_KF's 47 B2, the other 2 are the
# decoder's); under window_attn="packed" the 45 go to B11
TRUNK_LAUNCHES = {"flash_attention": 3, "windowed_attention": 45}
# B14 at its gated shapes: PE-Core-L14-336's LayerNorm rows (7 views x 584)
# at width 1024 and Hiera-L's stage 4 (32^2 rows) at 1152
B14_SHAPES = {"pe": (4088, 1024), "hiera_s4": (1024, 1152)}
# B11 at Hiera-L's window shapes (windows, L, heads, hd)
B11_SHAPES = {"stage1": (1024, 64, 2, 72), "stage3": (25, 196, 8, 72)}
# B10 at the crop path's shapes: the global view and 96 mask crops of
# SigLIP-384 (16 heads of 72, 27^2 = 729 tokens)
B10_BATCHES = (1, 96)
# the query phase's vocabulary: Replica's most frequent classes
QUERY_CLASSES = ["wall", "floor", "ceiling", "chair", "table", "sofa", "bed",
                 "cabinet", "door", "window", "lamp", "pillow", "plant",
                 "book", "rug", "blinds"]
QUERY_TEMPLATE = "This is a photo of a {}"

# the live mask source of the main path: configs/ovo.yaml's sam section
# (hiera_l, SAM 2.1, 16x16 points) with the random-weight gates at 0
SAM_LIVE = {"precomputed": False, "sam_encoder": "hiera_l",
            "sam_version": "2.1", "points_per_side": 16, "image_size": 1024,
            "pred_iou_th": 0.0, "stability_score_th": 0.0,
            "nms_score_th": 0.0, "gate_prompts": 128}
# the SAM1 tier (the reference's sam_version ""): ViT-H at 1024^2, the same
# grid and gates; min_mask_region_area stays at SAM1's default, 100, so the
# host small-region pass runs
SAM1_LIVE = dict(SAM_LIVE, sam_encoder="vit_h", sam_version="")
# launches per segmented keyframe of the SAM1 path: the ViT-det trunk runs
# no kernel (its attention is the reference's plain einsums); the decoder's
# 7 tokens take the proj_tail route as SAM2's 8 do
SAM1_LAUNCHES_PER_KF = {"windowed_attention": 2, "cross_t2i": 3,
                        "cross_i2t_tail": 2}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def peaks_for(name: str):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return "SXM", PEAKS["SXM"]


def time_ms(fn, warmup: int = 5, iters: int = 30) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def run_ms(fn, iters: int = 100) -> float:
    """CUDA-event time per call over a run of ``iters`` calls back to back
    (after a warm-up): the larger of the card's and the host's time per
    call, where time_ms times each call alone, from an idle card and a
    host thread just back from a synchronize."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# calls of device_ms whose traces held no device time (run_ms timed them)
UNTRACED = []


def device_ms(fn, iters: int = 20, by_name=None, tag: str = "") -> float:
    """The card's kernel time per call of fn, from a torch.profiler trace
    of the card's activity (sum of its kernels' intervals over the calls):
    free of the host time between two CUDA events, which dominates calls
    below ~0.15 ms. A trace leaves host time on every later launch of the
    process, so this runs after every phase that times with CUDA events or
    the host's clock. ``by_name``, a dict, receives the time per call of
    each kernel name (the first 60 characters).

    A trace now and then holds none of the card's events, at times several
    in a row: it is taken again with the host idle for a while on both sides of the work, and if
    none holds them, the call's time is run_ms's (host gaps included, so
    at least the device time), ``tag`` goes to UNTRACED and ``by_name``
    stays empty. After one such call, the later ones trace once only."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for pad in (0.0,) if UNTRACED else (0.0, 0.05, 0.5):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [e for e in prof.events() if e.device_type.name == "CUDA"]
        us = sum(e.time_range.elapsed_us() for e in events)
        if us > 0:
            for e in events if by_name is not None else ():
                key = e.name[:60]
                by_name[key] = (by_name.get(key, 0.0)
                                + e.time_range.elapsed_us() / 1e3 / iters)
            return us / 1e3 / iters
        print(f"[device_ms] {tag}: a trace padded by {pad} s held no device "
              f"time ({len(prof.events())} events)", file=sys.stderr,
              flush=True)
    UNTRACED.append(tag)
    return run_ms(fn, iters)


def storage_bytes(*tensors) -> int:
    """Bytes each input holds once (a broadcast view counts its storage)."""
    return sum(t.untyped_storage().nbytes() for t in tensors)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

# B5 at the PE tower's shape: 7 views of 577 tokens padded to 584, 16
# heads of 64 (views, heads, hd, kv_len, L)
B5_SHAPE = (7, 16, 64, 577, 584)


def _b5_inputs(dev, dtype):
    """B5's packed qkv and RoPE tables at B5_SHAPE, and the library's
    operands: q and k rotated, head-split, with the key mask."""
    from ovo_tpu_torch.models.layers import rope2d_freqs
    from ovo_tpu_torch.ops.attention import apply_rope

    B, heads, hd, Lr, L = B5_SHAPE
    D = heads * hd
    gen = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    cos, sin = rope2d_freqs(24, 24, hd, n_prefix=1, device=dev)
    pad = cos.new_zeros((L - Lr, hd // 2))
    cos, sin = torch.cat([cos, pad]), torch.cat([sin, pad])
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    lib = (apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.contiguous(),
           (torch.arange(L, device=dev) < Lr)[None, None, None, :])
    return qkv, cos, sin, lib


def check_b5(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.attention import (rope_packed_attention,
                                             rope_packed_attention_plain)

    B, heads, hd, Lr, L = B5_SHAPE
    D = heads * hd
    qkv, cos, sin, (q, k, v, mask) = _b5_inputs(dev, dtype)
    errs, shares = {}, {}
    for kv in (Lr, L):
        got = rope_packed_attention(qkv, cos, sin, heads=heads, kv_len=kv)
        ref = rope_packed_attention_plain(qkv, cos, sin, heads=heads,
                                          kv_len=kv)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError("B5 produced non-finite values")
        errs[kv] = float((got.float() - ref.float()).abs().max())
        if dtype == torch.bfloat16 and kv == Lr:
            shares = _shares("B5", got, ref, rope_packed_unrounded_weights(
                qkv, cos, sin, heads=heads, kv_len=kv))
    err = max(errs.values())
    if err > tol:
        raise AssertionError(f"B5 {dtype}: max_abs_err {err} > {tol}")

    ms = time_ms(lambda: rope_packed_attention(qkv, cos, sin, heads=heads,
                                               kv_len=Lr))
    plain_ms = time_ms(lambda: rope_packed_attention_plain(
        qkv, cos, sin, heads=heads, kv_len=Lr))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask))
    nbytes = storage_bytes(qkv, cos, sin) + B * L * D * qkv.element_size()
    flops = 4.0 * B * heads * L * Lr * hd
    rate = peaks[0] if dtype == torch.bfloat16 else peaks[1]
    t_bytes, t_ops = nbytes / peaks[2] * 1e3, flops / rate * 1e3
    return dict(name="rope_packed_attention", dtype=str(dtype)[6:],
                shape=[B, L, 3 * D], kv_len=Lr, max_abs_err=err, tol=tol,
                max_abs_err_full_kv=errs[L], kernel_ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, **shares)


def _b6_inputs(dev, dtype):
    """B6 at TextRegion's shape (96 mask slots, 16 heads of 64, 48 x 72
    tokens): the path's layout (one probe query; k one row per head,
    broadcast over the tokens; v a head-transposed view), a dense q and k
    that exercise the softmax, and masks as soft-mask supports of random
    regions, the last 30 slots padding."""
    M, H, hd, L = 96, 16, 64, 48 * 72
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((1, H * hd), generator=gen, device=dev).to(dtype)
    q = q.reshape(1, H, hd).expand(M, H, hd).contiguous()
    k = torch.randn((H, 1, hd), generator=gen, device=dev).to(dtype)
    k = k.expand(H, L, hd)                                 # as TextRegion
    v = torch.randn((L, H * hd), generator=gen, device=dev).to(dtype)
    v = v.reshape(L, H, hd).transpose(0, 1)                # as TextRegion
    mask = torch.rand((M, L), generator=gen, device=dev) < 0.15
    mask[-30:] = False
    kd = torch.randn((H, L, hd), generator=gen, device=dev).to(dtype)
    qd = torch.randn((M, H, hd), generator=gen, device=dev).to(dtype)
    return q, k, v, mask, qd, kd


def check_b6(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.masked_pool import masked_pool, masked_pool_plain

    q, k, v, mask, qd, kd = _b6_inputs(dev, dtype)
    M, H, hd = q.shape
    L = v.shape[1]
    scale = hd ** -0.5
    err, shares = 0.0, {}
    for qq, kk in ((q, k), (qd, kd)):
        got = masked_pool(qq, kk, v, mask, scale)
        ref = masked_pool_plain(qq, kk, v, mask, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError("B6 produced non-finite values")
        err = max(err, float((got.float() - ref.float()).abs().max()))
        if dtype != torch.bfloat16:
            continue
        # the path's layout weighs a row's tokens alike, where the weights
        # rounded once move no output by a step: only the dense layout
        # tells the wrong function apart
        if kk is k:
            shares["path_step_share"] = step_share(got, ref)
            if shares["path_step_share"] > ATTN_SHARE:
                raise AssertionError(f"B6: {shares['path_step_share']} of "
                                     f"the outputs off by more than a step")
        else:
            shares.update(_shares("B6", got, ref, masked_pool_rounded_weights(
                qq, kk, v, mask, scale)))
    uniform = v.float().mean(dim=1)                        # (H, hd)
    err_pad = float((got[-30:].float() - uniform).abs().max())
    if err > tol or err_pad > tol:
        raise AssertionError(f"B6 {dtype}: max_abs_err {err} / padded rows "
                             f"{err_pad} > {tol}")
    ms = time_ms(lambda: masked_pool(q, k, v, mask, scale))
    plain_ms = time_ms(lambda: masked_pool_plain(q, k, v, mask, scale))
    qs, ks, vs = q.transpose(0, 1)[None], k[None], v[None]
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask[None, None], scale=scale))
    nbytes = storage_bytes(q, k, v, mask) + M * H * hd * q.element_size()
    flops = 4.0 * M * H * L * hd
    rate = peaks[0] if dtype == torch.bfloat16 else peaks[1]
    t_bytes, t_ops = nbytes / peaks[2] * 1e3, flops / rate * 1e3
    return dict(name="masked_pool", dtype=str(dtype)[6:], shape=[M, H, hd, L],
                max_abs_err=max(err, err_pad), tol=tol,
                max_abs_err_padded_rows=err_pad, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, **shares)


def _bound(nbytes, flops, dtype, peaks):
    rate = peaks[0] if dtype == torch.bfloat16 else peaks[1]
    t_bytes, t_ops = nbytes / peaks[2] * 1e3, flops / rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _max_err(got, ref, what):
    torch.cuda.synchronize()
    # a NaN on either side would read as no error (max and > ignore NaN)
    if not (torch.isfinite(got.float()).all()
            and torch.isfinite(ref.float()).all()):
        raise AssertionError(f"{what} produced non-finite values")
    return float((got.float() - ref.float()).abs().max())


def _mismatch_share(got, ref, atol=2 ** -10):
    """The share of elements of got that differ from ref by more than
    atol."""
    return float(((got.float() - ref.float()).abs() > atol).float().mean())


def _report(name, dtype, err, tol, kernel, plain, library, nbytes, flops,
            peaks, bound=None, iters=30, **extra):
    """Check the error, then time kernel, plain version and library call
    (each the median of ``iters`` calls). ``bound`` (ms, "bytes" or
    "operations") replaces the dtype's bound where the kernel's route does
    the work in another number format."""
    if err > tol:
        raise AssertionError(f"{name} {dtype}: max_abs_err {err} > {tol}")
    bound_ms, bound_by = bound or _bound(nbytes, flops, dtype, peaks)
    return dict(name=name, dtype=str(dtype)[6:], max_abs_err=err, tol=tol,
                kernel_ms=time_ms(kernel, iters=iters),
                plain_ms=time_ms(plain, iters=iters),
                library_ms=time_ms(library, iters=iters), bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops, **extra)


def _heads_of_packed(gen, n, L, heads, hd, dev, dtype):
    """q, k, v as the Hiera trunk hands them over: head-split strided views
    of one packed (n, L, 3, heads, hd) projection."""
    qkv = torch.randn((n, L, 3, heads, hd), generator=gen,
                      device=dev).to(dtype)
    return qkv, [qkv[:, :, i].transpose(1, 2) for i in range(3)]


# B1, B2, B11, B4, B5 and B6 in bf16: the share of outputs that differ
# from the plain version by more than one bf16 step at the plain output's
# magnitude. The max-abs limits alone pass a kernel that computes another
# function at these sizes: B1 and B6 with their weights rounded once to
# bf16 (the reference's kernels never round them; B6's XLA route does),
# B2 / B11 with exp(s - m) rounded before it is normalized (the reference
# rounds the normalized weight), B5 with its normalized weights left
# unrounded, B4 with attn left unrounded. On an H100 at the main paths'
# shapes (this script's kernel rows) the kernels read 4.0e-4 (B1), 8.0e-5
# or less (B2, B11), 4.3e-5 (B4), 1.1e-4 (B5) and 4.1e-5 (B6's dense
# inputs), the wrong functions 0.037 to 0.168: the limit sits 25x above
# the kernels' largest share and 3.7x below the wrong functions' smallest.
# On the CPU (tests/test_torch_attention_share.py) a reordered f32 sum of
# the right function, and B1's p_hi + p_lo split, stay under it at these
# widths and the wrong functions break it; B6's path layout (one probe
# query, k constant over the tokens) weighs a row's tokens alike, where
# the once-rounded weights move no output by a step, so its dense inputs
# carry the check. B9a (its weights left unrounded: 0.13 on the CPU) and
# B10 (B2's wrong function) hold it too since their tensor-core designs,
# B7 (its normalized weights left unrounded: 0.079-0.082 on the CPU, the
# kernel's mma chains modelled there 4.9e-5) and B9b (0.084-0.095, its mma
# steps 5.2e-6, with and without masked tokens) since their own, and B14,
# whose kernel sums its statistics in another order than the plain
# version.
ATTN_SHARE = 1e-2


def step_share(got, ref) -> float:
    """The share of elements of got that differ from ref by more than one
    bf16 step (2^(floor(log2 |ref|) - 7)) at ref's magnitude."""
    ref = ref.float()
    step = torch.exp2(torch.floor(torch.log2(
        ref.abs().clamp_min(2.0 ** -126))) - 7)
    return float(((got.float() - ref).abs() > step).float().mean())


def flash_attention_rounded_once(q, k, v):
    """B1's plain version with its f32 weights rounded once to bf16 before
    p . v: another function, which B1's share limit must refuse."""
    s = torch.matmul(q.float() * q.shape[-1] ** -0.5,
                     k.float().transpose(-1, -2))
    p = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.matmul(p, v.float()).to(q.dtype)


def windowed_attention_rounded_early(q, k, v):
    """B2's plain version with exp(s - m) rounded to bf16 before it is
    normalized (p . v divided by the sum at the end): another function,
    which B2's and B11's share limit must refuse."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (
        q.shape[-1] ** -0.5)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return (torch.matmul(e.to(torch.bfloat16).float(), v.float())
            / e.sum(dim=-1, keepdim=True)).to(q.dtype)


def _shares(name, got, ref, wrong, limit=ATTN_SHARE):
    """The kernel's step share and the wrong function's, bf16 only; raises
    unless the limit passes the kernel and refuses the wrong function."""
    share, wrong_share = step_share(got, ref), step_share(wrong, ref)
    if share > limit or wrong_share <= limit:
        raise AssertionError(f"{name}: {share} of the outputs differ from "
                             f"the plain version by more than a bf16 step, "
                             f"{wrong_share} of the wrong function's; the "
                             f"limit is {limit}")
    return dict(step_share=share, wrong_step_share=wrong_share,
                share_limit=limit)


# B3 (cross_t2i) in bf16: its output is pk . Wv + bv, a sum over dk = 256
# products that dilutes a weight's rounding, so the function whose
# normalized weights are left unrounded before p . keys (the first design's)
# moves fewer outputs by a step than at B1 / B2's outputs, near ATTN_SHARE
# (8.3e-3 in a CPU run at 8 prompts with other inputs; on an H100 at this
# script's AMG shape 1.14e-2 with shared keys, 1.39e-2 per-prompt). The
# tensor-core kernel reads 3.3e-4 and 4.7e-4 there: B3_SHARE sits 4x above
# the kernel's larger share and 5.7x below the wrong function's smaller.
B3_SHARE = 2e-3


def cross_t2i_unrounded_weights(q_proj, keys, wk, wv, pe_k, bv, heads):
    """B3's plain version with its normalized weights left in f32 before
    p . keys (the first design's function): another function, which
    B3_SHARE must refuse."""
    dt = keys.dtype
    Bq, T, D = q_proj.shape
    L, dk = keys.shape[1], keys.shape[2]
    dh = D // heads
    qh = q_proj.float().reshape(Bq, T, heads, dh)
    wkh = wk.to(dt).float().reshape(dk, heads, dh)
    qk = torch.einsum("bthj,chj->bhtc", qh, wkh).to(dt).float()
    kf = keys.float()[:, None]
    pe = pe_k.to(dt).float().reshape(L, heads, dh)
    s = (torch.matmul(qk, kf.transpose(-1, -2))
         + torch.einsum("bthj,lhj->bhtl", qh, pe)) * dh ** -0.5
    pk = torch.matmul(torch.softmax(s, dim=-1), kf).to(dt).float()
    o = torch.einsum("bhtc,chj->bthj", pk,
                     wv.to(dt).float().reshape(dk, heads, dh))
    o = o + bv.float().reshape(heads, dh)
    return o.reshape(o.shape[0], T, D).to(q_proj.dtype)


def cross_i2t_tail_unrounded_attn(keys, wq, pe_q, kk_tok, vv_tok, wout,
                                  bout, ln_scale, ln_bias, heads, eps=1e-5,
                                  t_len=None):
    """B4's plain version with attn (p . v_tok) left in f32 before the
    out-projection: another function, which ATTN_SHARE must refuse."""
    dt = keys.dtype
    L = keys.shape[1]
    Bt, T, D = kk_tok.shape
    B = max(keys.shape[0], Bt)
    dh = D // heads
    kh = kk_tok.float().reshape(Bt, T, heads, dh)
    kq = torch.einsum("bthj,chj->bhtc", kh,
                      wq.to(dt).float().reshape(-1, heads, dh)).to(dt).float()
    pe = pe_q.to(dt).float().reshape(L, heads, dh)
    s = (torch.matmul(kq, keys.float()[:, None].transpose(-1, -2))
         + torch.einsum("bthj,lhj->bhtl", kh, pe)) * dh ** -0.5
    if t_len is not None and t_len < T:
        keep = (torch.arange(T, device=keys.device) < t_len)[:, None]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=2).to(dt).float()
    vh = vv_tok.float().reshape(Bt, T, heads, dh).expand(B, T, heads, dh)
    attn = torch.einsum("bhtl,bthj->blhj", p, vh).reshape(B, L, D)
    y = torch.matmul(attn, wout.to(dt).float()) + bout.float()
    x = y.to(dt).float() + keys.float()
    cen = x - x.mean(dim=-1, keepdim=True)
    var = (cen * cen).mean(dim=-1, keepdim=True)
    return (cen * torch.rsqrt(var + eps) * ln_scale.float()
            + ln_bias.float()).to(dt)


def cross_i2t_from_keys_unrounded_p(keys, wq, pe_q, kk_tok, vv_tok, heads,
                                    t_len=None):
    """B7's plain version with its normalized weights p left in f32 before
    p . v_tok: another function, which ATTN_SHARE must refuse."""
    dt = keys.dtype
    L = keys.shape[1]
    Bt, T, D = kk_tok.shape
    B = max(keys.shape[0], Bt)
    dh = D // heads
    kh = kk_tok.float().reshape(Bt, T, heads, dh)
    kq = torch.einsum("bthj,chj->bhtc", kh,
                      wq.to(dt).float().reshape(-1, heads, dh)).to(dt).float()
    pe = pe_q.to(dt).float().reshape(L, heads, dh)
    s = (torch.matmul(kq, keys.float()[:, None].transpose(-1, -2))
         + torch.einsum("bthj,lhj->bhtl", kh, pe)) * dh ** -0.5
    if t_len is not None and t_len < T:
        keep = (torch.arange(T, device=keys.device) < t_len)[:, None]
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=2)
    vh = vv_tok.float().reshape(Bt, T, heads, dh).expand(B, T, heads, dh)
    return torch.einsum("bhtl,bthj->blhj", p, vh).reshape(B, L, D).to(dt)


def rope_packed_unrounded_weights(qkv, cos, sin, *, heads, kv_len):
    """B5's plain version with its normalized weights left in f32 before
    p . v (the first design's function): B1's plain attention on the
    rotated heads. Another function, which ATTN_SHARE must refuse."""
    from ovo_tpu_torch.ops.attention import apply_rope, flash_attention_plain

    B, L, three_d = qkv.shape
    D = three_d // 3
    q, k, v = (t.reshape(B, L, heads, D // heads).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    o = flash_attention_plain(apply_rope(q, cos, sin), apply_rope(k, cos, sin),
                              v, kv_len=kv_len)
    return o.transpose(1, 2).reshape(B, L, D)


def masked_pool_rounded_weights(q, k, v, key_mask, scale):
    """B6's plain version with its f32 weights rounded once to bf16 before
    p . v: the function of the reference's XLA route
    (xla_masked_single_query_attention), not of its Pallas kernel, which
    never rounds them. ATTN_SHARE must refuse it on B6's dense inputs."""
    s = torch.einsum("mhd,hld->mhl", q.float() * scale, k.float())
    s = torch.where(key_mask.bool()[:, None, :], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    return torch.einsum("mhl,hld->mhd", p, v.float()).to(q.dtype)


def cross_small_head_unrounded_weights(qq, kk, vv, heads):
    """B9a's plain version with its normalized weights left in f32 before
    p . v (C3's fault, found in B3): another function, which ATTN_SHARE
    must refuse. On the CPU at the decoder's widths over 2048-6400 image
    rows (tests/test_torch_attention_share.py) it moves 0.13 of the outputs
    by more than a bf16 step, a reordered f32 sum of the right function
    1.2e-4 to 1.8e-4."""
    B = max(qq.shape[0], kk.shape[0])
    D = qq.shape[-1]
    dh = D // heads

    def heads_of(t):
        h = t.reshape(t.shape[0], t.shape[1], heads, dh).transpose(1, 2)
        return h.expand((B,) + h.shape[1:]).float()

    s = torch.matmul(heads_of(qq), heads_of(kk).transpose(-1, -2)) * (
        dh ** -0.5)
    o = torch.matmul(torch.softmax(s, dim=-1), heads_of(vv)).to(qq.dtype)
    return o.transpose(1, 2).reshape(B, qq.shape[1], D)



def cross_small_head_i2t_unrounded_weights(qq, kk, vv, heads, t_len=None):
    """B9b's plain version with its normalized weights left in f32 before
    p . v: another function, which ATTN_SHARE must refuse. On the CPU at
    the 1280^2 decoder's widths over 2048 image rows
    (tests/test_torch_attention_share.py) it moves 0.084-0.095 of the
    outputs by more than a bf16 step, the kernel's mma steps modelled there
    at most 5.2e-6."""
    from ovo_tpu_torch.ops.attention import _keys_below

    B = max(qq.shape[0], kk.shape[0])
    D = qq.shape[-1]
    dh = D // heads

    def heads_of(t):
        h = t.reshape(t.shape[0], t.shape[1], heads, dh).transpose(1, 2)
        return h.expand((B,) + h.shape[1:]).float()

    s = torch.matmul(heads_of(qq), heads_of(kk).transpose(-1, -2)) * (
        dh ** -0.5)
    keep = _keys_below(kk.shape[1], t_len, qq.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    o = torch.matmul(torch.softmax(s, dim=-1), heads_of(vv)).to(qq.dtype)
    return o.transpose(1, 2).reshape(B, qq.shape[1], D)

# B10 in f32 runs on the tensor cores as 3xTF32 (three TF32 products per
# f32 product, csrc/fused_attention.cu). The 1e-4 limit of the other f32
# rows barely tells that from one TF32 product with q, k, p and v rounded to
# a 10-bit mantissa (fused_attention_tf32_once), which reads 2.8e-4 / 3.6e-4
# against the plain version at the crop path's shape (16 heads x 729 x 72,
# kv_len 729 / 629, N(0,1) inputs; a CPU run of
# tests/test_torch_attention_share.py), where an emulated 3xTF32 product
# reads 1.6e-6 / 1.8e-6. On an H100 (check_b10) the kernel reads 1.6e-6 at
# batch 1 and 4.4e-6 at batch 96, the once-rounded function 5.8e-4 and
# 7.3e-4 (its first version, which carried the mma's accumulation over the
# whole row, read 9.3e-6 at batch 96). B10_F32_TOL sits 2.3x above the
# kernel's largest error and 58x below the once-rounded function's
# smallest.
B10_F32_TOL = 1e-5


def tf32_round(x):
    """f32 values rounded to TF32 (10-bit mantissa, to nearest, ties away
    from zero, as cvt.rna.tf32.f32), kept in f32."""
    i = x.float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def fused_attention_tf32_once(q, k, v, kv_len=None):
    """B10's f32 plain version with q, k, p and v each rounded once to TF32
    before its product (one TF32 tensor-core pass per product): another
    function, which B10_F32_TOL must refuse."""
    s = torch.matmul(tf32_round(q), tf32_round(k).transpose(-1, -2)) * (
        q.shape[-1] ** -0.5)
    if kv_len is not None and kv_len < k.shape[-2]:
        keep = torch.arange(k.shape[-2], device=q.device) < kv_len
        s = torch.where(keep, s, torch.full_like(s, -1e30))
    return torch.matmul(tf32_round(torch.softmax(s, dim=-1)), tf32_round(v))


def check_b1(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_plain)

    heads, L, hd = 8, 4096, 72          # Hiera-L global blocks at 1024^2
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv, (q, k, v) = _heads_of_packed(gen, 1, L, heads, hd, dev, dtype)
    got, ref = flash_attention(q, k, v), flash_attention_plain(q, k, v)
    err = _max_err(got, ref, "B1")
    shares = {} if dtype != torch.bfloat16 else _shares(
        "B1", got, ref, flash_attention_rounded_once(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("flash_attention", dtype, err, tol,
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention_plain(q, k, v),
                   lambda: sdpa(q, k, v), storage_bytes(qkv) + q.numel()
                   * q.element_size(), 4.0 * heads * L * L * hd, peaks,
                   shape=[1, heads, L, hd], **shares)


# B2 at the main paths' shapes, (windows, heads, lq, lk, hd): the AMG
# windows and decoder tokens, and the SigLIP-384 text tower (one prompt of
# 64 tokens; its q, k, v are head-split views of one packed projection too)
B2_SHAPES = {"stage1": (1024, 2, 64, 64, 72), "stage3": (25, 8, 196, 196, 72),
             "decoder": (256, 8, 8, 8, 32), "text": (1, 16, 64, 64, 72),
             "decoder_sam1": (256, 8, 7, 7, 32)}


def check_b2(dev, dtype, peaks, tol, which):
    from ovo_tpu_torch.ops.attention import (windowed_attention_plain,
                                             windowed_fused_attention)

    n, heads, lq, lk, hd = B2_SHAPES[which]
    gen = torch.Generator(device=dev).manual_seed(2)
    qkv, (q, k, v) = _heads_of_packed(gen, n, lk, heads, hd, dev, dtype)
    q = q[:, :, :lq]
    got = windowed_fused_attention(q, k, v)
    ref = windowed_attention_plain(q, k, v)
    err = _max_err(got, ref, "B2")
    shares = {} if dtype != torch.bfloat16 else _shares(
        "B2", got, ref, windowed_attention_rounded_early(q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("windowed_attention", dtype, err, tol,
                   lambda: windowed_fused_attention(q, k, v),
                   lambda: windowed_attention_plain(q, k, v),
                   lambda: sdpa(q, k, v),
                   storage_bytes(qkv) + q.numel() * q.element_size(),
                   4.0 * n * heads * lq * lk * hd, peaks, case=which,
                   shape=[n * heads, lq, lk, hd], **shares)


def _cross_inputs(dev, dtype, Bk, B=256, T=8, L=4096, D=128, dk=256):
    """The decoder's cross-attention operands. Fewer than 8 tokens (SAM1's
    7) take the 8-token draw's first T tokens, so that the two rows time
    the same values."""
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    x = dict(q=rnd(B, max(T, 8), D), keys=rnd(Bk, L, dk),
             wk=rnd(dk, D, std=dk ** -0.5), wv=rnd(dk, D, std=dk ** -0.5),
             pe=rnd(1, L, D), bv=rnd(D, dt=torch.float32),
             vt=rnd(B, max(T, 8), D), wout=rnd(D, dk, std=D ** -0.5),
             bout=rnd(dk, dt=torch.float32),
             g=rnd(dk, std=0.1, dt=torch.float32) + 1.0,
             b=rnd(dk, dt=torch.float32))
    for k in ("q", "vt"):
        x[k] = x[k][:, :T].contiguous()
    return x


def _small_head_split(t, B, heads):
    """(B or 1, n, D) -> (B, heads, n, 16), a batch-1 side expanded."""
    return t.reshape(t.shape[0], t.shape[1], heads, -1).transpose(
        1, 2).expand(B, heads, t.shape[1], -1)


def _b3_library(x, heads):
    """B3's whole function in library calls: cuBLAS for the image-side
    projections, then SDPA per head (the port calls none of them)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B, dtype = x["q"].shape[0], x["q"].dtype
    qh = _small_head_split(x["q"], B, heads)

    def library():
        kk = x["keys"] @ x["wk"] + x["pe"]
        vv = x["keys"] @ x["wv"] + x["bv"].to(dtype)
        return sdpa(qh, _small_head_split(kk, B, heads),
                    _small_head_split(vv, B, heads))

    return library


def _b4_library(x, heads):
    """B4's whole function in library calls: cuBLAS for the query
    projection, SDPA per head, cuBLAS for the out-projection, then
    F.layer_norm of the residual sum (the port calls none of them)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    (B, _, D), (_, L, dk) = x["q"].shape, x["keys"].shape
    dtype = x["q"].dtype
    kt, vt = (_small_head_split(x[k], B, heads) for k in ("q", "vt"))

    def library():
        qq = _small_head_split(x["keys"] @ x["wk"] + x["pe"], B, heads)
        attn = sdpa(qq, kt, vt).transpose(1, 2).reshape(B, L, D)
        y = attn @ x["wout"] + x["bout"].to(dtype)
        return torch.nn.functional.layer_norm(
            y + x["keys"], (dk,), x["g"].to(dtype), x["b"].to(dtype))

    return library


def check_b3(dev, dtype, peaks, tol, Bk, T=8):
    """B3 at the SAM decoder's shape with ``T`` tokens: 8 (SAM2), or 7
    (SAM1), which the fixed-width instance takes with its eighth row
    masked."""
    from ovo_tpu_torch.ops.attention import (cross_t2i_from_keys,
                                             cross_t2i_from_keys_plain)

    heads, dh = 8, 16
    x = _cross_inputs(dev, dtype, Bk, T=T)
    (B, T, D), (_, L, dk) = x["q"].shape, x["keys"].shape
    args = (x["q"], x["keys"], x["wk"], x["wv"], x["pe"], x["bv"], heads)
    got, ref = cross_t2i_from_keys(*args), cross_t2i_from_keys_plain(*args)
    err = _max_err(got, ref, "B3")
    shares = {} if dtype != torch.bfloat16 else _shares(
        "B3", got, ref, cross_t2i_unrounded_weights(*args), limit=B3_SHARE)
    del got, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh = _small_head_split(x["q"], B, heads)
    library = _b3_library(x, heads)
    # SDPA alone on the operands projected outside the timed call (the
    # yardstick of the earlier rows)
    kk = _small_head_split(x["keys"] @ x["wk"] + x["pe"], B, heads)
    vv = _small_head_split(x["keys"] @ x["wv"] + x["bv"].to(dtype), B, heads)
    sdpa_ms = time_ms(lambda: sdpa(qh, kk, vv))
    del kk, vv
    flops = 2.0 * B * heads * T * (L * (2 * dk + dh) + 2 * dk * dh)
    nbytes = (storage_bytes(*(x[k] for k in ("q", "keys", "wk", "wv", "pe",
                                             "bv")))
              + B * T * D * x["q"].element_size())
    return _report("cross_t2i", dtype, err, tol,
                   lambda: cross_t2i_from_keys(*args),
                   lambda: cross_t2i_from_keys_plain(*args), library,
                   nbytes, flops, peaks, keys_batch=Bk,
                   shape=[B, T, L, dk, D], sdpa_ms=sdpa_ms, **shares)


def check_b4(dev, dtype, peaks, tol, Bk, T=8):
    """B4 at the SAM decoder's shape with ``T`` tokens (8: SAM2; 7: SAM1,
    whose tokens the kernel rounds up to 8 columns, the eighth masked)."""
    from ovo_tpu_torch.ops.attention import (cross_i2t_tail_from_keys,
                                             cross_i2t_tail_from_keys_plain)

    heads, dh = 8, 16
    x = _cross_inputs(dev, dtype, Bk, T=T)
    (B, T, D), (_, L, dk) = x["q"].shape, x["keys"].shape
    args = (x["keys"], x["wk"], x["pe"], x["q"], x["vt"], x["wout"],
            x["bout"], x["g"], x["b"], heads)
    err, shares = 0.0, {}
    for t_len in (None, T - 2):
        got = cross_i2t_tail_from_keys(*args, t_len=t_len)
        ref = cross_i2t_tail_from_keys_plain(*args, t_len=t_len)
        err = max(err, _max_err(got, ref, "B4"))
        if dtype == torch.bfloat16 and t_len is None:
            shares = _shares("B4", got, ref,
                             cross_i2t_tail_unrounded_attn(*args))
        del got, ref
    kt, vt = (_small_head_split(x[k], B, heads) for k in ("q", "vt"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library = _b4_library(x, heads)
    # SDPA alone on the query projected outside the timed call (the
    # yardstick of the earlier rows)
    qq = _small_head_split(x["keys"] @ x["wk"] + x["pe"], B, heads)
    sdpa_ms = time_ms(lambda: sdpa(qq, kt, vt))
    del qq
    flops = (2.0 * B * L * (heads * T * (dk + 2 * dh) + D * dk + 4 * dk)
             + 2.0 * B * heads * T * dk * dh)
    nbytes = (storage_bytes(*(x[k] for k in ("keys", "wk", "pe", "q", "vt",
                                             "wout", "bout", "g", "b")))
              + B * L * dk * x["keys"].element_size())
    return _report("cross_i2t_tail", dtype, err, tol,
                   lambda: cross_i2t_tail_from_keys(*args),
                   lambda: cross_i2t_tail_from_keys_plain(*args), library,
                   nbytes, flops, peaks, keys_batch=Bk,
                   shape=[B, T, L, dk, D], sdpa_ms=sdpa_ms, **shares)


# the 1280^2 decoder's shapes (the amg1280_slice): 256 prompts of 8 tokens,
# 8 heads of 16, L = 80^2 image rows, keys of width 256
B9_SHAPE = dict(B=256, T=8, L=6400, heads=8, D=128, dk=256)


def check_b9a(dev, dtype, peaks, tol, Bk):
    from ovo_tpu_torch.ops.attention import (
        cross_attention_small_head, cross_attention_small_head_plain)

    B, T, L, heads, D = (B9_SHAPE[k] for k in ("B", "T", "L", "heads", "D"))
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((Bk, L, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    got = cross_attention_small_head(q, k, v, heads)
    ref = cross_attention_small_head_plain(q, k, v, heads)
    err = _max_err(got, ref, "B9a")
    shares = {} if dtype != torch.bfloat16 else _shares(
        "B9a", got, ref, cross_small_head_unrounded_weights(q, k, v, heads))
    del got, ref
    qh, kh, vh = (_small_head_split(t, B, heads) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("cross_small_head_t2i", dtype, err, tol,
                   lambda: cross_attention_small_head(q, k, v, heads),
                   lambda: cross_attention_small_head_plain(q, k, v, heads),
                   lambda: sdpa(qh, kh, vh),
                   storage_bytes(q, k, v) + q.numel() * q.element_size(),
                   4.0 * B * heads * T * L * (D // heads), peaks,
                   image_batch=Bk, shape=[B, T, L, D], **shares)


def _b9b_inputs(dev, dtype, Bq):
    B, T, L, D = (B9_SHAPE[k] for k in ("B", "T", "L", "D"))
    gen = torch.Generator(device=dev).manual_seed(10)
    q = torch.randn((Bq, L, D), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, T, D), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v


def check_b9b(dev, dtype, peaks, tol, Bq):
    """B9b at the 1280^2 decoder's shape, with all 8 tokens and with the
    last two masked (t_len 6); bf16 also within ATTN_SHARE of the plain
    version, which its normalized weights left in f32 must break."""
    from ovo_tpu_torch.ops.attention import (
        cross_attention_small_head, cross_attention_small_head_plain)

    B, T, L, heads, D = (B9_SHAPE[k] for k in ("B", "T", "L", "heads", "D"))
    q, k, v = _b9b_inputs(dev, dtype, Bq)
    err, shares = 0.0, {}
    for t_len in (None, T - 2):
        got = cross_attention_small_head(q, k, v, heads, t_len=t_len)
        ref = cross_attention_small_head_plain(q, k, v, heads, t_len=t_len)
        err = max(err, _max_err(got, ref, "B9b"))
        if dtype == torch.bfloat16:
            r = _shares("B9b", got, ref,
                        cross_small_head_i2t_unrounded_weights(
                            q, k, v, heads, t_len=t_len))
            tag = "" if t_len is None else "_masked"
            shares.update({f"{key}{tag}": val for key, val in r.items()})
        del got, ref
    qh, kh, vh = (_small_head_split(t, B, heads) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("cross_small_head_i2t", dtype, err, tol,
                   lambda: cross_attention_small_head(q, k, v, heads),
                   lambda: cross_attention_small_head_plain(q, k, v, heads),
                   lambda: sdpa(qh, kh, vh),
                   storage_bytes(q, k, v) + B * L * D * q.element_size(),
                   4.0 * B * heads * T * L * (D // heads), peaks,
                   image_batch=Bq, shape=[B, L, T, D], **shares)


def _b7_library(x, heads):
    """B7's function in library calls: cuBLAS for the projection keys Wq +
    pe_q, then SDPA per head (the port calls neither)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    B = x["q"].shape[0]
    kt, vt = (_small_head_split(x[k], B, heads) for k in ("q", "vt"))

    def library():
        qq = x["keys"] @ x["wk"] + x["pe"]
        return sdpa(_small_head_split(qq, B, heads), kt, vt)

    return library


def check_b7(dev, dtype, peaks, tol, Bk):
    from ovo_tpu_torch.ops.attention import (cross_i2t_from_keys,
                                             cross_i2t_from_keys_plain)

    heads, dh = 8, 16
    x = _cross_inputs(dev, dtype, Bk, B=B9_SHAPE["B"], L=B9_SHAPE["L"])
    (B, T, D), (_, L, dk) = x["q"].shape, x["keys"].shape
    args = (x["keys"], x["wk"], x["pe"], x["q"], x["vt"], heads)
    err, shares = 0.0, {}
    for t_len in (None, T - 2):
        got = cross_i2t_from_keys(*args, t_len=t_len)
        ref = cross_i2t_from_keys_plain(*args, t_len=t_len)
        err = max(err, _max_err(got, ref, "B7"))
        if dtype == torch.bfloat16 and t_len is None:
            shares = _shares("B7", got, ref,
                             cross_i2t_from_keys_unrounded_p(*args))
        del got, ref
    flops = (2.0 * B * heads * T * dk * dh
             + 2.0 * B * L * heads * T * (dk + 2 * dh))
    nbytes = (storage_bytes(*(x[k] for k in ("keys", "wk", "pe", "q", "vt")))
              + B * L * D * x["keys"].element_size())
    return _report("cross_i2t_proj", dtype, err, tol,
                   lambda: cross_i2t_from_keys(*args),
                   lambda: cross_i2t_from_keys_plain(*args),
                   _b7_library(x, heads), nbytes, flops, peaks,
                   keys_batch=Bk, shape=[B, T, L, dk, D], **shares)


def _b8_inputs(dev, dtype, Br):
    B, L, C = B9_SHAPE["B"], B9_SHAPE["L"], B9_SHAPE["dk"]
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((B, L, C), generator=gen, device=dev).to(dtype)
    r = torch.randn((Br, L, C), generator=gen, device=dev).to(dtype)
    g = torch.randn((C,), generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn((C,), generator=gen, device=dev)
    return x, r, g, b


def check_b8(dev, dtype, peaks, tol, Br):
    from ovo_tpu_torch.ops.layer_norm import (residual_layer_norm,
                                              residual_layer_norm_plain)

    B, L, C = B9_SHAPE["B"], B9_SHAPE["L"], B9_SHAPE["dk"]
    x, r, g, b = _b8_inputs(dev, dtype, Br)
    err = _max_err(residual_layer_norm(x, r, g, b),
                   residual_layer_norm_plain(x, r, g, b), "B8")
    lnorm = torch.nn.functional.layer_norm
    return _report("residual_layer_norm", dtype, err, tol,
                   lambda: residual_layer_norm(x, r, g, b),
                   lambda: residual_layer_norm_plain(x, r, g, b),
                   lambda: lnorm(x.float() + r.float(), (C,), g, b),
                   storage_bytes(x, r, g, b) + x.numel() * x.element_size(),
                   8.0 * B * L * C, peaks, res_batch=Br, shape=[B, L, C])


def check_b10(dev, dtype, peaks, tol, batch):
    from ovo_tpu_torch.ops.attention import (fused_attention,
                                             fused_attention_plain)

    heads, L, hd = 16, 729, 72          # SigLIP-384: 27^2 tokens
    gen = torch.Generator(device=dev).manual_seed(10)
    qkv, (q, k, v) = _heads_of_packed(gen, batch, L, heads, hd, dev, dtype)
    err, extra = 0.0, {}
    for kv in (None, L - 100):
        got = fused_attention(q, k, v, kv_len=kv)
        ref = fused_attention_plain(q, k, v, kv_len=kv)
        err = max(err, _max_err(got, ref, "B10"))
        if dtype == torch.float32:
            # the kernel's 3xTF32 products against one TF32 product each
            wrong = _max_err(fused_attention_tf32_once(q, k, v, kv), ref,
                             "B10 tf32 once")
            if err > B10_F32_TOL or wrong <= B10_F32_TOL:
                raise AssertionError(
                    f"B10 f32: max_abs_err {err}, one TF32 pass {wrong}; "
                    f"the limit B10_F32_TOL is {B10_F32_TOL}")
            extra = dict(f32_tol=B10_F32_TOL, wrong_max_abs_err=max(
                wrong, extra.get("wrong_max_abs_err", 0.0)))
        else:
            extra = _shares("B10", got, ref,
                            windowed_attention_rounded_early(q, k, v))
        del got, ref
    flops = 4.0 * batch * heads * L * L * hd
    nbytes = storage_bytes(qkv) + q.numel() * q.element_size()
    bound = None
    if dtype == torch.float32:
        # the route's least time: three TF32 products per f32 product
        t_bytes, t_ops = nbytes / peaks[2] * 1e3, 3 * flops / peaks[3] * 1e3
        bound = (max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations")
        extra.update(bound_route="3xTF32", fma_bound_ms=flops / peaks[1] * 1e3)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("fused_attention", dtype, err, tol,
                   lambda: fused_attention(q, k, v),
                   lambda: fused_attention_plain(q, k, v),
                   lambda: sdpa(q, k, v), nbytes, flops, peaks, bound=bound,
                   shape=[batch, heads, L, hd], **extra)


# B12 at PE-Core-L14-336's shapes: 7 views of 577 tokens (the TextRegion
# embedder's batch), width 1024, 16 heads of 64, MLP hidden 4096 in chunks
# of 512; and, for the branches the tower does not take, a causal block
# without RoPE and with masked keys at the tiny-pe width (4 heads of 16)
B12_SHAPE = dict(B=7, L=577, D=1024, heads=16, hidden=4096)
B12_SMALL = dict(B=2, L=150, D=64, heads=4, hidden=256, l_real=131)


# B12a / B12b in bf16: the share of outputs off by more than one bf16 step
# (step_share). The outputs are x plus the block half, up to ~8, so the
# max-abs limit (6e-2) passes functions that round at another place; the
# share sees them at the outputs of small magnitude, where a step is small.
# The wrong functions: B12b with h left in f32 into the proj, or its bf16
# gelu computed with erf (the f32 rule); B12a with q and k rounded to bf16
# before the f32 RoPE, or its weights p left unrounded. On an H100 at the
# path's shape (check_b12a / check_b12b, PERF.md PR 11) they read 0.075,
# 0.040, 0.038 and 0.021, the kernels 4.5e-3 (B12a) and 1.9e-3 (B12b):
# B12_SHARE sits 2.2x above the kernels and 2.1x below the smallest wrong
# function. B12a's qkv GEMM sums per 64-deep k step for this reason: summed
# by the mma over all of D, its accumulation without rounding to nearest
# moved more outputs by a step than two plain evaluations (card and CPU)
# differ in. On the CPU (tests/test_torch_fused_block_share.py) the right
# function summed as a model of the mma chains stays under it and the
# wrong functions break it.
B12_SHARE = 1e-2


def fused_mlp_block_variant(x, fc_w, fc_b, proj_w, proj_b, ln_scale,
                            ln_bias, *, act="gelu", chunk=1024,
                            h_f32=False, erf_gelu=False):
    """B12b's plain version (fused_block.fused_mlp_block_plain's op order)
    with one of its wrong functions: ``h_f32`` leaves h in f32 into the
    proj, ``erf_gelu`` takes the erf gelu in bf16. B12_SHARE must refuse
    each."""
    from ovo_tpu_torch.ops.fused_block import _act, _ln_rows

    dt = x.dtype
    hidden = fc_w.shape[1]
    lnx = _ln_rows(x, ln_scale, ln_bias).float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for c0 in range(0, hidden, chunk):
        h = lnx @ fc_w[:, c0:c0 + chunk].float() + fc_b[c0:c0 + chunk].float()
        h = torch.nn.functional.gelu(h) if erf_gelu else _act(h, act, dt)
        if not h_f32:
            h = h.to(dt)
        acc = acc + h.float() @ proj_w[c0:c0 + chunk].float()
    return (x.float() + acc + proj_b.float()).to(dt)


def fused_attn_block_variant(x, w_heads, b_heads, ow_heads, out_b, ln_scale,
                             ln_bias, cos, sin, *, n_heads, L_real, causal,
                             use_rope, qk_early=False, p_f32=False):
    """B12a's plain version (fused_block.fused_attn_block_plain's op order)
    with one of its wrong functions: ``qk_early`` rounds q and k to the
    dtype before the f32 RoPE, ``p_f32`` leaves the weights unrounded.
    B12_SHARE must refuse each."""
    from ovo_tpu_torch.ops.fused_block import _ln_rows, _rot

    dt = x.dtype
    L = x.shape[-2]
    hd = w_heads.shape[-1] // 3
    lnx = _ln_rows(x, ln_scale, ln_bias).float()
    col = torch.arange(L, device=x.device)
    mask = (col >= L_real)[None, :]
    if causal:
        mask = mask | (col[None, :] > col[:, None])
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for h in range(n_heads):
        qkv = lnx @ w_heads[h].float() + b_heads[h].float()
        q, k, v = qkv[..., :hd], qkv[..., hd:2 * hd], qkv[..., 2 * hd:]
        if qk_early:
            q, k = q.to(dt).float(), k.to(dt).float()
        if use_rope:
            q, k = _rot(q, cos, sin), _rot(k, cos, sin)
        s = (q.to(dt).float() @ k.to(dt).float().transpose(-1, -2)) \
            * hd ** -0.5
        s = torch.where(mask, torch.full_like(s, -1e30), s)
        p = torch.softmax(s, dim=-1)
        if not p_f32:
            p = p.to(dt)
        oh = (p.float() @ v.to(dt).float()).to(dt)
        acc = acc + oh.float() @ ow_heads[h].float()
    return (x.float() + acc + out_b.float()).to(dt)


def _b12_shares(name, got, ref, wrongs):
    """The kernel's step share and each wrong function's; raises unless
    B12_SHARE passes the kernel and refuses every wrong function."""
    out = {}
    for tag, wrong in wrongs.items():
        r = _shares(f"{name} ({tag})", got, ref, wrong, limit=B12_SHARE)
        out[f"wrong_step_share_{tag}"] = r.pop("wrong_step_share")
        out.update(r)
    return out


def _b12_weights(gen, dev, dtype, D, heads, hidden):
    """Block weights with the init's stds and non-zero biases and
    LayerNorm affines (f32), in the kernels' per-head layout."""
    hd = D // heads

    def rnd(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    f32 = torch.float32
    return dict(
        w_heads=rnd(heads, D, 3 * hd, std=D ** -0.5),
        b_heads=rnd(heads, 3 * hd, std=0.1, dt=f32),
        ow_heads=rnd(heads, hd, D, std=D ** -0.5), ob=rnd(D, std=0.1, dt=f32),
        ln1_s=rnd(D, std=0.1, dt=f32) + 1, ln1_b=rnd(D, std=0.1, dt=f32),
        fc_w=rnd(D, hidden, std=D ** -0.5),
        fc_b=rnd(hidden, std=0.1, dt=f32),
        proj_w=rnd(hidden, D, std=hidden ** -0.5),
        proj_b=rnd(D, std=0.1, dt=f32),
        ln2_s=rnd(D, std=0.1, dt=f32) + 1, ln2_b=rnd(D, std=0.1, dt=f32))


def _default_route_block(w, heads, dtype, dev):
    """The same weights as a ``layers.Block``: the default route (B5 and
    cuBLAS GEMMs) is B12's yardstick, there being no single library call
    for a whole block half."""
    from ovo_tpu_torch.models.layers import Block

    D = w["ob"].shape[0]
    hd = D // heads
    blk = Block(D, heads, w["fc_w"].shape[1] / D, dtype=dtype, device=dev)
    with torch.no_grad():
        blk.attn.qkv.w.copy_(w["w_heads"].reshape(heads, D, 3, hd).permute(
            1, 2, 0, 3).reshape(D, 3 * D))
        blk.attn.qkv.b.copy_(w["b_heads"].reshape(heads, 3, hd).permute(
            1, 0, 2).reshape(3 * D))
        blk.attn.out.w.copy_(w["ow_heads"].reshape(D, D))
        blk.attn.out.b.copy_(w["ob"])
        for name, lin in (("fc", blk.mlp.fc), ("proj", blk.mlp.proj)):
            lin.w.copy_(w[f"{name}_w"])
            lin.b.copy_(w[f"{name}_b"])
        for i, ln in ((1, blk.ln1), (2, blk.ln2)):
            ln.scale.copy_(w[f"ln{i}_s"])
            ln.bias.copy_(w[f"ln{i}_b"])
    return blk


def _b12a_path(dev, dtype, gen):
    """B12a's inputs at the path's shape (7 PE views, RoPE on, every key
    real) and the default route on the same input and weights: LayerNorm,
    the qkv GEMM, B5 (the tower pads 577 -> 584 tokens, n_valid 577), the
    out GEMM, the residual."""
    from ovo_tpu_torch.models.layers import multi_head_attention, rope2d_freqs

    B, L, D, heads = (B12_SHAPE[k] for k in ("B", "L", "D", "heads"))
    hd = D // heads
    w = _b12_weights(gen, dev, dtype, D, heads, B12_SHAPE["hidden"])
    x = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    cos, sin = rope2d_freqs(24, 24, hd, n_prefix=1, device=dev)
    args = (x, w["w_heads"], w["b_heads"], w["ow_heads"], w["ob"], w["ln1_s"],
            w["ln1_b"], cos, sin)
    kw = dict(n_heads=heads, L_real=L, causal=False, use_rope=True)
    blk = _default_route_block(w, heads, dtype, dev)
    Lp = -(-L // 8) * 8
    xp = torch.cat([x, x.new_zeros((B, Lp - L, D))], dim=1)
    pad = cos.new_zeros((Lp - L, hd // 2))
    rope_p = (torch.cat([cos, pad]), torch.cat([sin, pad]))

    def default_route():
        return xp + multi_head_attention(blk.attn, blk.ln1(xp), heads,
                                         rope=rope_p, n_valid=L)

    return args, kw, default_route


def _b12b_path(dev, dtype, gen):
    """B12b's inputs at the path's shape (7 PE views, hidden 4096 in chunks
    of 512, gelu) and the default route on the same input and weights:
    LayerNorm, the fc GEMM, gelu, the proj GEMM, the residual."""
    from ovo_tpu_torch.models.layers import mlp

    B, L, D, hidden = (B12_SHAPE[k] for k in ("B", "L", "D", "hidden"))
    w = _b12_weights(gen, dev, dtype, D, B12_SHAPE["heads"], hidden)
    x = torch.randn((B, L, D), generator=gen, device=dev).to(dtype)
    args = (x, w["fc_w"], w["fc_b"], w["proj_w"], w["proj_b"], w["ln2_s"],
            w["ln2_b"])
    blk = _default_route_block(w, B12_SHAPE["heads"], dtype, dev)
    return args, dict(act="gelu", chunk=512), \
        lambda: x + mlp(blk.mlp, blk.ln2(x))


def check_b12a(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.fused_block import (attn_block_routes,
                                               fused_attn_block,
                                               fused_attn_block_plain)

    gen = torch.Generator(device=dev).manual_seed(12)
    err = 0.0
    # the small case: causal, no RoPE, keys past l_real masked, hd 16
    s = B12_SMALL
    w = _b12_weights(gen, dev, dtype, s["D"], s["heads"], s["hidden"])
    x = torch.randn((s["B"], s["L"], s["D"]), generator=gen,
                    device=dev).to(dtype)
    zeros = torch.zeros((s["L"], s["D"] // s["heads"] // 2), device=dev)
    args = (x, w["w_heads"], w["b_heads"], w["ow_heads"], w["ob"], w["ln1_s"],
            w["ln1_b"], zeros, zeros)
    kw = dict(n_heads=s["heads"], L_real=s["l_real"], causal=True,
              use_rope=False)
    err = max(err, _max_err(fused_attn_block(*args, **kw),
                            fused_attn_block_plain(*args, **kw), "B12a"))
    args, kw, default_route = _b12a_path(dev, dtype, gen)
    got, ref = fused_attn_block(*args, **kw), fused_attn_block_plain(*args,
                                                                     **kw)
    err = max(err, _max_err(got, ref, "B12a"))
    shares = {}
    if dtype == torch.bfloat16:
        shares = _b12_shares("B12a", got, ref, {
            tag: fused_attn_block_variant(*args, **kw, **{tag: True})
            for tag in ("qk_early", "p_f32")})
    del got, ref
    B, L, D, heads = (B12_SHAPE[k] for k in ("B", "L", "D", "heads"))
    hd = D // heads
    x = args[0]
    nbytes = (storage_bytes(*args) + x.numel() * x.element_size())
    flops = B * (2.0 * L * D * 3 * D + 4.0 * heads * L * L * hd
                 + 2.0 * L * D * D)
    return _report("fused_attn_block", dtype, err, tol,
                   lambda: fused_attn_block(*args, **kw),
                   lambda: fused_attn_block_plain(*args, **kw),
                   default_route, nbytes, flops, peaks,
                   yardstick="default route: LayerNorm, qkv GEMM, B5, "
                           "out GEMM, residual",
                   shape=[B, L, D, heads],
                   routes=attn_block_routes(x, args[1], args[3],
                                            n_heads=heads, causal=False),
                   **shares)


def check_b12b(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.fused_block import (fused_mlp_block,
                                               fused_mlp_block_plain,
                                               mlp_block_routes)

    gen = torch.Generator(device=dev).manual_seed(13)
    # the small case: quick_gelu, hidden 256 in one chunk
    s = B12_SMALL
    w = _b12_weights(gen, dev, dtype, s["D"], s["heads"], s["hidden"])
    x = torch.randn((s["B"], s["L"], s["D"]), generator=gen,
                    device=dev).to(dtype)
    args = (x, w["fc_w"], w["fc_b"], w["proj_w"], w["proj_b"], w["ln2_s"],
            w["ln2_b"])
    kw = dict(act="quick_gelu", chunk=s["hidden"])
    err = _max_err(fused_mlp_block(*args, **kw),
                   fused_mlp_block_plain(*args, **kw), "B12b")
    args, kw, default_route = _b12b_path(dev, dtype, gen)
    got = fused_mlp_block(*args, **kw)
    ref = fused_mlp_block_plain(*args, **kw)
    err = max(err, _max_err(got, ref, "B12b"))
    shares = {}
    if dtype == torch.bfloat16:
        shares = _b12_shares("B12b", got, ref, {
            tag: fused_mlp_block_variant(*args, **kw, **{tag: True})
            for tag in ("h_f32", "erf_gelu")})
    del got, ref
    B, L, D, hidden = (B12_SHAPE[k] for k in ("B", "L", "D", "hidden"))
    x = args[0]
    nbytes = storage_bytes(*args) + x.numel() * x.element_size()
    flops = 4.0 * B * L * D * hidden
    return _report("fused_mlp_block", dtype, err, tol,
                   lambda: fused_mlp_block(*args, **kw),
                   lambda: fused_mlp_block_plain(*args, **kw),
                   default_route, nbytes, flops, peaks,
                   yardstick="default route: LayerNorm, fc GEMM, gelu, "
                           "proj GEMM, residual",
                   shape=[B, L, D, hidden],
                   routes=mlp_block_routes(x, args[1], args[3],
                                           kw["chunk"]),
                   **shares)


def _b14_inputs(dev, dtype, which):
    rows, C = B14_SHAPES[which]
    gen = torch.Generator(device=dev).manual_seed(14)
    x = torch.randn((rows, C), generator=gen, device=dev).to(dtype)
    g = torch.randn((C,), generator=gen, device=dev) * 0.1 + 1.0
    b = torch.randn((C,), generator=gen, device=dev)
    return x, g, b


def check_b14(dev, dtype, peaks, tol, which):
    """B14 at a gated shape, scale / bias in f32 (timed: the path's) and in
    bf16 (read as they are); bf16 also within ATTN_SHARE of the plain
    version (the kernel sums the statistics in another order)."""
    from ovo_tpu_torch.ops.layer_norm import (fits, layer_norm_rows,
                                              layer_norm_rows_plain)

    rows, C = B14_SHAPES[which]
    x, g, b = _b14_inputs(dev, dtype, which)
    if not fits(rows, C, x.element_size()):
        raise AssertionError(f"B14: {rows} x {C} is not a gated shape")
    err, share = 0.0, 0.0
    for gg, bb in ((g, b), (g.to(torch.bfloat16), b.to(torch.bfloat16))):
        got, ref = layer_norm_rows(x, gg, bb), layer_norm_rows_plain(x, gg, bb)
        err = max(err, _max_err(got, ref, "B14"))
        share = max(share, step_share(got, ref))
    if dtype == torch.bfloat16 and share > ATTN_SHARE:
        raise AssertionError(f"B14: {share} of the outputs differ from the "
                             f"plain version by more than a bf16 step")
    gx, bx = g.to(dtype), b.to(dtype)

    def kernel():
        return layer_norm_rows(x, g, b)

    def library():
        return torch.nn.functional.layer_norm(x, (C,), gx, bx)

    # calls of ~0.02-0.04 ms, mostly host time that jitters by tens of
    # percent: the medians of 300, and beside them each call's time in a
    # run of calls back to back
    return _report("layer_norm_rows", dtype, err, tol, kernel,
                   lambda: layer_norm_rows_plain(x, g, b), library,
                   storage_bytes(x, g, b) + x.numel() * x.element_size(),
                   8.0 * rows * C, peaks, iters=300, case=which,
                   shape=[rows, C], kernel_run_ms=run_ms(kernel),
                   library_run_ms=run_ms(library),
                   **({"step_share": share, "share_limit": ATTN_SHARE}
                      if dtype == torch.bfloat16 else {}))


def check_b11(dev, dtype, peaks, tol, which):
    from ovo_tpu_torch.ops.attention import (packed_heads_attention,
                                             packed_heads_attention_plain,
                                             windowed_fused_attention)

    n, L, heads, hd = B11_SHAPES[which]
    dout = heads * hd
    gen = torch.Generator(device=dev).manual_seed(11)
    # as the trunk hands them over: column slices of one qkv projection
    qkv = torch.randn((n, L, 3, dout), generator=gen, device=dev).to(dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    got = packed_heads_attention(q, k, v, heads=heads)
    ref = packed_heads_attention_plain(q, k, v, heads=heads)
    err = _max_err(got, ref, "B11")
    # the yardsticks: B2 on the head views, SDPA on the transposed heads
    qh, kh, vh = (t.reshape(n, L, heads, hd).transpose(1, 2)
                  for t in (q, k, v))
    shares = {} if dtype != torch.bfloat16 else _shares(
        "B11", got, ref, windowed_attention_rounded_early(qh, kh, vh)
        .transpose(1, 2).reshape(n, L, dout))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    r = _report("packed_heads_attention", dtype, err, tol,
                lambda: packed_heads_attention(q, k, v, heads=heads),
                lambda: packed_heads_attention_plain(q, k, v, heads=heads),
                lambda: sdpa(qh, kh, vh),
                storage_bytes(qkv) + q.numel() * q.element_size(),
                4.0 * n * heads * L * L * hd, peaks, case=which,
                shape=[n, L, L, dout, heads], **shares)
    r["b2_ms"] = time_ms(lambda: windowed_fused_attention(qh, kh, vh))
    return r


B13_SHAPE = dict(H=64, W=64, c1=64, c2=32, C=3)
# A product on a bf16 rounding edge flips a gelu output a step in a few
# logits in 10^5 (the tensor-core kernel's mma chain over c1, 1.0e-4 of
# them on an H100 at 128 and 256 prompts; modelled on the CPU in
# tests/test_torch_mask_tail_share.py); a gelu computed in f32 and rounded
# once (F.gelu) moves about 90% of them by more than 2^-10
B13_SHARE = 1e-3
# What the exact gelu chain needs per element of the tap product (B x R x 4
# taps x c2), in instructions a lane issues on the CUDA cores: y rounded to
# bf16 (a convert a pair), + b2 and + hr0q (a bf16x2 add a pair each), the
# gelu's six products and two sums (bf16x2, a pair each), its tanh argument
# widened to f32 (one a value), tanhf, and its result rounded (a convert a
# pair). tanhf is CUDA's (tanh.approx flips bf16 roundings the reference
# keeps): ex2 and rcp on the special-function unit and 13 more instructions
# (the polynomial below 0.6, the exp form above it, the select and the
# sign), as cuobjdump's SASS of tanhf shows under CUDA 12.8.
B13_CHAIN_OPS = 0.5 + 2 * 0.5 + 8 * 0.5 + 1 + 15 + 0.5
B13_CHAIN_MUFU = 2


def _unfused_tail(up1g, w2q, b2, hr0, hyper, H, W):
    """The decoder's own unfused tail (``decoder.py``'s upscale2, skip,
    gelu and einsum) on the fused kernel's inputs: B13's yardstick."""
    from ovo_tpu_torch.models.layers import gelu
    from ovo_tpu_torch.models.sam.decoder import _up_blocked

    B, _, c1 = up1g.shape
    c2 = w2q.shape[2]
    y = _up_blocked({"w": w2q.reshape(2, 2, c1, c2), "b": b2},
                    up1g.reshape(B, H, W, 2, 2, c1))
    y = y + hr0.reshape(H, 2, 2, W, 2, 2, c2).permute(0, 3, 1, 4, 2, 5,
                                                      6)[None]
    y = gelu(y).permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(B, 4 * H, 4 * W, c2)
    return torch.einsum("bkc,bhwc->bkhw", hyper.float(), y.float())


def _b13_inputs(dev, dtype, B):
    """check_b13's inputs: tests/test_sam.py's scales, N(0,1) activations,
    skip and hypernet, taps and bias of 0.1; hr0 as the raster skip."""
    H, W, c1, c2, C = (B13_SHAPE[k] for k in ("H", "W", "c1", "c2", "C"))
    gen = torch.Generator(device=dev).manual_seed(13)

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    up1g, hr0, hyper = rnd(B, H * W * 4, c1), rnd(4 * H, 4 * W, c2), rnd(
        B, C, c2)
    w2q, b2 = rnd(4, c1, c2, std=0.1), rnd(c2, std=0.1)
    return up1g, w2q, b2, hr0, hyper


def sass_loop(lib, kernel: str) -> dict:
    """The compiled loop of a kernel: cuobjdump's SASS of the function whose
    mangled name holds ``kernel`` in the shared library ``lib``, and in it
    the loop that spans the most instructions (a backward branch and its
    target). Returns its instruction count, the special-function (MUFU)
    ones among them, and the commonest opcodes."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    body = next(f for f in text.split("Function : ")[1:]
                if kernel in f.splitlines()[0])
    labels, pending, code = {}, [], []
    for line in body.splitlines():
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            addr = int(m.group(1), 16)
            labels.update({lab: addr for lab in pending})
            pending = []
            code.append((addr, m.group(2)))
    loops = []
    for addr, ins in code:
        m = re.search(r"BRA\s+(?:`\()?(\.L_x_\d+|0x[0-9a-f]+)", ins)
        if m:
            target = labels.get(m.group(1)) if m.group(1).startswith(".") \
                else int(m.group(1), 16)
            if target is not None and target <= addr:
                loops.append((target, addr))
    if not loops:
        raise AssertionError(f"sass_loop: {kernel} has no loop")
    lo, hi = max(loops, key=lambda span: span[1] - span[0])
    ops = [ins.split()[1] if ins.startswith("@") else ins.split()[0]
           for addr, ins in code if lo <= addr <= hi]
    return dict(instructions=len(ops),
                mufu=sum(o.startswith("MUFU") for o in ops),
                opcodes=dict(collections.Counter(
                    o.split(".")[0] for o in ops).most_common(12)))


def _b13_bound(B, R, c2, nbytes, flops, peaks):
    """B13's least time: the largest of its bytes over the memory rate, its
    products over the bf16 tensor rate, the gelu chain's instructions
    (B13_CHAIN_OPS an element) at one a lane a clock, which is the f32
    rate's FMA count (peaks[1] / 2), and its MUFU instructions, which a
    special-function unit takes at an eighth of that rate (16 lanes a clock
    an SM against 128). The kernel's compiled loop (sass_loop) is reported
    beside it, not counted in it."""
    from ovo_tpu_torch.ops import cuda_build

    elements = B * R * 4 * c2
    lane_rate = peaks[1] / 2
    chain_ms = elements * B13_CHAIN_OPS / lane_rate * 1e3
    mufu_ms = elements * B13_CHAIN_MUFU * 8 / lane_rate * 1e3
    data_ms, data_by = _bound(nbytes, flops, torch.bfloat16, peaks)
    bound = max(chain_ms, mufu_ms, data_ms)
    loop = sass_loop(cuda_build._lib_path("mask_tail"), "mask_tail_kernel")
    # one pass of the loop: a warp through 16 rows x c2 x 4 taps
    loop["instructions_per_element"] = loop["instructions"] * 32 / (
        16 * c2 * 4)
    return dict(chain_ops_per_element=B13_CHAIN_OPS, chain_ms=chain_ms,
                mufu_ms=mufu_ms, data_bound_ms=data_ms, compiled_loop=loop,
                bound=(bound, data_by if bound == data_ms else "operations"))


def check_b13(dev, dtype, peaks, tol, B):
    from ovo_tpu_torch.ops.mask_tail import (fused_mask_tail,
                                             fused_mask_tail_plain,
                                             gather_hr0q, mask_tail_to_raster)

    H, W, c1, c2, C = (B13_SHAPE[k] for k in ("H", "W", "c1", "c2", "C"))
    R = H * W * 4
    up1g, w2q, b2, hr0, hyper = _b13_inputs(dev, dtype, B)
    hr0q = gather_hr0q(hr0, H, W)
    args = (up1g, w2q, b2, hr0q, hyper)
    got = fused_mask_tail(*args, H=H, W=W)
    ref = fused_mask_tail_plain(*args)
    err = _max_err(got, ref, "B13")
    # the unfused tail rounds its gelu once (F.gelu), the fused one op by op
    unfused = _unfused_tail(up1g, w2q, b2, hr0, hyper, H, W)
    unfused_err = _max_err(mask_tail_to_raster(got, H, W), unfused,
                           "B13 vs unfused")
    # the max-abs limit alone would pass a once-rounded gelu: bound the
    # share of logits off by more than 2^-10 too, and show that it tells
    # the unfused tail apart
    share = _mismatch_share(got, ref)
    unfused_share = _mismatch_share(unfused,
                                    mask_tail_to_raster(ref, H, W))
    if share > B13_SHARE or unfused_share <= B13_SHARE:
        raise AssertionError(f"B13: {share} of the logits differ from the "
                             f"plain version by more than 2^-10, "
                             f"{unfused_share} of the unfused tail's; the "
                             f"limit is {B13_SHARE}")
    logit_max_abs = float(got.abs().max())
    del got, ref, unfused
    nbytes = storage_bytes(*args) + B * 4 * R * C * 4
    flops = 2.0 * B * R * 4 * (c1 * c2 + c2 * C)
    bound = _b13_bound(B, R, c2, nbytes, flops, peaks)
    return _report("mask_tail", dtype, err, tol,
                   lambda: fused_mask_tail(*args, H=H, W=W),
                   lambda: fused_mask_tail_plain(*args),
                   lambda: _unfused_tail(up1g, w2q, b2, hr0, hyper, H, W),
                   nbytes, flops, peaks, bound=bound.pop("bound"),
                   prompts=B, unfused_max_abs_diff=unfused_err,
                   mismatch_share=share, unfused_mismatch_share=unfused_share,
                   logit_max_abs=logit_max_abs,
                   yardstick="the decoder's unfused tail: upscale2 GEMM, "
                             "skip, F.gelu, einsum",
                   shape=[B, R, c1, c2, C], **bound)


# ---------------------------------------------------------------------------
# synthetic scene: a textured height-field wall, everything a function of
# world coordinates, camera translating (GT poses)
# ---------------------------------------------------------------------------

class WallScene:
    def __init__(self, n_frames, H, W, fx, fy, cx, cy, seed=0, cell=0.5):
        rng = np.random.default_rng(seed)
        self.H, self.W = H, W
        self.height, self.width = H, W
        self.crop_edge = 0
        self.dataset_config = {"H": H, "W": W}
        self.intrinsics = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                                   np.float32)
        self.cell = cell
        self.phase = rng.uniform(0, 2 * np.pi, 4)
        self.palette = rng.integers(40, 230, (4096, 3))
        v, u = np.meshgrid(np.arange(H, dtype=np.float64),
                           np.arange(W, dtype=np.float64), indexing="ij")
        self.dx, self.dy = (u - cx) / fx, (v - cy) / fy
        self.poses = []
        for i in range(n_frames):
            c2w = np.eye(4, dtype=np.float32)
            c2w[:3, 3] = [-1.2 + 2.4 * i / max(n_frames - 1, 1),
                          0.15 * np.sin(i / 7.0), 0.1 * np.cos(i / 9.0)]
            self.poses.append(c2w)
        self.frames = [self._render(i) for i in range(n_frames)]

    def surface_z(self, x, y):
        p = self.phase
        return (3.0 + 0.25 * np.sin(1.3 * x + p[0]) * np.cos(0.9 * y + p[1])
                + 0.1 * np.sin(3.1 * x + 2.3 * y + p[2]))

    def _render(self, i):
        c = self.poses[i][:3, 3].astype(np.float64)
        t = np.full(self.dx.shape, 3.0 - c[2])
        for _ in range(12):  # ray / height-field fixed point (contraction)
            t = self.surface_z(c[0] + t * self.dx, c[1] + t * self.dy) - c[2]
        x, y = c[0] + t * self.dx, c[1] + t * self.dy
        cell = (np.floor(x / self.cell).astype(np.int64) % 64) + 64 * (
            np.floor(y / self.cell).astype(np.int64) % 64)
        shade = 0.75 + 0.25 * np.sin(7.0 * x + self.phase[3]) * np.cos(5.0 * y)
        image = np.clip(self.palette[cell] * shade[..., None], 0, 255)
        return (i, image.astype(np.uint8), t.astype(np.float32),
                self.poses[i], cell.astype(np.int32))

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i][:4]

    def head(self, n):
        """The scene's first ``n`` frames, sharing their arrays."""
        if n == len(self):
            return self
        view = copy.copy(self)
        view.frames, view.poses = self.frames[:n], self.poses[:n]
        return view

    def masks(self, frame_id, max_masks=96):
        """One mask per wall cell seen, by cell id; pad_masks keeps 96."""
        cell = self.frames[frame_id][4]
        ids, seg = np.unique(cell, return_inverse=True)
        seg = seg.reshape(cell.shape).astype(np.int32)
        n = min(len(ids), max_masks)
        binary = seg[None] == np.arange(n, dtype=np.int32)[:, None, None]
        return seg, binary


def out_and_back(wall: WallScene, n_out: int, zero_border: bool = False
                 ) -> WallScene:
    """``wall``'s first ``n_out`` frames, then the same frames back to
    frame 0: 2 * n_out - 1 frames with ids 0, 1, ..., each keeping its
    original pose as GT (the texture is a function of world position, so
    nothing is rendered anew). ``zero_border`` takes the depth off the
    one-pixel border (the JAX-vs-port scenes' rule)."""
    order = list(range(n_out)) + list(range(n_out - 2, -1, -1))
    view = copy.copy(wall)
    view.frames, view.poses = [], []
    for k, f in enumerate(order):
        _, image, depth, pose, cell = wall.frames[f]
        if zero_border:
            depth = depth.copy()
            depth[[0, -1]] = 0.0
            depth[:, [0, -1]] = 0.0
        view.frames.append((k, image, depth, pose, cell))
        view.poses.append(pose)
    return view


# ---------------------------------------------------------------------------
# checkpoints in the official layouts
# ---------------------------------------------------------------------------

def flat_params(tree, prefix: str = "") -> dict:
    """{dotted path: f32 numpy array} of a param tree: nested dicts and
    lists of arrays (the JAX package's trees), or an ``nn.Module`` (the
    port's, whose parameters carry the same paths)."""
    from ovo_tpu_torch.models.convert_jax import flatten_tree

    items = ([(k, v.detach().float().cpu()) for k, v in
              tree.named_parameters()]
             if isinstance(tree, torch.nn.Module) else flatten_tree(tree))
    return {prefix + k: np.asarray(v, np.float32) for k, v in items}


def nest_params(flat: dict):
    """The nested tree of a {dotted path: array} map (numeric keys become
    list positions): what ``from_jax_params`` takes."""
    root = {}
    for path, val in flat.items():
        node, keys = root, path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def official_state_dict(kind: str, params) -> dict:
    """A param tree laid out under an official checkpoint's keys, the
    inverse of the converters (``models/convert.py``, ``convert_sam.py``):
    ``kind`` "sam1" (segment_anything's ``sam_vit_*.pth``), "sam2" (SAM 2.1's
    ``model`` dict), "clip" (open_clip / PE: OpenAI-style visual tower, text
    tower at the root) or "merger" (``nn.TransformerEncoder`` layers and a
    Sequential head). ``params``: a tree or ``flat_params``' map. Returns
    {key: f32 CPU tensor}. A test holds it: fed to the reference's
    converters, its output gives the tree back bit for bit."""
    f = params if isinstance(params, dict) and all(
        isinstance(v, np.ndarray) for v in params.values()) \
        else flat_params(params)
    sd = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    def n_of(pattern):
        n = 0
        while pattern.format(n) in f:
            n += 1
        return n

    def lin(dst, src):
        put(f"{dst}.weight", f[f"{src}.w"].T)
        if f"{src}.b" in f:
            put(f"{dst}.bias", f[f"{src}.b"])

    def ln(dst, src):
        put(f"{dst}.weight", f[f"{src}.scale"])
        put(f"{dst}.bias", f[f"{src}.bias"])

    def conv(dst, src, bias=True):
        put(f"{dst}.weight", f[f"{src}.w"].transpose(3, 2, 0, 1))
        if bias and f"{src}.b" in f:
            put(f"{dst}.bias", f[f"{src}.b"])

    def conv_t(dst, src):
        put(f"{dst}.weight", f[f"{src}.w"].transpose(2, 3, 0, 1))
        put(f"{dst}.bias", f[f"{src}.b"])

    def mlp3(dst, src):
        for j in range(3):
            lin(f"{dst}.layers.{j}", f"{src}.l{j}")

    def clip_block(dst, src):
        ln(f"{dst}.ln_1", f"{src}.ln1")
        put(f"{dst}.attn.in_proj_weight", f[f"{src}.attn.qkv.w"].T)
        put(f"{dst}.attn.in_proj_bias", f[f"{src}.attn.qkv.b"])
        lin(f"{dst}.attn.out_proj", f"{src}.attn.out")
        ln(f"{dst}.ln_2", f"{src}.ln2")
        lin(f"{dst}.mlp.c_fc", f"{src}.mlp.fc")
        lin(f"{dst}.mlp.c_proj", f"{src}.mlp.proj")
        if f"{src}.ls1" in f:
            put(f"{dst}.ls_1.gamma", f[f"{src}.ls1"])
            put(f"{dst}.ls_2.gamma", f[f"{src}.ls2"])

    if kind in ("sam1", "sam2"):
        sam1 = kind == "sam1"
        if sam1:
            te = "image_encoder"
            conv(f"{te}.patch_embed.proj", "trunk.patch")
            put(f"{te}.pos_embed", f["trunk.pos_embed"][None])
            for i in range(n_of("trunk.blocks.{}.norm1.scale")):
                d, s = f"{te}.blocks.{i}", f"trunk.blocks.{i}"
                ln(f"{d}.norm1", f"{s}.norm1")
                lin(f"{d}.attn.qkv", f"{s}.attn.qkv")
                lin(f"{d}.attn.proj", f"{s}.attn.proj")
                for ax in ("h", "w"):
                    put(f"{d}.attn.rel_pos_{ax}", f[f"{s}.attn.rel_pos_{ax}"])
                ln(f"{d}.norm2", f"{s}.norm2")
                lin(f"{d}.mlp.lin1", f"{s}.mlp.fc")
                lin(f"{d}.mlp.lin2", f"{s}.mlp.proj")
            conv(f"{te}.neck.0", "trunk.neck.conv1", bias=False)
            ln(f"{te}.neck.1", "trunk.neck.ln1")
            conv(f"{te}.neck.2", "trunk.neck.conv2", bias=False)
            ln(f"{te}.neck.3", "trunk.neck.ln2")
            pe, md = "prompt_encoder", "mask_decoder"
        else:
            te = "image_encoder.trunk"
            conv(f"{te}.patch_embed.proj", "trunk.patch")
            for key in ("pos_embed", "pos_embed_window"):
                put(f"{te}.{key}", f[f"trunk.{key}"].transpose(2, 0, 1)[None])
            for i in range(n_of("trunk.blocks.{}.norm1.scale")):
                d, s = f"{te}.blocks.{i}", f"trunk.blocks.{i}"
                ln(f"{d}.norm1", f"{s}.norm1")
                lin(f"{d}.attn.qkv", f"{s}.attn.qkv")
                lin(f"{d}.attn.proj", f"{s}.attn.proj")
                ln(f"{d}.norm2", f"{s}.norm2")
                lin(f"{d}.mlp.layers.0", f"{s}.mlp.fc")
                lin(f"{d}.mlp.layers.1", f"{s}.mlp.proj")
                if f"{s}.proj.w" in f:
                    lin(f"{d}.proj", f"{s}.proj")
            n = n_of("neck.convs.{}.w")
            for j in range(n):   # the checkpoint's lowest resolution first
                conv(f"image_encoder.neck.convs.{j}.conv",
                     f"neck.convs.{n - 1 - j}")
            pe, md = "sam_prompt_encoder", "sam_mask_decoder"
        put(f"{pe}.pe_layer.positional_encoding_gaussian_matrix",
            f["prompt.pe_gaussian"])
        for i in range(4):
            put(f"{pe}.point_embeddings.{i}.weight",
                f["prompt.point_embeds"][i][None])
        put(f"{pe}.not_a_point_embed.weight", f["prompt.not_a_point"][None])
        put(f"{pe}.no_mask_embed.weight", f["prompt.no_mask"][None])

        def attn(dst, src):
            for a, b in (("q_proj", "q"), ("k_proj", "k"), ("v_proj", "v"),
                         ("out_proj", "out")):
                lin(f"{dst}.{a}", f"{src}.{b}")

        for i in range(n_of("decoder.layers.{}.norm1.scale")):
            d, s = f"{md}.transformer.layers.{i}", f"decoder.layers.{i}"
            attn(f"{d}.self_attn", f"{s}.self_attn")
            attn(f"{d}.cross_attn_token_to_image", f"{s}.cross_t2i")
            attn(f"{d}.cross_attn_image_to_token", f"{s}.cross_i2t")
            for k in range(1, 5):
                ln(f"{d}.norm{k}", f"{s}.norm{k}")
            lin(f"{d}.mlp.lin1", f"{s}.mlp.fc")
            lin(f"{d}.mlp.lin2", f"{s}.mlp.proj")
        attn(f"{md}.transformer.final_attn_token_to_image",
             "decoder.final_attn")
        ln(f"{md}.transformer.norm_final_attn", "decoder.norm_final")
        put(f"{md}.iou_token.weight", f["decoder.iou_token"][None])
        put(f"{md}.mask_tokens.weight", f["decoder.mask_tokens"])
        conv_t(f"{md}.output_upscaling.0", "decoder.upscale1")
        ln(f"{md}.output_upscaling.1", "decoder.upscale_ln")
        conv_t(f"{md}.output_upscaling.3", "decoder.upscale2")
        for i in range(n_of("decoder.hyper_mlps.{}.l0.w")):
            mlp3(f"{md}.output_hypernetworks_mlps.{i}",
                 f"decoder.hyper_mlps.{i}")
        mlp3(f"{md}.iou_prediction_head", "decoder.iou_head")
        if not sam1:
            put(f"{md}.obj_score_token.weight",
                f["decoder.obj_score_token"][None])
            mlp3(f"{md}.pred_obj_score_head", "decoder.obj_head")
            conv(f"{md}.conv_s0", "decoder.conv_s0")
            conv(f"{md}.conv_s1", "decoder.conv_s1")
    elif kind == "clip":
        w = f["visual.patch.w"]
        put("visual.conv1.weight", w.transpose(3, 2, 0, 1))
        if np.any(f["visual.patch.b"]):   # PE's patch conv has no bias
            put("visual.conv1.bias", f["visual.patch.b"])
        if "visual.cls" in f:
            put("visual.class_embedding", f["visual.cls"])
        if "visual.pos" in f:
            put("visual.positional_embedding", f["visual.pos"])
        if "visual.ln_pre.scale" in f:
            ln("visual.ln_pre", "visual.ln_pre")
        for i in range(n_of("visual.blocks.{}.ln1.scale")):
            clip_block(f"visual.transformer.resblocks.{i}",
                       f"visual.blocks.{i}")
        ln("visual.ln_post", "visual.ln_post")
        put("visual.proj", f["visual.proj"])
        if "visual.attn_pool.probe" in f:
            ap = "visual.attn_pool"
            put(f"{ap}.probe", f[f"{ap}.probe"][None])
            put(f"{ap}.attn.in_proj_weight", np.concatenate(
                [f[f"{ap}.{x}.w"].T for x in "qkv"]))
            put(f"{ap}.attn.in_proj_bias", np.concatenate(
                [f[f"{ap}.{x}.b"] for x in "qkv"]))
            lin(f"{ap}.attn.out_proj", f"{ap}.out")
            ln(f"{ap}.layernorm", f"{ap}.ln")
        put("token_embedding.weight", f["text.tok_embed"])
        put("positional_embedding", f["text.pos"])
        for i in range(n_of("text.blocks.{}.ln1.scale")):
            clip_block(f"transformer.resblocks.{i}", f"text.blocks.{i}")
        ln("ln_final", "text.ln_final")
        if "text.proj_bias" in f:
            put("text_projection.weight", f["text.proj"].T)
            put("text_projection.bias", f["text.proj_bias"])
        else:
            put("text_projection", f["text.proj"])
        for k in ("logit_scale", "logit_bias"):
            if k in f:
                put(k, f[k])
    elif kind == "merger":
        for i in range(n_of("blocks.{}.ln1.scale")):
            d, s = f"encoder.layers.{i}", f"blocks.{i}"
            ln(f"{d}.norm1", f"{s}.ln1")
            put(f"{d}.self_attn.in_proj_weight", f[f"{s}.attn.qkv.w"].T)
            put(f"{d}.self_attn.in_proj_bias", f[f"{s}.attn.qkv.b"])
            lin(f"{d}.self_attn.out_proj", f"{s}.attn.out")
            ln(f"{d}.norm2", f"{s}.ln2")
            lin(f"{d}.linear1", f"{s}.mlp.fc")
            lin(f"{d}.linear2", f"{s}.mlp.proj")
        lin("head.0", "head.fc")
        lin("head.2", "head.proj")
    else:
        raise ValueError(f"unknown checkpoint kind {kind!r}")
    return sd


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def run_reference(dev) -> dict:
    """tiny-pe pipeline on the card and on the CPU: same map, same
    instances, descriptors within cosine 1e-4."""
    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.models.clip import CLIPModel
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    scene = WallScene(12, 96, 160, 80.0, 80.0, 79.5, 47.5, seed=1, cell=0.8)
    cfg = json.loads(json.dumps(REPLICA_CONFIG))
    cfg["mapping"].update(map_every=2, n_points_capacity=1 << 16)
    # the depth filter's blur weights come from exp(), which rounds
    # differently on the two devices; without it the geometry is exact
    cfg["semantic"].update(segment_every=2, kf_queue_delay=2, track_th=40,
                           depth_filter=False)
    out = {}
    cpu_model = CLIPModel.random_init("tiny-pe", seed=3, device="cpu")
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = cpu_model if d.type == "cpu" else CLIPModel(
            cpu_model.cfg, copy.deepcopy(cpu_model.visual), d)
        with tempfile.TemporaryDirectory() as tmp:
            m = OVOSemMap(json.loads(json.dumps(cfg)), tmp, dataset=scene,
                          mask_source=CallableMaskSource(
                              lambda img, fid: scene.masks(fid), 96, d),
                          embedder=TextRegionEmbedder(model), device=d)
            m.run()
        st = m.slam_backbone.get_map()
        n = int(st.count)
        out[name] = (n, st.obj_ids[:n].cpu().numpy(), m.ovo.active_ids(),
                     m.ovo.store.clip_feature.cpu().numpy(),
                     m.ovo.store.has_clip.cpu().numpy())
    (n1, o1, a1, f1, h1), (n2, o2, a2, f2, h2) = out["cuda"], out["cpu"]
    if n1 != n2 or not np.array_equal(o1, o2) or not np.array_equal(a1, a2):
        raise AssertionError("reference: card and CPU maps differ")
    rows = np.nonzero(h2)[0]
    if len(rows) < 3 or not np.array_equal(h1, h2):
        raise AssertionError("reference: too few or differing descriptors")
    cos = (f1[rows] * f2[rows]).sum(-1) / (
        np.linalg.norm(f1[rows], axis=-1) * np.linalg.norm(f2[rows], axis=-1))
    worst = float(np.abs(cos - 1.0).max())
    if worst > 1e-4:
        raise AssertionError(f"reference: descriptor cosine off by {worst}")
    return dict(points=n1, instances=len(a1), descriptors=len(rows),
                max_cos_dev=worst)


def run_reference_amg(dev, encoder: str = "hiera_test",
                      min_area: int = 0) -> dict:
    """The AMG program (``encoder`` at 256^2, f32, gates at 0) on the card
    (kernels) and on the CPU (plain versions), on a 180 x 320 frame: equal
    valid sets, seg maps and binary maps equal but for < 0.1% of pixels (a
    logit within rounding of 0 flips). The NMS stages leave few valid masks
    on random weights, so the decoder's logits for all grid prompts are
    compared as well. hiera_test (reference_amg): SAM2, B2-B4, its global
    block short enough for B2. vit_test with ``min_area`` 100
    (reference_sam1): SAM1's trunk (no kernel), pad path and host
    small-region pass, its decoder's 7 tokens through B2, B3 (padded to its
    8-token instance in bf16 only) and B4."""
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource
    from ovo_tpu_torch.models.sam.model import SAMModel
    from ovo_tpu_torch.ops import cuda_build

    cpu = SAMModel.random_init(encoder, 256, seed=7, device="cpu",
                               compute_dtype="float32")
    card = SAMModel(cpu.cfg, copy.deepcopy(cpu.params), dev)
    kw = dict(points_per_side=8, max_masks=32, candidates=64,
              gate_prompts=32, pred_iou_thresh=0.0, stability_thresh=0.0,
              nms_score_th=0.0, min_area=min_area)
    rng = np.random.default_rng(7)
    image = (rng.random((180, 320, 3)) * 255).astype(np.uint8)
    out, logits = {}, {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        source = AutomaticMaskSource(model, **kw)
        cuda_build.reset_launch_counts()
        seg, bmaps, valid = source.get_masks(image)
        if name == "cuda":
            launches = {k: v for k, v in cuda_build.launch_counts().items()
                        if v}
        out[name] = (seg.cpu().numpy(), bmaps.cpu().numpy(),
                     valid.cpu().numpy())
        # the decoder's logits for every grid prompt: B2-B4 in context
        x = model.preprocess(torch.from_numpy(image).to(model.device) / 255.0)
        embed, high_res = model.encode_image(x)
        logits[name] = model.decode_grid(embed, high_res, source.points,
                                         mask_channels=(1, 2, 3))["masks"]
    (s1, b1, v1), (s2, b2, v2) = out["cuda"], out["cpu"]
    logit_scale = float(logits["cpu"].abs().max())
    logit_err = float((logits["cuda"].cpu() - logits["cpu"]).abs().max())
    seg_diff, bmap_diff = float((s1 != s2).mean()), float((b1 != b2).mean())
    if not np.array_equal(v1, v2) or v1.sum() < 1:
        raise AssertionError(f"reference_amg {encoder}: valid sets differ "
                             f"or empty ({v1.sum()} / {v2.sum()})")
    if seg_diff >= 1e-3 or bmap_diff >= 1e-3:
        raise AssertionError(f"reference_amg {encoder}: seg maps differ on "
                             f"{seg_diff:.2e} of pixels, masks {bmap_diff:.2e}")
    # f32 sums in another order through the trunk and the decoder: 1.6e-6
    # of the largest logit measured on an H100; the limit is 2e-5 of it
    if logit_err > 2e-5 * max(1.0, logit_scale):
        raise AssertionError(f"reference_amg {encoder}: decoder logits "
                             f"differ by {logit_err} (largest {logit_scale})")
    return dict(encoder=encoder, valid_masks=int(v1.sum()),
                seg_pixels_differing=seg_diff,
                mask_pixels_differing=bmap_diff, logit_max_abs_err=logit_err,
                logit_max_abs=logit_scale, launches=launches)


def _decoder_inputs(rng, side, dtype, dev):
    """A random (side, side, 256) embedding and its high-res features."""
    def rnd(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dev, dtype)

    return rnd(side, side, 256), [rnd(4 * side, 4 * side, 32),
                                  rnd(2 * side, 2 * side, 64)]


def run_reference_decoder(dev, side: int = 80, grid: int = 16) -> dict:
    """``decode_masks`` through each route of the two-way transformer.

    Small: the hiera_test card's decoder (SAM2's: d 256, 8 heads) in f32 on
    a (16, 16) embedding with 16 grid prompts, on the card (B3 / B4, B3 /
    B7 / B8, B9a / B9b / B8) and on the CPU (plain versions): every output
    of every route within 2e-4 of the CPU's unfused route (f32 sums in
    other orders and algebras; 1.1e-5 on logits up to 9.7 on the CPU).

    Full: the same decoder in bf16 at the 1280^2 AMG shape (``grid``^2 =
    256 prompts, L = ``side``^2 = 6400) on the card, each route against the
    unfused one. The routes round
    at different places (B3 rounds q Wk^T and p keys, the unfused route kk
    and vv), a few bf16 steps of 2^-8 through two layers: logits within 5%
    of the largest, iou and object scores within 5e-2. The proj route's
    decode is where kernel B7 launches (the kernels line counts it)."""
    from ovo_tpu_torch.models.sam.amg import grid_points
    from ovo_tpu_torch.models.sam.model import SAMModel
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.ops.decoder_route import ROUTES

    rng = np.random.default_rng(8)
    cpu = SAMModel.random_init("hiera_test", 256, seed=8, device="cpu",
                               compute_dtype="float32")
    card = SAMModel(cpu.cfg, copy.deepcopy(cpu.params), dev)
    embed, hr = _decoder_inputs(rng, 16, torch.float32, "cpu")
    points = torch.from_numpy(grid_points(4))
    keys = ("masks", "iou", "obj_score")
    out, counts = {}, {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        d = model.device
        for route in ROUTES:
            cuda_build.reset_launch_counts()
            res = model.decode_grid(embed.to(d), [h.to(d) for h in hr],
                                    points.to(d), mask_channels=(1, 2, 3),
                                    route=route)
            counts[(name, route)] = cuda_build.launch_counts()
            out[(name, route)] = {k: res[k].cpu() for k in keys}
    ref = out[("cpu", "unfused")]
    small_err = {f"{n}_{r}": max(float((o[k] - ref[k]).abs().max())
                                 for k in keys)
                 for (n, r), o in out.items()}
    if max(small_err.values()) > 2e-4 or not all(
            torch.isfinite(o[k]).all() for o in out.values() for k in keys):
        raise AssertionError(f"reference_decoder: routes differ: {small_err}")
    for route in ROUTES:
        expect = dict.fromkeys(cuda_build.LAUNCH_NAMES, 0)
        expect.update(ROUTE_LAUNCHES[route])
        if counts[("cuda", route)] != expect or set(
                counts[("cpu", route)].values()) != {0}:
            raise AssertionError(f"reference_decoder: {route} launched "
                                 f"{counts[('cuda', route)]}")
    del card, cpu
    # the full shape, bf16, on the card only
    model = SAMModel.random_init("hiera_test", 1280, seed=9, device=dev)
    embed, hr = _decoder_inputs(rng, side, torch.bfloat16, dev)
    points = torch.from_numpy(grid_points(grid)).to(dev)
    full, full_counts, full_ms = {}, {}, {}
    for route in ROUTES:
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.time()
        res = model.decode_grid(embed, hr, points, mask_channels=(1, 2, 3),
                                route=route)
        torch.cuda.synchronize()
        full_ms[route] = (time.time() - t0) * 1e3
        full_counts[route] = cuda_build.launch_counts()
        full[route] = {k: res[k].float() for k in keys}
    ref = full["unfused"]
    scale = float(ref["masks"].abs().max())
    full_err = {r: {k: float((o[k] - ref[k]).abs().max()) for k in keys}
                for r, o in full.items()}
    for route, e in full_err.items():
        expect = dict.fromkeys(cuda_build.LAUNCH_NAMES, 0)
        expect.update(ROUTE_LAUNCHES[route])
        if full_counts[route] != expect:
            raise AssertionError(f"reference_decoder: {route} launched "
                                 f"{full_counts[route]} at the full shape")
        if not all(torch.isfinite(full[route][k]).all() for k in keys) or (
                e["masks"] > 0.05 * scale or e["iou"] > 5e-2
                or e["obj_score"] > 5e-2 * max(1.0, float(
                    ref["obj_score"].abs().max()))):
            raise AssertionError(f"reference_decoder: bf16 routes differ at "
                                 f"the full shape: {full_err} (largest "
                                 f"logit {scale})")
    return dict(small_max_abs_err=small_err, full_max_abs_err=full_err,
                full_logit_max_abs=scale, full_host_ms=full_ms,
                launches_small=counts[("cuda", "proj")],
                launches=full_counts["proj"])


def run_reference_utility(dev) -> dict:
    """The routes to B11 and B13 on the hiera_test card at 256^2, card
    against CPU: the trunk with window_attn="packed" in f32 (every window
    block through B11, the global block of 256 tokens through B10), every
    stage's features within 2e-4; decode_grid(mask_tail="fused") in bf16
    (B13), the logits within 5% of the largest (the decoder's bf16 routes
    round their intermediates on each device's kernels: a few 2^-8 steps
    through two layers, as in reference_decoder)."""
    from ovo_tpu_torch.models.sam.amg import grid_points
    from ovo_tpu_torch.models.sam.hiera import hiera_forward
    from ovo_tpu_torch.models.sam.model import SAMModel
    from ovo_tpu_torch.ops import cuda_build

    rng = np.random.default_rng(12)
    image = torch.from_numpy((rng.random((180, 320, 3)) * 255).astype(
        np.uint8))
    out, counts = {}, {}
    for dtype in ("float32", "bfloat16"):
        cpu = SAMModel.random_init("hiera_test", 256, seed=12, device="cpu",
                                   compute_dtype=dtype)
        card = SAMModel(cpu.cfg, copy.deepcopy(cpu.params), dev)
        embed, hr = _decoder_inputs(rng, 16, cpu.cfg.dtype, "cpu")
        points = torch.from_numpy(grid_points(4))
        for name, model in (("cuda", card), ("cpu", cpu)):
            d = model.device
            cuda_build.reset_launch_counts()
            if dtype == "float32":
                x = model.preprocess(image.to(d).float() / 255.0)
                res = hiera_forward(model.params["trunk"], model.cfg.hiera, x,
                                    window_attn="packed")
            else:
                res = [model.decode_grid(
                    embed.to(d), [h.to(d) for h in hr], points.to(d),
                    mask_channels=(1, 2, 3), mask_tail="fused")["masks"]]
            if d.type == "cuda":
                torch.cuda.synchronize()
            counts[(name, dtype)] = cuda_build.launch_counts()
            out[(name, dtype)] = [r.float().cpu() for r in res]
    trunk_err = max(float((a - b).abs().max()) for a, b in zip(
        out[("cuda", "float32")], out[("cpu", "float32")]))
    (lc,), (lp,) = out[("cuda", "bfloat16")], out[("cpu", "bfloat16")]
    scale = float(lp.abs().max())
    tail_err = float((lc - lp).abs().max())
    n_window = sum(ws > 0 for *_, ws, _ in cpu.cfg.hiera.block_layout())
    tc, dc = counts[("cuda", "float32")], counts[("cuda", "bfloat16")]
    if not all(torch.isfinite(r).all() for rs in out.values() for r in rs):
        raise AssertionError("reference_utility: non-finite outputs")
    if trunk_err > 2e-4 or tail_err > 0.05 * max(scale, 1.0):
        raise AssertionError(f"reference_utility: trunk {trunk_err}, tail "
                             f"{tail_err} (largest logit {scale})")
    if (tc["packed_heads_attention"] != n_window
            or tc["windowed_attention"] != 0 or dc["mask_tail"] != 1
            or any(v for c in (counts[("cpu", "float32")],
                               counts[("cpu", "bfloat16")])
                   for v in c.values())):
        raise AssertionError(f"reference_utility: launches {tc} / {dc}")
    return dict(trunk_max_abs_err=trunk_err, tail_max_abs_err=tail_err,
                tail_logit_max_abs=scale, launches_trunk=tc,
                launches_decode=dc)


def run_utility_path(dev) -> dict:
    """B11, B13 and B14 at full width, each driven by name: the Hiera-L
    trunk at 1024^2 in bf16 with window_attn="packed" against "heads" (45
    B11, 3 B1, 0 B2 against 45 B2, 3 B1); decode_grid at the AMG shape (256
    grid prompts, top_prompts 128) with mask_tail="fused" against
    "unfused" (one B13 launch per fused decode); B14 at its two gated
    shapes. Counts are reset before each run and read after it."""
    from ovo_tpu_torch.models.sam.amg import grid_points
    from ovo_tpu_torch.models.sam.model import SAMModel
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.ops.layer_norm import layer_norm_rows

    model = SAMModel.random_init("hiera_l", 1024, seed=0, device=dev)
    rng = np.random.default_rng(13)
    image = torch.from_numpy((rng.random((680, 1200, 3)) * 255).astype(
        np.uint8)).to(dev)
    x = model.preprocess(image.float() / 255.0)
    feats, counts, host_ms = {}, {}, {}

    def run(tag, fn):
        torch.cuda.synchronize()
        cuda_build.reset_launch_counts()
        t0 = time.time()
        res = fn()
        torch.cuda.synchronize()
        host_ms[tag] = (time.time() - t0) * 1e3
        counts[tag] = cuda_build.launch_counts()
        return res

    for wa in ("heads", "packed", "packed_again"):
        embed, hr = run(wa, lambda: model.encode_image(
            x, window_attn=wa.split("_")[0]))
        feats[wa] = [embed.float()] + [h.float() for h in hr]
    trunk_err = max(float((a - b).abs().max()) for a, b in zip(
        feats["packed"], feats["heads"]))
    points = torch.from_numpy(grid_points(16)).to(dev)
    logits = {}
    for tail in ("unfused", "fused", "fused_again"):
        logits[tail] = run(tail, lambda: model.decode_grid(
            feats["heads"][0].to(model.cfg.dtype),
            [h.to(model.cfg.dtype) for h in feats["heads"][1:]], points,
            mask_channels=(1, 2, 3), top_prompts=SAM_LIVE["gate_prompts"],
            mask_tail=tail.split("_")[0])["masks"])
    scale = float(logits["unfused"].abs().max())
    tail_err = float((logits["fused"] - logits["unfused"]).abs().max())
    gen = torch.Generator(device=dev).manual_seed(14)
    ln_out = run("layer_norm_rows", lambda: [layer_norm_rows(
        torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16),
        torch.ones(shape[1], device=dev), torch.zeros(shape[1], device=dev))
        for shape in B14_SHAPES.values()])
    expect = dict.fromkeys(cuda_build.LAUNCH_NAMES, 0)
    heads_expect = dict(expect, **TRUNK_LAUNCHES)
    packed_expect = dict(expect, flash_attention=3,
                         packed_heads_attention=45)
    dec = {"windowed_attention": 2, "cross_t2i": 3, "cross_i2t_tail": 2}
    if (counts["heads"] != heads_expect or counts["packed"] != packed_expect
            or counts["unfused"] != dict(expect, **dec)
            or counts["fused"] != dict(expect, mask_tail=1, **dec)
            or counts["layer_norm_rows"] != dict(expect, layer_norm_rows=2)):
        raise AssertionError(f"utility_path: launches {counts}")
    # B11 runs B2's device code on the same windows: the features agree to
    # a bf16 step of the largest feature (0 expected); the fused tail rounds
    # its gelu op by op where the unfused one rounds once: within 5% of the
    # largest logit, as the decoder's bf16 routes
    feat_scale = max(float(f.abs().max()) for f in feats["heads"])
    if not all(torch.isfinite(t).all() for t in (
            *feats["packed"], logits["fused"], *ln_out)):
        raise AssertionError("utility_path: non-finite outputs")
    if trunk_err > 2 ** -8 * feat_scale or tail_err > 0.05 * max(scale,
                                                                 1e-3):
        raise AssertionError(f"utility_path: trunk {trunk_err} (largest "
                             f"{feat_scale}), tail {tail_err} (largest "
                             f"logit {scale})")
    return dict(trunk_max_abs_err=trunk_err, feature_max_abs=feat_scale,
                tail_max_abs_err=tail_err, logit_max_abs=scale,
                host_ms=host_ms, launches=counts)


def smoke_siglip_card():
    """SigLIP-structured at test scale: no class token, attention pooling,
    224^2 / 14 = 256 tokens (B10's route), bidirectional text tower over
    64 tokens pooled at the last one (B2's), sigmoid similarity."""
    from ovo_tpu_torch.models.clip import (SIGLIP_MEAN, SIGLIP_STD,
                                           CLIPModelConfig, TextConfig,
                                           ViTConfig)

    return CLIPModelConfig(
        name="smoke-siglip",
        vision=ViTConfig(image_size=224, patch_size=14, width=64, depth=2,
                         n_heads=4, mlp_ratio=3.7362, embed_dim=32,
                         use_cls_token=False, use_abs_pos=True, pool="attn"),
        text=TextConfig(vocab_size=1024, context_length=64, width=64,
                        depth=2, n_heads=4, mlp_ratio=3.7362, embed_dim=32,
                        causal=False, pool="last"),
        mean=SIGLIP_MEAN, std=SIGLIP_STD, siglip=True, clip_dim=32)


def run_reference_crop(dev) -> dict:
    """The crop hovsg embedder (roi crops, B10 in the image tower) builds
    the small scene's map on the card and on the CPU, then
    classify_instances (B2 in the text tower): same map and instances,
    descriptors within cosine 1e-4, classes equal where the top-2 margin is
    above 1e-4."""
    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.models.clip import CLIPModel, CropCLIPEmbedder
    from ovo_tpu_torch.ops import cuda_build

    scene = WallScene(12, 96, 160, 80.0, 80.0, 79.5, 47.5, seed=2, cell=0.8)
    cfg = json.loads(json.dumps(REPLICA_CONFIG))
    cfg["mapping"].update(map_every=2, n_points_capacity=1 << 16)
    cfg["semantic"].update(segment_every=2, kf_queue_delay=2, track_th=40,
                           depth_filter=False)
    base = CLIPModel.random_init(smoke_siglip_card(), seed=4, device="cpu")

    def weights_on(d):
        # one set of weights on each device; logit bias 0 spreads the
        # sigmoid similarities
        return CLIPModel(base.cfg, copy.deepcopy(base.visual), d,
                         text=copy.deepcopy(base.text),
                         logit_scale=float(base.logit_scale), logit_bias=0.0,
                         tokenizer=base.tokenizer)

    out = {}
    cuda_build.reset_launch_counts()
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = weights_on(d)
        with tempfile.TemporaryDirectory() as tmp:
            m = OVOSemMap(json.loads(json.dumps(cfg)), tmp, dataset=scene,
                          mask_source=CallableMaskSource(
                              lambda img, fid: scene.masks(fid), 96, d),
                          embedder=CropCLIPEmbedder(model, "hovsg",
                                                    mask_res=168),
                          device=d)
            m.run()
        st = m.slam_backbone.get_map()
        n = int(st.count)
        sims = m.ovo.query(QUERY_CLASSES, [QUERY_TEMPLATE])
        res = m.ovo.classify_instances(QUERY_CLASSES, QUERY_TEMPLATE)
        out[name] = (n, st.obj_ids[:n].cpu().numpy(), m.ovo.active_ids(),
                     m.ovo.store.clip_feature.cpu().numpy(),
                     m.ovo.store.has_clip.cpu().numpy(), sims, res)
    counts = cuda_build.launch_counts()
    (n1, o1, a1, f1, h1, s1, r1) = out["cuda"]
    (n2, o2, a2, f2, h2, s2, r2) = out["cpu"]
    if n1 != n2 or not np.array_equal(o1, o2) or not np.array_equal(a1, a2):
        raise AssertionError("reference_crop: card and CPU maps differ")
    rows = np.nonzero(h2)[0]
    if len(rows) < 3 or not np.array_equal(h1, h2):
        raise AssertionError("reference_crop: too few or differing "
                             "descriptors")
    cos = (f1[rows] * f2[rows]).sum(-1) / (
        np.linalg.norm(f1[rows], axis=-1) * np.linalg.norm(f2[rows], axis=-1))
    worst = float(np.abs(cos - 1.0).max())
    if worst > 1e-4:
        raise AssertionError(f"reference_crop: descriptor cosine off by "
                             f"{worst}")
    top2 = np.sort(s2, axis=1)
    clear = top2[:, -1] - top2[:, -2] > 1e-4
    if clear.sum() < 1 or not np.array_equal(r1["classes"][clear],
                                             r2["classes"][clear]):
        raise AssertionError(f"reference_crop: classes differ "
                             f"({r1['classes']} / {r2['classes']})")
    if counts["fused_attention"] < 1 or counts["windowed_attention"] < 1:
        raise AssertionError(f"reference_crop: B10 / B2 not launched: "
                             f"{counts}")
    return dict(points=n1, instances=len(a1), descriptors=len(rows),
                max_cos_dev=worst, classes_compared=int(clear.sum()),
                max_sim_abs_err=float(np.abs(s1 - s2).max()),
                launches=counts)


def run_reference_batch(dev) -> dict:
    """SAM micro-batching (``sam.batch: 2``) on the small scene: live
    hiera_test masks (f32, 128^2, gates at 0; the trunk runs once per pair
    of keyframes) and TextRegion on tiny-pe (one tower call per pair), on
    the card and on the CPU with the same weights: equal map and instances,
    descriptors within cosine 1e-4."""
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.models.clip import CLIPModel
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource
    from ovo_tpu_torch.models.sam.model import SAMModel
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    scene = WallScene(12, 96, 160, 80.0, 80.0, 79.5, 47.5, seed=4, cell=0.8)
    cfg = json.loads(json.dumps(REPLICA_CONFIG))
    cfg["mapping"].update(map_every=2, n_points_capacity=1 << 16)
    cfg["semantic"].update(segment_every=2, kf_queue_delay=2, track_th=40,
                           depth_filter=False)
    cfg["semantic"]["sam"] = {"precomputed": False, "batch": 2}
    amg_kw = dict(points_per_side=4, max_masks=16, candidates=32,
                  gate_prompts=12, pred_iou_thresh=0.0, stability_thresh=0.0,
                  nms_score_th=0.0)
    cpu_sam = SAMModel.random_init("hiera_test", 128, seed=5, device="cpu",
                                   compute_dtype="float32")
    cpu_clip = CLIPModel.random_init("tiny-pe", seed=3, device="cpu")
    out = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        sam, clip = cpu_sam, cpu_clip
        if d.type == "cuda":
            sam = SAMModel(cpu_sam.cfg, copy.deepcopy(cpu_sam.params), d)
            clip = CLIPModel(cpu_clip.cfg, copy.deepcopy(cpu_clip.visual), d)
        source = RecordingMaskSource(AutomaticMaskSource(sam, **amg_kw))
        embedder = CountingEmbedder(TextRegionEmbedder(clip))
        with tempfile.TemporaryDirectory() as tmp:
            m = OVOSemMap(json.loads(json.dumps(cfg)), tmp, dataset=scene,
                          mask_source=source, embedder=embedder, device=d)
            m.run()
        st = m.slam_backbone.get_map()
        n = int(st.count)
        out[name] = (n, st.obj_ids[:n].cpu().numpy(), m.ovo.active_ids(),
                     m.ovo.store.clip_feature.cpu().numpy(),
                     m.ovo.store.has_clip.cpu().numpy(), source.batches,
                     embedder.tower_calls, m.ovo.kf_id)
    (n1, o1, a1, f1, h1, b1, t1, k1) = out["cuda"]
    (n2, o2, a2, f2, h2, b2, t2, k2) = out["cpu"]
    if n1 != n2 or not np.array_equal(o1, o2) or not np.array_equal(a1, a2):
        raise AssertionError("reference_batch: card and CPU maps differ")
    if b1 != b2 or b1 != [2, 2, 2] or t1 != t2 or k1 != k2:
        raise AssertionError(f"reference_batch: batches {b1} / {b2}, tower "
                             f"calls {t1} / {t2}")
    rows = np.nonzero(h2)[0]
    if len(rows) < 1 or not np.array_equal(h1, h2):
        raise AssertionError("reference_batch: too few or differing "
                             "descriptors")
    cos = (f1[rows] * f2[rows]).sum(-1) / (
        np.linalg.norm(f1[rows], axis=-1) * np.linalg.norm(f2[rows], axis=-1))
    worst = float(np.abs(cos - 1.0).max())
    if worst > 1e-4:
        raise AssertionError(f"reference_batch: descriptor cosine off by "
                             f"{worst}")
    return dict(points=n1, instances=len(a1), descriptors=len(rows),
                keyframes=k1, batches=b1, tower_calls=t1, max_cos_dev=worst)


def run_checkpoint(dev) -> dict:
    """Checkpoints through the normal factories: seeded random weights at
    full width, laid out under the official keys (official_state_dict) and
    written with torch.save to a temporary directory --
    sam_vit_h_4b8939.pth through build_sam_mask_source, a PE-Core-L14-336
    open_clip checkpoint through build_clip_embedder(..., "TextRegion"), a
    merger model.pt through load_merger. Each loaded model's output (one
    keyframe's masks, its descriptors and two text embeddings, the fused
    descriptors of 96 masks) equals, bit for bit, that of the same tree
    carried in by from_jax_params. Per file: bytes, write seconds,
    load-and-convert seconds."""
    from ovo_tpu_torch.models.clip import CLIPModel, build_clip_embedder
    from ovo_tpu_torch.models.convert_jax import merger_from_jax_params
    from ovo_tpu_torch.models.merger import init_merger, load_merger
    from ovo_tpu_torch.models.sam.amg import build_sam_mask_source
    from ovo_tpu_torch.models.sam.model import SAMModel

    scene = replica_wall_scene(1)
    image = scene[0][1]
    _, masks = scene.masks(0)
    masks = torch.from_numpy(masks).to(dev)
    valid = masks.any(dim=(1, 2))
    card, merger_width = "PE-Core-L14-336", 1152
    clip_cfg = dict(REPLICA_CONFIG["semantic"]["clip"], model_card=card)
    record = {}

    def save(name, sd, path):
        t0 = time.time()
        torch.save(sd, path)
        record[name] = dict(bytes=os.path.getsize(path),
                            write_s=time.time() - t0)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def load(name, fn):
        sync()
        t0 = time.time()
        out = fn()
        sync()
        record[name]["load_and_convert_s"] = time.time() - t0
        return out

    def same(name, got, ref):
        got = got if isinstance(got, (tuple, list)) else (got,)
        ref = ref if isinstance(ref, (tuple, list)) else (ref,)
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"checkpoint {name}: the loaded model's "
                                 f"output differs from the tree's")
        record[name]["bit_equal"] = True

    with tempfile.TemporaryDirectory() as tmp:
        flat = flat_params(SAMModel.random_init("vit_h", 1024, seed=11,
                                                device=dev).params)
        save("sam_vit_h", {"model": official_state_dict("sam1", flat)},
             os.path.join(tmp, "sam_vit_h_4b8939.pth"))
        src = load("sam_vit_h", lambda: build_sam_mask_source(
            dict(SAM1_LIVE, sam_ckpt_path=tmp), device=dev))
        ref = copy.copy(src)
        ref.model = SAMModel.from_jax_params("vit_h", 1024,
                                             nest_params(flat), device=dev)
        del flat
        got = src.get_masks(image, 0)
        same("sam_vit_h", got, ref.get_masks(image, 0))
        record["sam_vit_h"]["valid_masks"] = int(got[2].sum())
        del src, ref, got
        gc.collect()
        torch.cuda.empty_cache()

        model = CLIPModel.random_init(card, seed=12, device=dev)
        flat = {**flat_params(model.visual, "visual."),
                **flat_params(model.text, "text."),
                "logit_scale": model.logit_scale.cpu().numpy()}
        del model
        path = os.path.join(tmp, "open_clip_pytorch_model.bin")
        save("pe_core_l14_336", official_state_dict("clip", flat), path)
        emb = load("pe_core_l14_336", lambda: build_clip_embedder(
            dict(clip_cfg, ckpt_path=path), "TextRegion", device=dev))
        ref = copy.copy(emb)
        ref.model = CLIPModel.from_jax_params(card, nest_params(flat),
                                              device=dev)
        del flat
        texts = ["a chair", "a wall"]
        same("pe_core_l14_336",
             (emb.embed_masks(image, masks, valid), emb.embed_text(texts)),
             (ref.embed_masks(image, masks, valid), ref.embed_text(texts)))
        del emb, ref
        gc.collect()
        torch.cuda.empty_cache()

        gen = torch.Generator(device=dev).manual_seed(13)
        flat = flat_params(init_merger(gen, d_model=merger_width,
                                       device=dev))
        save("merger", official_state_dict("merger", flat),
             os.path.join(tmp, "model.pt"))
        merger = load("merger", lambda: load_merger(tmp, device=dev))
        ref = merger_from_jax_params(nest_params(flat), dev)
        clips = torch.nn.functional.normalize(torch.randn(
            (96, 3, merger_width), generator=gen, device=dev), dim=-1)
        same("merger", merger(clips), ref(clips))
    return record


def _kernel_names() -> set:
    """The __global__ function names of the port's CUDA sources."""
    import re
    from pathlib import Path

    csrc = Path(__file__).resolve().parent / "ovo_tpu_torch" / "csrc"
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)\s*\(")
    return {m for f in csrc.glob("*.cu*") for m in pat.findall(f.read_text())}


class RecordingMaskSource:
    """Passes ``get_masks`` and ``get_masks_batch`` through and keeps each
    keyframe's valid-mask count as a device tensor (read after the run: no
    host sync), and each batch's size."""

    def __init__(self, source):
        self.source = source
        self.valid_counts = []
        self.batches = []

    def get_masks(self, image, frame_id=None):
        seg, bmaps, valid = self.source.get_masks(image, frame_id)
        self.valid_counts.append(valid.sum())
        return seg, bmaps, valid

    def get_masks_batch(self, images, frame_ids):
        seg, bmaps, valid = self.source.get_masks_batch(images, frame_ids)
        self.valid_counts.extend(valid.sum(dim=1).unbind())
        self.batches.append(len(images))
        return seg, bmaps, valid


class CountingEmbedder:
    """Counts the embedder's tower calls (one per ``embed_masks``, one per
    ``embed_masks_batch``), passing everything through."""

    def __init__(self, embedder):
        self.embedder = embedder
        self.tower_calls = 0

    def __getattr__(self, name):
        return getattr(self.embedder, name)

    def embed_masks(self, *args):
        self.tower_calls += 1
        return self.embedder.embed_masks(*args)

    def embed_masks_batch(self, *args):
        self.tower_calls += 1
        return self.embedder.embed_masks_batch(*args)


# the seeded 680x1200 wall scene of the slices, built once per process (its
# set-up is the smoke's largest host cost): a run of fewer frames takes the
# first frames of the scene built
_WALL_SCENES = []


def replica_wall_scene(frames: int) -> WallScene:
    if not _WALL_SCENES or len(_WALL_SCENES[0]) < frames:
        cam = REPLICA_CONFIG["cam"]
        _WALL_SCENES[:] = [WallScene(frames, cam["H"], cam["W"], cam["fx"],
                                     cam["fy"], cam["cx"], cam["cy"], seed=0)]
    return _WALL_SCENES[0].head(frames)


def _validity_read_sites() -> set:
    """The lines of the micro-batch flush's validity read
    (``semantic.keyframe_has_mask``), as the sync report names them
    (file:line in ovo_tpu_torch)."""
    import inspect

    from ovo_tpu_torch.mapping.semantic import keyframe_has_mask

    lines, first = inspect.getsourcelines(keyframe_has_mask)
    return {f"mapping/semantic.py:{n}"
            for n in range(first, first + len(lines))}


def _small_region_sites() -> set:
    """The lines of the SAM1 AMG's small-region host pass
    (``AutomaticMaskSource._small_regions``: the masks read to the host,
    the fixed ones staged back), as the sync report names them."""
    import inspect

    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource

    lines, first = inspect.getsourcelines(AutomaticMaskSource._small_regions)
    return {f"models/sam/amg.py:{n}"
            for n in range(first, first + len(lines))}


def _orb_sync_sites() -> set:
    """The ORB tier's host reads, as the sync report names them: the map's
    count after each tracker keyframe's insert (``orbslam.map_count``) and
    loop closure's two reads (``loop_closure._read_gates``,
    ``_read_overlaps``)."""
    import inspect

    from ovo_tpu_torch.mapping import loop_closure
    from ovo_tpu_torch.slam import orbslam

    sites = set()
    for fn, path in ((orbslam.map_count, "slam/orbslam.py"),
                     (loop_closure._read_gates, "mapping/loop_closure.py"),
                     (loop_closure._read_overlaps,
                      "mapping/loop_closure.py")):
        lines, first = inspect.getsourcelines(fn)
        sites |= {f"{path}:{n}" for n in range(first, first + len(lines))}
    return sites


def orb_slam_config() -> dict:
    """configs/ovo.yaml's slam section for Replica, read through the port's
    config chain: the orbslam backbone with configs/slam/orbslam/
    replica.yaml's gates."""
    from pathlib import Path

    from ovo_tpu_torch.config import assemble_run_config

    cfg = assemble_run_config(Path(__file__).resolve().parent / "configs",
                              "Replica", "smoke0")
    if not cfg["slam"]["slam_module"].startswith("orbslam"):
        raise AssertionError(f"configs/ovo.yaml's backbone is "
                             f"{cfg['slam']['slam_module']}")
    return cfg["slam"]


# a loop-closure pair is near a gate when its centroid distance or its
# descriptors' cosine lies within this of th_centroid / th_cossim
NEAR_GATE = 1e-5


class OrbProbe:
    """While active, records the ORB tier's work in ``sem_map``'s run with no
    host read of the card: each tracker call's state and host time, each
    ``update_map`` and ``_rebuild_map`` (host time, and stream time between
    CUDA events read after the run), each loop closure's fused pairs, the
    store's active ids around it and its gates' inputs, and each keyframe
    cull's dropped descriptor records."""

    def __init__(self, sem_map):
        self.sem_map = sem_map
        self.states, self.track_s = [], []
        self.spans = {"update_map": [], "rebuild_map": []}
        self.closures, self.gates, self.dropped = [], [], []

    def _timed(self, obj, name, key):
        inner = getattr(obj, name)
        spans = self.spans[key]

        def timed(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            t0 = time.time()
            out = inner(*a, **kw)
            ev[1].record()
            spans.append((time.time() - t0, ev))
            return out

        setattr(obj, name, timed)

    def __enter__(self):
        from ovo_tpu_torch.mapping import loop_closure, semantic

        backbone, ovo = self.sem_map.slam_backbone, self.sem_map.ovo
        tracker = backbone.tracker
        process = tracker.process_image_rgbd

        def track(*a, **kw):
            t0 = time.time()
            state = process(*a, **kw)
            self.track_s.append(time.time() - t0)
            self.states.append(state)
            return state

        tracker.process_image_rgbd = track
        self._timed(ovo, "update_map", "update_map")
        self._timed(backbone, "_rebuild_map", "rebuild_map")
        drop = ovo.drop_keyframes

        def drop_keyframes(culled):
            before = len(ovo.kf_descriptors)
            drop(culled)
            self.dropped.append((len(culled), before - len(ovo.kf_descriptors)))

        ovo.drop_keyframes = drop_keyframes
        self.saved = (semantic.semantic_loop_closure,
                      loop_closure._gate_and_sample)
        closure, gate_fn = self.saved

        def semantic_loop_closure(map_state, store, *a, **kw):
            out = closure(map_state, store, *a, **kw)
            self.closures.append((dict(out[2]), store.active,
                                  out[1].active))
            return out

        def gate_and_sample(map_state, store, th_centroid, th_cossim):
            out = gate_fn(map_state, store, th_centroid, th_cossim)
            self.gates.append((out, store.has_clip, th_centroid, th_cossim))
            return out

        semantic.semantic_loop_closure = semantic_loop_closure
        loop_closure._gate_and_sample = gate_and_sample
        return self

    def __exit__(self, *exc):
        from ovo_tpu_torch.mapping import loop_closure, semantic

        semantic.semantic_loop_closure, loop_closure._gate_and_sample = \
            self.saved

    def near_gate_pairs(self) -> list:
        """Per loop closure, the candidate pairs (i < j, both alive and
        described) within NEAR_GATE of the centroid or the cosine gate."""
        out = []
        for (_, centroids, alive, _, cos), has, th_c, th_s in self.gates:
            live = alive & has
            dist = torch.cdist(centroids.double(), centroids.double())
            near = ((dist - th_c).abs() <= NEAR_GATE) | (
                (cos.double() - th_s).abs() <= NEAR_GATE)
            ids = torch.arange(len(live), device=live.device)
            near &= live[:, None] & live[None, :] & (
                ids[:, None] < ids[None, :])
            out.append({tuple(p) for p in near.nonzero().tolist()})
        return out

    def record(self) -> dict:
        """The probe's numbers (reads the card: call after the run)."""
        torch.cuda.synchronize()
        backbone = self.sem_map.slam_backbone
        kfs = backbone.tracker.get_keyframes()

        def ms(key):
            host = [s * 1e3 for s, _ in self.spans[key]]
            stream = [ev[0].elapsed_time(ev[1]) for _, ev in self.spans[key]]
            return dict(calls=len(host), host_ms=host, stream_ms=stream)

        removed = [int((before & ~after).sum()) - len(fused)
                   for fused, before, after in self.closures]
        return dict(
            tracker_frames=len(self.states),
            tracker_ms_per_frame_median=statistics.median(self.track_s) * 1e3,
            tracker_ms_per_frame_mean=statistics.mean(self.track_s) * 1e3,
            tracker_states=sorted(set(self.states)),
            big_changes=backbone.last_big_change,
            tracker_keyframes=len(kfs),
            culled_keyframes=sorted(int(round(f)) for f, _, c in kfs if c),
            mapped_keyframes=sorted(backbone.kfs),
            update_map=ms("update_map"), rebuild_map=ms("rebuild_map"),
            fused=[sorted(f.items()) for f, _, _ in self.closures],
            instances_fused=sum(len(f) for f, _, _ in self.closures),
            instances_removed=sum(removed),
            culled_descriptor_records_dropped=sum(d for _, d in self.dropped),
            pairs_near_gate=[len(p) for p in self.near_gate_pairs()])

    def check(self, tag: str) -> None:
        """The ORB path's gates: the tracker OK on every frame, a big change
        followed through update_map, a culled keyframe's descriptors
        dropped and its block gone, the blocks a disjoint ascending
        partition of [0, count)."""
        from ovo_tpu_torch.slam.orbslam import STATE_OK

        backbone = self.sem_map.slam_backbone
        culled = {int(round(f)) for f, _, c in backbone.tracker.get_keyframes()
                  if c}
        if set(self.states) != {STATE_OK}:
            raise AssertionError(f"{tag}: tracker states {self.states}")
        if backbone.last_big_change < 1 or not self.spans["update_map"] \
                or not self.spans["rebuild_map"]:
            raise AssertionError(f"{tag}: no loop closure followed: big "
                                 f"changes {backbone.last_big_change}")
        if not culled or culled & set(backbone.kf_blocks) \
                or not sum(d for _, d in self.dropped):
            raise AssertionError(f"{tag}: culled keyframes {culled}, "
                                 f"dropped {self.dropped}")
        end = 0
        for blk in backbone.kf_blocks.values():
            if blk["range"][0] != end or blk["range"][1] < end:
                raise AssertionError(f"{tag}: block table "
                                     f"{backbone.kf_blocks}")
            end = blk["range"][1]
        if end != int(backbone.get_map().count):
            raise AssertionError(f"{tag}: blocks end at {end}, count "
                                 f"{int(backbone.get_map().count)}")


# the gaussian_slice's frames, the 60-frame wall's first: mapped 0, 5, 10
# (frame 0 the new submap's 1000 iterations), segmented 0 and 10, frames
# 2-10 tracked by rendering
GAUSSIAN_FRAMES = 11


# the tracked poses' largest distance from GT: on the wall's 4 cm steps the
# odometry and the render tracker held 1.2 mm to 5.0 cm over five card runs
# (one settled 5 cm off from its second tracked frame on: the card's
# atomics reorder the map's Adam run, which is chaotic); a tracker that
# loses the wall drifts past a metre in ten frames (PERF.md's findings)
GAUSSIAN_POSE_M = 0.2


def gaussian_slam_config() -> dict:
    """The slam, mapping and tracking sections of the Gaussian-SLAM tier
    for Replica: configs/slam/gaussian_slam/replica.yaml read through the
    port's config chain (capacity 2^20, k_per_tile 64, 1000 / 100 mapping
    and 60 tracking iterations, odometry init)."""
    from pathlib import Path

    from ovo_tpu_torch.config import assemble_run_config

    cfg = assemble_run_config(Path(__file__).resolve().parent / "configs",
                              "Replica", "smoke0",
                              {"slam": {"slam_module": "gaussian_slam"}})
    return {k: cfg[k] for k in ("slam", "mapping", "tracking")}


def _gaussian_sync_sites() -> set:
    """The Gaussian-SLAM tier's host reads (``ops/splat.read_host``: the
    tracker's two a frame, the mapper's pair totals and overflow checks,
    the K escalation's), as the sync report names them."""
    import inspect

    from ovo_tpu_torch.ops import splat

    lines, first = inspect.getsourcelines(splat.read_host)
    return {f"ops/splat.py:{n}" for n in range(first, first + len(lines))}


# the modules that import splat.read_host by name
_READ_HOST_USERS = ("ovo_tpu_torch.ops.splat",
                    "ovo_tpu_torch.slam.gaussian.mapper",
                    "ovo_tpu_torch.slam.gaussian.tracker")


class GaussianProbe:
    """While active, records the Gaussian-SLAM backbone's work in
    ``sem_map``'s run: host time of each ``track_camera`` and ``map`` call
    (each ends in a host read, so the card's work is inside), of each
    ``track_pose`` and of the odometry, and each host read by its caller
    and frame."""

    def __init__(self, sem_map):
        self.sem_map = sem_map
        self.track, self.maps, self.track_pose = [], [], []
        self.odometry_ms = []
        self.reads = collections.Counter()
        self.reads_per_call = {"track": [], "map": []}

    def _wrap_calls(self, obj, name, log, kind):
        inner = getattr(obj, name)

        def timed(*a, **kw):
            n0 = sum(self.reads.values())
            t0 = time.time()
            out = inner(*a, **kw)
            log.append(((time.time() - t0) * 1e3, a[0][0]))
            if kind:
                self.reads_per_call[kind].append(
                    sum(self.reads.values()) - n0)
            return out

        setattr(obj, name, timed)

    def __enter__(self):
        import importlib

        from ovo_tpu_torch.slam.gaussian import backbone as gb

        bb = self.sem_map.slam_backbone
        self._wrap_calls(bb, "track_camera", self.track, "track")
        self._wrap_calls(bb, "map", self.maps, "map")
        if bb.odometer is not None:
            est = bb.odometer.estimate_rel_pose

            def odometry(*a):
                t0 = time.time()
                out = est(*a)
                self.odometry_ms.append((time.time() - t0) * 1e3)
                return out

            bb.odometer.estimate_rel_pose = odometry
        self.saved = [(gb, "track_pose", gb.track_pose)]
        inner = gb.track_pose

        def track_pose(*a, **kw):
            t0 = time.time()
            res = inner(*a, **kw)
            self.track_pose.append(((time.time() - t0) * 1e3, res.init_loss,
                                    res.loss, res.pair_cap))
            return res

        gb.track_pose = track_pose
        for name in _READ_HOST_USERS:
            mod = importlib.import_module(name)
            read = mod.read_host
            self.saved.append((mod, "read_host", read))

            def counted(*ts, _read=read):
                self.reads[sys._getframe(1).f_code.co_name] += 1
                return _read(*ts)

            mod.read_host = counted
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def record(self, scene) -> dict:
        """The probe's numbers and the run's gates: the odometry built, at
        least 8 frames through track_pose and 2 mapped keyframes, every
        state tensor on the card, every pose finite and within
        GAUSSIAN_POSE_M of GT (read after the run)."""
        bb = self.sem_map.slam_backbone
        if bb.odometer is None:
            raise AssertionError("gaussian_slice: the odometry did not build")
        off = [k for k, v in bb.state.tensors().items()
               if v.device.type != "cuda"]
        if off or bb.K.device.type != "cuda":
            raise AssertionError(f"gaussian_slice: state off the card: {off}")
        if len(self.track_pose) < 8 or len(bb.kfs) < 2:
            raise AssertionError(f"gaussian_slice: {len(self.track_pose)} "
                                 f"tracked frames, {len(bb.kfs)} keyframes")
        err = []
        for fid, c2w in sorted(bb.estimated_c2ws.items()):
            if not np.isfinite(c2w).all():
                raise AssertionError(f"gaussian_slice: pose {fid} not finite")
            err.append(float(np.linalg.norm(c2w[:3, 3]
                                             - scene.poses[fid][:3, 3])))
        if max(err) > GAUSSIAN_POSE_M:
            raise AssertionError(f"gaussian_slice: poses off GT by {err}")
        tracked = [ms for ms, fid in self.track if fid >= 2]
        maps = dict((fid, ms) for ms, fid in self.maps)
        return dict(
            tracked_frames=len(self.track_pose),
            tracker_ms_per_frame_median=statistics.median(tracked),
            tracker_ms_per_frame=tracked,
            track_pose_ms=[r[0] for r in self.track_pose],
            track_init_loss=[r[1] for r in self.track_pose],
            track_best_loss=[r[2] for r in self.track_pose],
            odometry_ms_median=statistics.median(self.odometry_ms),
            mapped_keyframes=sorted(maps),
            mapper_ms_frame0=maps[0],
            mapper_ms_per_keyframe={k: v for k, v in maps.items() if k},
            live_gaussians=int(bb.state.valid.sum()),
            gaussian_capacity=bb.state.capacity,
            k_per_tile_used=bb.cfg.k_per_tile,
            pair_buffer=bb._pair_cap,
            host_reads_by_caller=dict(self.reads),
            host_reads_per_tracked_frame=self.reads_per_call["track"],
            host_reads_per_mapped_keyframe=self.reads_per_call["map"],
            pose_error_m=err, pose_error_m_max=max(err))


def render_times(bb) -> dict:
    """One render of the backbone's final map at the last keyframe's view,
    forward and forward + backward (a seeded linear functional of color,
    depth and alpha, gradients to all five render inputs): CUDA-event ms,
    median of 10 after 3 warm-up calls."""
    from ovo_tpu_torch.ops.splat import render_gaussians

    st, w2c = bb.state, bb._kf_w2cs[-1]
    hw = tuple(bb._kf_depths[-1].shape)
    gen = torch.Generator(st.device).manual_seed(0)
    weights = [torch.randn(hw + s, generator=gen, device=st.device)
               for s in ((3,), (), ())]
    inputs = [st.xyz, st.scales(), st.quats, st.opacity(), st.colors()]
    kw = dict(img_hw=hw, k_per_tile=bb.cfg.k_per_tile, pair_cap=bb._pair_cap)

    def forward():
        with torch.no_grad():
            return render_gaussians(*inputs, st.valid, w2c, bb.K, **kw)

    def forward_backward():
        params = [x.detach().requires_grad_(True) for x in inputs]
        out = render_gaussians(*params, st.valid, w2c, bb.K, **kw)
        f = sum((y * w).sum() for y, w in zip(
            (out.color, out.depth, out.alpha), weights))
        return torch.autograd.grad(f, params)

    n_pairs = int(forward().n_pairs)
    return dict(render_fwd_ms=time_ms(forward, 3, 10),
                render_fwd_bwd_ms=time_ms(forward_backward, 3, 10),
                render_pairs=n_pairs, render_hw=list(hw),
                render_k_per_tile=bb.cfg.k_per_tile)


# reference_gaussian's backbone knobs and limits. The card sums the
# render's gathers' gradients with atomic adds (another order on every
# run): gradients within REF_GAUSSIAN_GRAD of the largest. A whole run is
# chaotic: Adam moves a parameter whose gradient sits at rounding level a
# full step either way, the map's parameters part after a few iterations,
# and later keyframes' seeding gates and the tracker read renders of them;
# on this 96 x 160 wall the tracker also loses the camera (0.6 m off GT by
# the last frame, on the card and on the CPU), so the runs' poses part as
# their drifts do. Measured (PERF.md's findings): the CPU run against
# itself with its mapped colours moved by 1e-6, 3e-6 and 1e-5
# (run_reference_gaussian(cpu, perturb=...)) and three card runs against
# the CPU part by up to 4.3% in live gaussians, 16.3 cm in pose and 12% in
# instances; the outcome limits are about twice that. The parts that are
# not chaotic are held tightly: a render, the frame-0 map (seeded before
# any render) and one track_pose call on one map from one pose.
REF_GAUSSIAN = {
    "mapping": {"map_every": 2, "iterations": 20,
                "new_submap_iterations": 100, "n_gaussians_capacity": 1 << 14,
                "max_seeds": 1024, "new_submap_points_num": 6144,
                "keyframe_window": 3, "k_per_tile": 32},
    "tracking": {"iterations": 20},
}
REF_GAUSSIAN_GRAD = 1e-4
REF_GAUSSIAN_LIMITS = {"live_share": 0.1, "pose_m": 0.35,
                       "instances_share": 0.25, "track_pose_m": 1e-4}


def _ref_gaussian_render(cpu, dev):
    """One render of the CPU run's map at its last keyframe's view on the
    card and on the CPU: the largest output difference and the largest
    gradient difference over the largest gradient."""
    from ovo_tpu_torch.ops.splat import render_gaussians

    st = cpu.state
    inputs = [st.xyz, st.scales(), st.quats, st.opacity(), st.colors()]
    hw = tuple(cpu._kf_depths[-1].shape)
    gen = np.random.default_rng(0)
    weights = [gen.standard_normal(hw + s).astype(np.float32)
               for s in ((3,), (), ())]
    outs = []
    for d in (dev, torch.device("cpu")):
        params = [x.detach().to(d).requires_grad_(True) for x in inputs]
        out = render_gaussians(*params, st.valid.to(d),
                               cpu._kf_w2cs[-1].to(d), cpu.K.to(d),
                               img_hw=hw, k_per_tile=cpu.cfg.k_per_tile)
        f = sum((y * torch.from_numpy(w).to(d)).sum() for y, w in zip(
            (out.color, out.depth, out.alpha), weights))
        grads = torch.autograd.grad(f, params)
        outs.append(([y.detach().cpu() for y in out[:3]],
                     [g.cpu() for g in grads]))
    return (max(float((a - b).abs().max())
                for a, b in zip(outs[0][0], outs[1][0])),
            max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(outs[0][1], outs[1][1])))


def _ref_gaussian_track(cpu, scene, dev, perturb):
    """track_pose on the CPU run's map against the last frame from its GT
    pose moved 2 cm, on the card and on the CPU (the latter's colours moved
    by ``perturb``): the largest difference of the two w2c."""
    from ovo_tpu_torch.slam.gaussian.tracker import track_pose

    fid, image, depth, c2w = scene[len(scene) - 1]
    c2w = c2w.copy()
    c2w[0, 3] += 0.02
    w2c = np.linalg.inv(c2w).astype(np.float32)
    res = []
    for d, eps in ((dev, 0.0), (torch.device("cpu"), perturb)):
        img = image / np.float32(255) + np.float32(eps) * np.random \
            .default_rng(fid).standard_normal(image.shape).astype(np.float32)
        st = cpu.state._replace(**{k: v.to(d) for k, v in
                                   cpu.state.tensors().items()})
        res.append(track_pose(st, torch.from_numpy(img).to(d),
                              torch.from_numpy(depth).to(d),
                              torch.from_numpy(w2c).to(d), cpu.K.to(d),
                              img_hw=depth.shape, iters=cpu.track_iters,
                              color_w=cpu.track_color_w,
                              depth_w=cpu.track_depth_w,
                              lr_q=cpu.track_lr_q, lr_t=cpu.track_lr_t,
                              k_per_tile=cpu.cfg.k_per_tile))
    return float(np.abs(res[0].w2c - res[1].w2c).max())


def run_reference_gaussian(dev, perturb: float = 0.0) -> dict:
    """OVOSemMap with the gaussian_slam backbone (configs/slam/
    gaussian_slam/replica.yaml's tracking section: odometry init; small
    mapping knobs, REF_GAUSSIAN) on the run_reference's 12-frame 96 x 160
    wall of varying depth with the tiny-pe card, on the card (kernels) and
    on the CPU (plain versions). Held: one render of the CPU run's map
    (color, depth, alpha within 2e-4; the gradients of a linear functional
    of them to all five inputs within REF_GAUSSIAN_GRAD of the largest);
    the frame-0 map's live slots equal; track_pose on one map from one
    pose within REF_GAUSSIAN_LIMITS["track_pose_m"]; the runs' keyframes
    and tracked frames equal, live counts, poses and instance counts
    within REF_GAUSSIAN_LIMITS. ``perturb`` moves the CPU run's mapped
    colours (and the CPU track_pose's) by that much: run with the card
    device set to the CPU, it measures the CPU run's own spread."""
    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.models.clip import CLIPModel
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    scene = WallScene(12, 96, 160, 80.0, 80.0, 79.5, 47.5, seed=1, cell=0.8)
    cfg = json.loads(json.dumps(REPLICA_CONFIG))
    gcfg = gaussian_slam_config()
    cfg["slam"] = gcfg["slam"]
    for key in ("mapping", "tracking"):
        cfg[key] = dict(gcfg[key], **REF_GAUSSIAN[key])
    cfg["semantic"].update(segment_every=2, kf_queue_delay=2, track_th=40,
                           depth_filter=False)
    runs, first_maps = {}, {}
    cpu_model = CLIPModel.random_init("tiny-pe", seed=3, device="cpu")
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        model = cpu_model if name == "cpu" else CLIPModel(
            cpu_model.cfg, copy.deepcopy(cpu_model.visual), d)
        with tempfile.TemporaryDirectory() as tmp:
            m = OVOSemMap(json.loads(json.dumps(cfg)), tmp, dataset=scene,
                          mask_source=CallableMaskSource(
                              lambda img, fid: scene.masks(fid), 96, d),
                          embedder=TextRegionEmbedder(model), device=d)
            bb = m.slam_backbone
            inner = bb.map
            eps = perturb if name == "cpu" else 0.0

            def mapped(fd, c2w, inner=inner, eps=eps, bb=bb, name=name):
                fd = list(fd)
                fd[1] = fd[1] / np.float32(255) + np.float32(eps) * np.random \
                    .default_rng(fd[0]).standard_normal(
                        fd[1].shape).astype(np.float32)
                inner(fd, c2w)
                first_maps.setdefault(name, bb.state.valid.cpu().numpy())

            bb.map = mapped
            m.run()
        runs[name] = m
    card, cpu = runs["cuda"].slam_backbone, runs["cpu"].slam_backbone
    if card.odometer is None or cpu.odometer is None:
        raise AssertionError("reference_gaussian: no odometry")
    render_err, grad_err = _ref_gaussian_render(cpu, dev)
    counts = [int(b.state.valid.sum()) for b in (card, cpu)]
    frames = sorted(cpu.estimated_c2ws)
    pose_diff = [float(np.abs(card.estimated_c2ws[k][:3, 3]
                              - cpu.estimated_c2ws[k][:3, 3]).max())
                 for k in frames]
    n_ids = [len(r.ovo.active_ids()) for r in (runs["cuda"], runs["cpu"])]
    rec = dict(render_max_abs_err=render_err,
               grad_max_err_of_largest=grad_err,
               frame0_live=[int(v.sum()) for v in first_maps.values()],
               track_pose_max_abs_diff=_ref_gaussian_track(cpu, scene, dev,
                                                           perturb),
               live_gaussians=counts, pose_abs_diff_m=pose_diff,
               instances=n_ids, keyframes=sorted(cpu.kfs),
               k_per_tile=[card.cfg.k_per_tile, cpu.cfg.k_per_tile],
               pose_error_vs_gt_m=max(
                   float(np.linalg.norm(c2w[:3, 3] - scene.poses[k][:3, 3]))
                   for k, c2w in cpu.estimated_c2ws.items()),
               limits=dict(REF_GAUSSIAN_LIMITS, grad=REF_GAUSSIAN_GRAD),
               perturb=perturb)
    lim = REF_GAUSSIAN_LIMITS
    bad = [render_err > 2e-4, grad_err > REF_GAUSSIAN_GRAD,
           not np.array_equal(first_maps["cuda"], first_maps["cpu"]),
           rec["track_pose_max_abs_diff"] > lim["track_pose_m"],
           sorted(card.estimated_c2ws) != frames or len(frames) < 10,
           sorted(card.kfs) != sorted(cpu.kfs),
           abs(counts[0] - counts[1]) > lim["live_share"] * counts[1],
           max(pose_diff) > lim["pose_m"], min(n_ids) < 3,
           abs(n_ids[0] - n_ids[1]) > lim["instances_share"] * n_ids[1]]
    if any(bad):
        raise AssertionError(f"reference_gaussian: gates {bad}: {rec}")
    return rec


def run_slice(dev, profile_path=None, live=False, frames=60, clip=None,
              image_size=1024, sam_batch=1, sam1=False, orb=False,
              gaussian=False, parallel=None):
    """OVOSemMap on the 680x1200 wall scene, segmenting every 10th frame:
    precomputed-style masks from the scene, or (``live``) the SAM2 Hiera-L
    automatic masks built from the config at ``image_size``, or with
    ``sam1`` SAM1's ViT-H (the sam1_slice: the only host syncs allowed in
    its frame loop are those of the small-region host pass); ``clip``
    replaces the config's clip section; ``sam_batch`` > 1 micro-batches the
    live masks (the batch_slice: the only host syncs allowed in its frame
    loop are the flushes' validity reads). Returns the phase's record and
    the map. ``orb`` (the orb_slice, with ``live``): configs/ovo.yaml's
    own backbone, the native tracker's poses, on the scene's first
    ``frames`` frames out and back (2 * frames - 1 frames); the ORB tier's
    host reads are the only host syncs allowed in its frame loop, and
    OrbProbe's gates must hold. ``gaussian`` (the gaussian_slice, with
    ``live``): the Gaussian-SLAM backbone of gaussian_slam_config() on the
    scene's first ``frames`` frames; its host reads (``splat.read_host``)
    are the only host syncs allowed in its frame loop, GaussianProbe's
    gates must hold, and the final map's render is timed. ``parallel`` (the
    multidevice_slice, with ``sam_batch`` 2): the semantic config's
    ``parallel`` keys, in whatever world the process has joined; the
    collectives are counted per keyframe."""
    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.parallel import mesh

    tag = (("amg_slice" if image_size == 1024 else f"amg{image_size}_slice")
           if live else ("crop_slice" if clip else "slice"))
    if sam_batch > 1:
        tag = "batch_slice"
    if sam1:
        tag = "sam1_slice"
    if orb:
        tag = "orb_slice"
    if gaussian:
        tag = "gaussian_slice"
    if parallel:
        tag = "multidevice_slice"
    t0 = time.time()
    # the orb_slice goes out along the first half of the 60-frame scene and
    # back, whichever phase built the scene first
    scene = replica_wall_scene(2 * frames if orb else frames)
    if orb:
        scene = out_and_back(scene.head(frames), frames)
    if gaussian:
        # the 60-frame wall's first frames (4 cm apart), whichever phase
        # built the scene first: the tracker starts from the odometry's
        # guess and a wall built for 11 frames moves 24 cm a frame
        scene = replica_wall_scene(60).head(frames)
    masks = {fid: scene.masks(fid) for fid in range(0, len(scene), 10)
             if not live}
    t_scene = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads(json.dumps(REPLICA_CONFIG))
        if orb:
            cfg["slam"] = dict(orb_slam_config(), save_estimated_cam=True)
        if gaussian:
            cfg.update(gaussian_slam_config())
        if clip:
            cfg["semantic"]["clip"] = dict(clip)
        if parallel:
            cfg["semantic"]["parallel"] = dict(parallel)
        # the embedder is built from the config (PE-Core-L14-336, or the
        # clip section given, seeded random weights, on the card); so is the
        # live mask source
        if live:
            cfg["semantic"]["sam"] = dict(SAM1_LIVE if sam1 else SAM_LIVE,
                                          image_size=image_size,
                                          batch=sam_batch)
            source = None
        else:
            source = CallableMaskSource(lambda img, fid: masks[fid], 96, dev)
        sem_map = OVOSemMap(cfg, tmp, dataset=scene, device=dev,
                            mask_source=source)
        recorder = RecordingMaskSource(sem_map.ovo.mask_source)
        sem_map.ovo.mask_source = recorder
        embedder = CountingEmbedder(sem_map.ovo.embedder)
        sem_map.ovo.embedder = embedder
        probe = (OrbProbe(sem_map) if orb else GaussianProbe(sem_map)
                 if gaussian else None)
        # an earlier slice's map lives in a reference cycle (its patched
        # drain below) until a full collection: free it, so that this run's
        # peak reads its own and no collection falls inside its wall
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_build.reset_launch_counts()
        prof = _profiler() if profile_path else None
        if prof is not None:
            prof.__enter__()
        t0 = time.time()
        # every synchronizing CUDA call in the run raises a warning, with
        # the Python line that made it; the frame loop ends where the last
        # deferred-descriptor drain starts (a loop closure drains the queue
        # inside the loop)
        loop_end = []
        drain = sem_map.ovo.complete_semantic_info

        def marked_drain():
            loop_end.append(len(caught))
            drain()

        sem_map.ovo.complete_semantic_info = marked_drain
        if probe is not None:
            probe.__enter__()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught, \
                mesh.counting_collectives() as collectives:
            warnings.simplefilter("always")
            sem_map.run()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if probe is not None:
            probe.__exit__(None, None, None)
        if prof is not None:
            prof.__exit__(None, None, None)
        counts = cuda_build.launch_counts()
        sync_list = [f"{w.filename.split('ovo_tpu_torch/')[-1]}:{w.lineno}"
                     for w in caught if "synchroniz" in str(w.message)]
        loop_syncs = [f"{w.filename.split('ovo_tpu_torch/')[-1]}:{w.lineno}"
                      for w in caught[:loop_end[-1]]
                      if "synchroniz" in str(w.message)]
    ovo = sem_map.ovo
    st = sem_map.slam_backbone.get_map()
    n_emb = len(ovo.kf_descriptors)
    n_seg = len(recorder.valid_counts)
    valid_counts = [int(c) for c in recorder.valid_counts]
    descs = torch.cat([d[k] for _, d, k in ovo.kf_descriptors.values()])
    norms = torch.linalg.vector_norm(descs, dim=-1)
    if not (torch.isfinite(descs).all()
            and (norms - 1).abs().max() <= 1e-3):
        raise AssertionError(f"{tag}: descriptors not finite unit vectors")
    fused = ovo.store.clip_feature[ovo.store.has_clip]
    if not torch.isfinite(fused).all() or len(fused) == 0:
        raise AssertionError(f"{tag}: no finite fused descriptors")
    if min(valid_counts, default=0) < 1:
        raise AssertionError(f"{tag}: a keyframe without a valid mask: "
                             f"{valid_counts}")
    depth_layers = len(ovo.embedder.model.visual.blocks)
    expect = dict.fromkeys(cuda_build.LAUNCH_NAMES, 0)
    if clip:
        # the seg, bbox and global views each run the whole tower
        expect.update(fused_attention=3 * depth_layers * n_emb)
    else:
        # one tower call per embedded keyframe, or per micro-batch of them;
        # a loop closure drops the culled keyframes' records, not their
        # launches
        expect.update(rope_packed_attention=depth_layers
                      * embedder.tower_calls,
                      masked_pool=embedder.tower_calls if orb else n_emb)
    if live:
        per_kf = (SAM1_LAUNCHES_PER_KF if sam1
                  else AMG_LAUNCHES_PER_KF if image_size == 1024
                  else AMG1280_LAUNCHES_PER_KF)
        expect.update({k: v * n_seg for k, v in per_kf.items()})
        # a micro-batch runs the trunk once for its keyframes
        n_trunk = len(recorder.batches) if sam_batch > 1 else n_seg
        for k, v in TRUNK_LAUNCHES.items():
            expect[k] -= v * (n_seg - n_trunk)
    if n_emb == 0 or counts != expect or (
            orb and embedder.tower_calls != n_seg):
        raise AssertionError(f"{tag}: launches {counts}, expected {expect}, "
                             f"{embedder.tower_calls} tower calls")
    # the batch_slice's flushes read each keyframe's mask validity on the
    # host (the reference's skip-on-empty); nothing else may sync
    allowed = (_validity_read_sites() if sam_batch > 1
               else _small_region_sites() if sam1
               else _orb_sync_sites() if orb
               else _gaussian_sync_sites() if gaussian else set())
    if set(loop_syncs) - allowed:
        raise AssertionError(f"{tag}: host syncs in the frame loop: "
                             f"{collections.Counter(loop_syncs)}")
    extra = _profile_summary(prof, wall, profile_path) if prof else {}
    if prof is not None and image_size == 1280:
        # the unfused decoder's image -> token attention (B9b, 2 launches
        # per segmented keyframe): its device time per segmented keyframe
        b9b = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type.name == "CUDA" and _is_b9b_kernel(e.name))
        extra["b9b_device_ms_per_segmented_keyframe"] = b9b / 1e3 / n_seg
    record = dict(frames=len(scene), keyframes=ovo.kf_id,
                segmented_keyframes=n_seg, embedded_keyframes=n_emb,
                valid_masks_per_keyframe=valid_counts, seconds=wall,
                keyframes_per_s=ovo.kf_id / wall,
                scene_setup_s=t_scene, map_points=int(st.count),
                map_capacity=st.capacity,
                minted_instances=int(ovo.store.next_id),
                descriptor_norm_min=float(norms.min()),
                descriptor_norm_max=float(norms.max()),
                max_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                host_syncs=len(sync_list), host_syncs_in_loop=len(loop_syncs),
                host_sync_sites=dict(collections.Counter(sync_list)),
                launches=counts, **extra)
    if sam1:
        per_seg = {k: counts[k] / n_seg for k in (
            "windowed_attention", "cross_t2i", "cross_i2t_tail",
            "flash_attention")}
        if min(per_seg[k] for k in SAM1_LAUNCHES_PER_KF) <= 0 or \
                per_seg["flash_attention"]:
            raise AssertionError(f"{tag}: launches per segmented keyframe "
                                 f"{per_seg}")
        record.update(launches_per_segmented_keyframe=per_seg,
                      encoder=SAM1_LIVE["sam_encoder"])
    if orb:
        probe.check(tag)
        record.update(
            probe.record(), slam={k: v for k, v in cfg["slam"].items()
                                  if k.startswith(("kf_", "loop_"))},
            launches_per_segmented_keyframe={
                k: counts[k] / n_seg for k in AMG_LAUNCHES_PER_KF},
            launches_per_tower_call={
                k: counts[k] / embedder.tower_calls
                for k in ("rope_packed_attention", "masked_pool")})
    if gaussian:
        record.update(
            probe.record(scene), **render_times(sem_map.slam_backbone),
            host_syncs_in_loop_per_frame=len(loop_syncs) / len(scene),
            launches_per_segmented_keyframe={
                k: counts[k] / n_seg for k in AMG_LAUNCHES_PER_KF},
            launches_per_tower_call={
                k: counts[k] / embedder.tower_calls
                for k in ("rope_packed_attention", "masked_pool")},
            mapping={k: cfg["mapping"][k] for k in (
                "n_gaussians_capacity", "k_per_tile", "iterations",
                "new_submap_iterations", "new_submap_points_num",
                "max_seeds", "keyframe_window", "map_every")},
            tracking={k: cfg["tracking"][k] for k in (
                "iterations", "odometry_type", "init_err_ratio")})
    if parallel:
        record.update(parallel=parallel, collectives=dict(collectives),
                      collectives_per_keyframe={
                          k: v / ovo.kf_id for k, v in collectives.items()})
    elif collectives:
        raise AssertionError(f"{tag}: collectives {dict(collectives)}")
    if sam_batch > 1:
        record.update(sam_batch=sam_batch, batches=recorder.batches,
                      tower_calls=embedder.tower_calls,
                      launches_per_flush={k: v / len(recorder.batches)
                                          for k, v in counts.items() if v})
    return record, sem_map


def run_query(dev, ovo, per_class: dict) -> dict:
    """classify_instances over ``ovo``'s map with the query vocabulary:
    each class embedded on its own through the text tower; ``per_class``
    the launches expected per class (every other kernel: none)."""
    from ovo_tpu_torch.ops import cuda_build

    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    t0 = time.time()
    res = ovo.classify_instances(QUERY_CLASSES, QUERY_TEMPLATE)
    wall = time.time() - t0
    counts = cuda_build.launch_counts()
    expect = dict.fromkeys(cuda_build.LAUNCH_NAMES, 0)
    expect.update({k: v * len(QUERY_CLASSES) for k, v in per_class.items()})
    if counts != expect:
        raise AssertionError(f"query: launches {counts}, expected {expect}")
    sims = ovo.query(QUERY_CLASSES, [QUERY_TEMPLATE])
    if sims.shape != (len(ovo.active_ids()), len(QUERY_CLASSES)) \
            or not np.isfinite(sims).all():
        raise AssertionError(f"query: similarities {sims.shape} not finite")
    if ovo.embedder.model.cfg.siglip and not ((sims >= 0) & (sims <= 1)).all():
        raise AssertionError("query: sigmoid similarities outside [0, 1]")
    if not np.array_equal(res["ids"], ovo.active_ids()) \
            or not (res["classes"] < len(QUERY_CLASSES)).all():
        raise AssertionError("query: malformed classification")
    return dict(card=ovo.embedder.model.cfg.name, classes=len(QUERY_CLASSES),
                instances=len(res["ids"]), seconds=wall,
                classified=int((res["classes"] >= 0).sum()),
                sim_min=float(sims.min()), sim_max=float(sims.max()),
                launches=counts)


# ---------------------------------------------------------------------------
# the command line: scenes on disk, a copied config tree, run_eval.main
# ---------------------------------------------------------------------------

# Replica raw ids the wall cells are labelled with (eval_info.yaml maps them
# to wall, floor, ceiling, chair, sofa, rug)
GT_IDS = np.array([93, 40, 31, 20, 80, 98])


def write_replica_scene(root, scene: str, wall: WallScene,
                        gt_stride: int = 3) -> None:
    """``wall``'s frames in the Replica layout under ``root``/data/input/
    Datasets/Replica, as PNG (the colour under the ``.jpg`` names Replica
    globs; the readers decode by content), 16-bit depth at 6553.5 per
    metre, ``traj.txt``; the GT: every ``gt_stride``-th pixel of frame 0
    unprojected as the mesh (binary PLY) with its cell's Replica id."""
    from pathlib import Path

    from ovo_tpu_torch.data.images import write_png

    rep = Path(root) / "data/input/Datasets/Replica"
    res = rep / scene / "results"
    res.mkdir(parents=True, exist_ok=True)
    (rep / "semantic_gt").mkdir(exist_ok=True)
    for i, image, depth, _, _ in wall.frames:
        write_png(res / f"frame{i:04d}.jpg", image)
        write_png(res / f"depth{i:04d}.png",
                  np.clip(np.round(depth * 6553.5), 0, 65535).astype(
                      np.uint16))
    np.savetxt(rep / scene / "traj.txt",
               np.stack([p.reshape(-1) for p in wall.poses]), fmt="%.8f")
    _, _, depth, c2w, cell = wall.frames[0]
    z = depth[::gt_stride, ::gt_stride].reshape(-1)
    x = wall.dx[::gt_stride, ::gt_stride].reshape(-1) * z
    y = wall.dy[::gt_stride, ::gt_stride].reshape(-1) * z
    pts = np.stack([x, y, z], 1) @ c2w[:3, :3].T + c2w[:3, 3]
    labels = GT_IDS[cell[::gt_stride, ::gt_stride].reshape(-1) % len(GT_IDS)]
    np.savetxt(rep / "semantic_gt" / f"{scene}.txt", labels, fmt="%d")
    with open(rep / f"{scene}_mesh.ply", "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(pts)}\nproperty float x\n"
                 "property float y\nproperty float z\nend_header\n").encode())
        f.write(pts.astype("<f4").tobytes())


def cli_config_root(tmp, scene: str, overrides: dict):
    """A copy of the repository's configs/ with ``overrides`` as the
    scene's config (``Replica/<scene>.yaml``, written as JSON)."""
    import shutil
    from pathlib import Path

    root = Path(tmp) / "configs"
    shutil.copytree(Path(__file__).resolve().parent / "configs", root)
    with open(root / "Replica" / f"{scene}.yaml", "w") as f:
        json.dump(overrides, f, indent=2)
    return root


def _cli(argv, config_root):
    from ovo_tpu_torch import run_eval

    return run_eval.main(run_eval.parse_args(argv), config_root=config_root)


def _cli_argv(scene, exp, *phases, device="cuda"):
    return (["--dataset_name", "Replica", "--scenes", scene,
             "--experiment_name", exp, "--device", device]
            + [f"--{p}" for p in phases])


class FusedBlockEnv:
    """``OVO_FUSED_BLOCK=1`` for the duration of a with-block."""

    def __enter__(self):
        import os

        self.old = os.environ.get("OVO_FUSED_BLOCK")
        os.environ["OVO_FUSED_BLOCK"] = "1"

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop("OVO_FUSED_BLOCK", None)
        else:
            os.environ["OVO_FUSED_BLOCK"] = self.old


class CPUDrawnWeights:
    """While active, the factories' random models are drawn on the CPU and
    then moved (SAM in f32), so a card run and a CPU run of the CLI hold
    the same weights; the CLIP card is drawn from ``clip_seed``."""

    def __init__(self, clip_seed: int = 0):
        self.clip_seed = clip_seed

    def __enter__(self):
        from ovo_tpu_torch.models.clip import CLIPModel
        from ovo_tpu_torch.models.sam.model import SAMModel

        self.saved = (CLIPModel.random_init, SAMModel.random_init)
        clip_init, sam_init = (f.__func__ for f in self.saved)

        def clip(name, seed=0, device="cuda"):
            m = clip_init(CLIPModel, name, seed=self.clip_seed, device="cpu")
            return CLIPModel(m.cfg, copy.deepcopy(m.visual), device,
                             text=copy.deepcopy(m.text),
                             logit_scale=float(m.logit_scale),
                             logit_bias=m.logit_bias, tokenizer=m.tokenizer)

        def sam(encoder="hiera_l", image_size=1024, seed=0, device="cuda",
                compute_dtype="bfloat16"):
            m = sam_init(SAMModel, encoder, image_size, seed=seed,
                         device="cpu", compute_dtype="float32")
            return SAMModel(m.cfg, copy.deepcopy(m.params), device)

        CLIPModel.random_init = staticmethod(clip)
        SAMModel.random_init = staticmethod(sam)

    def __exit__(self, *exc):
        from ovo_tpu_torch.models.clip import CLIPModel
        from ovo_tpu_torch.models.sam.model import SAMModel

        CLIPModel.random_init = classmethod(self.saved[0].__func__)
        SAMModel.random_init = classmethod(self.saved[1].__func__)


# the reference scene's config: tinyroom-sized, hiera_test SAM and the
# tiny-pe card (RoPE, so B12a's rotation runs on the card), gates at 0
REFERENCE_CLI = {
    "slam": {"slam_module": "vanilla"}, "debug": False, "debug_info": False,
    "cam": {"H": 64, "W": 96, "fx": 80.0, "fy": 80.0, "cx": 47.5,
            "cy": 31.5, "depth_scale": 6553.5},
    "mapping": {"map_every": 2, "n_points_capacity": 1 << 16},
    "semantic": {
        "segment_every": 2, "log": False, "kf_queue_delay": 1,
        "track_th": 40, "depth_filter": False,
        "capacity": {"n_instances": 64, "n_masks": 16},
        "sam": {"sam_encoder": "hiera_test", "image_size": 128,
                "points_per_side": 4, "sam_ckpt_path": "",
                "pred_iou_th": 0.0, "stability_score_th": 0.0,
                "nms_score_th": 0.0},
        "clip": {"model_card": "tiny-pe", "embed_type": "TextRegion",
                 "mask_res": 64}}}


# the ORB reference scene's config: REFERENCE_CLI's models and sizes on
# configs/ovo.yaml's own backbone (orbslam), with tracker gates for a 64x96
# scene whose camera steps ~8 cm a frame: configs/slam/orbslam/replica.yaml
# is tuned for 680x1200 frames, and its 0.15 m keyframes and 8-keyframe
# loop gap close no loop in 23 frames
REFERENCE_ORB = dict(
    {k: v for k, v in REFERENCE_CLI.items() if k != "slam"},
    slam={"kf_trans_th": 0.05, "loop_min_kf_gap": 5, "loop_radius": 0.15,
          "loop_rot_limit": 1.0, "loop_inlier_th": 0.3})


def reference_orb_scene(root, scene: str) -> WallScene:
    """The ORB reference scene under ``root``: a 64x96 wall, its first 12
    frames out and back (23 frames), the border without depth."""
    cam = REFERENCE_CLI["cam"]
    wall = out_and_back(WallScene(30, cam["H"], cam["W"], cam["fx"],
                                  cam["fy"], cam["cx"], cam["cy"], seed=3,
                                  cell=0.8), 12, zero_border=True)
    write_replica_scene(root, scene, wall, gt_stride=1)
    return wall


def run_reference_cli(dev) -> dict:
    """run_eval.main --run --segment --eval on a small PNG scene, on the
    card under OVO_FUSED_BLOCK=1 (tiny-pe through B12a / B12b) and with
    --device cpu (the per-layer route's plain versions), the same weights
    in both: equal map points and object ids, descriptors within cosine
    1e-4, label files equal where the instance's top-2 margin is above 1e-4,
    equal metrics when the labels are equal."""
    import os
    from pathlib import Path

    from ovo_tpu_torch.eval.transfer import match_labels_to_vtx
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.run_eval import load_representation
    from ovo_tpu_torch.utils import io as io_utils
    from ovo_tpu_torch.utils import yaml_subset

    scene = "smoke_ref"
    cam = REFERENCE_CLI["cam"]
    wall = WallScene(8, cam["H"], cam["W"], cam["fx"], cam["fy"], cam["cx"],
                     cam["cy"], seed=3, cell=0.8)
    out, cwd = {}, os.getcwd()
    traced = {}
    with tempfile.TemporaryDirectory() as tmp:
        write_replica_scene(tmp, scene, wall, gt_stride=1)
        trace_dir = Path(tmp) / "trace"
        root = cli_config_root(tmp, scene, dict(
            REFERENCE_CLI, profile_trace=str(trace_dir)))
        classes = yaml_subset.load(root / "Replica" / "eval_info.yaml")[
            "class_names_reduced"]
        mesh = io_utils._read_ply_vertices(
            Path(tmp) / "data/input/Datasets/Replica" / f"{scene}_mesh.ply")
        os.chdir(tmp)
        try:
            # CLIP seed 1: its random towers give this scene's instance a
            # best similarity above 0, so it is classified (at seed 0 every
            # class scores below 0 and every label is -1, mIoU nan)
            with CPUDrawnWeights(clip_seed=1), FusedBlockEnv():
                for device in ("cuda", "cpu"):
                    cuda_build.reset_launch_counts()
                    metrics = _cli(_cli_argv(scene, device, "run", "segment",
                                             "eval", device=device), root)
                    counts = cuda_build.launch_counts()
                    # the profile_trace hook's Chrome trace of this run
                    new = sorted(set(trace_dir.glob("*.json")) - set(
                        p for ps in traced.values() for p in ps))
                    traced[device] = new
                    if device == "cuda":
                        names = {e.get("name", "") for p in new for e in
                                 json.loads(p.read_text())["traceEvents"]}
                        ours = sorted(k for k in _kernel_names()
                                      if any(k in nm for nm in names))
                    exp = Path(tmp) / "data/output/Replica" / device
                    ckpt = io_utils.load_ckpt(exp / scene / "ovo_map.ckpt")
                    ovo, _ = load_representation(exp / scene, device="cpu")
                    out[device] = dict(
                        metrics=metrics, counts=counts, ckpt=ckpt,
                        sims=ovo.query(classes, ["This is a photo of a {}"]),
                        ids=ovo.active_ids(),
                        labels=io_utils.read_labels(
                            exp / "replica" / f"{scene}.txt"))
        finally:
            os.chdir(cwd)
    card, cpu = out["cuda"], out["cpu"]
    mc, mp = card["ckpt"]["map_params"], cpu["ckpt"]["map_params"]
    n = len(mp["xyz"])
    if not (np.array_equal(mc["xyz"], mp["xyz"])
            and np.array_equal(mc["obj_ids"], mp["obj_ids"])
            and np.array_equal(card["ids"], cpu["ids"])):
        raise AssertionError("reference_cli: card and CPU maps differ")
    oc, op = card["ckpt"]["ovo_map_params"], cpu["ckpt"]["ovo_map_params"]
    worst, n_desc = 0.0, 0
    for i in cpu["ids"]:
        a, b = oc[f"ins3d_{i}_clip_feature"], op[f"ins3d_{i}_clip_feature"]
        if (a is None) != (b is None):
            raise AssertionError(f"reference_cli: instance {i} described on "
                                 f"one side only")
        if a is not None:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
            worst, n_desc = max(worst, abs(cos - 1.0)), n_desc + 1
    if n_desc < 1 or worst > 1e-4:
        raise AssertionError(f"reference_cli: {n_desc} descriptors, cosine "
                             f"off by {worst}")
    # labels: compared on the vertices whose instance has a clear class
    top2 = np.sort(cpu["sims"], axis=1)
    clear_ids = set(cpu["ids"][top2[:, -1] - top2[:, -2] > 1e-4].tolist())
    mesh_ins, _, _ = match_labels_to_vtx(
        np.asarray(mp["obj_ids"]).reshape(-1), np.asarray(mp["xyz"]), mesh)
    clear = np.isin(mesh_ins, list(clear_ids))
    if clear.mean() < 0.5 or not np.array_equal(card["labels"][clear],
                                                cpu["labels"][clear]):
        raise AssertionError(f"reference_cli: labels differ on clear "
                             f"vertices ({clear.mean():.2f} clear)")
    labels_equal = bool(np.array_equal(card["labels"], cpu["labels"]))
    if labels_equal and json.dumps(card["metrics"]) != json.dumps(
            cpu["metrics"]):
        raise AssertionError(f"reference_cli: metrics differ: "
                             f"{card['metrics']} / {cpu['metrics']}")
    if card["counts"]["fused_attn_block"] < 1 \
            or card["counts"]["fused_mlp_block"] < 1 \
            or card["counts"]["rope_packed_attention"] != 0:
        raise AssertionError(f"reference_cli: the card run did not take "
                             f"B12: {card['counts']}")
    if len(traced["cuda"]) != 1 or len(traced["cpu"]) != 1 or not ours:
        raise AssertionError(f"reference_cli: profile_trace wrote "
                             f"{traced}, naming kernels {ours}")
    return dict(points=n, instances=len(cpu["ids"]), descriptors=n_desc,
                max_cos_dev=worst, labels_equal=labels_equal,
                clear_vertex_share=float(clear.mean()),
                miou=card["metrics"]["iou"], macc=card["metrics"]["acc"],
                trace_kernels=ours, launches=card["counts"])


class OrbRunRecorder:
    """While active, ``OVOSemMap.run`` keeps its mapper and runs under an
    OrbProbe (``self.runs``: one (mapper, probe) per run)."""

    def __enter__(self):
        from ovo_tpu_torch.mapping.pipeline import OVOSemMap

        self.cls, self.orig, self.runs = OVOSemMap, OVOSemMap.run, []

        def run(sem_map):
            with OrbProbe(sem_map) as probe:
                self.orig(sem_map)
            self.runs.append((sem_map, probe))

        OVOSemMap.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig


def run_reference_orb(dev) -> dict:
    """run_eval.main --run --segment --eval on the ORB reference scene
    (64x96, 23 frames out and back; hiera_test, tiny-pe, gates at 0;
    configs/ovo.yaml's own orbslam backbone with REFERENCE_ORB's tracker
    gates) on the card and with --device cpu, the same weights: the same
    keyframes, big changes and culled set; equal map count, point ids and
    object ids, points within 1e-5; the same active ids and fused pairs
    (a pair within NEAR_GATE of a gate on the card may differ, and is
    reported); descriptors within cosine 1e-4; labels equal where the
    instance's top-2 margin is above 1e-4, metrics equal when the labels
    are."""
    import os
    from pathlib import Path

    from ovo_tpu_torch.eval.transfer import match_labels_to_vtx
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.utils import io as io_utils
    from ovo_tpu_torch.utils import yaml_subset

    scene = "smoke_orb"
    out, cwd = {}, os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        reference_orb_scene(tmp, scene)
        root = cli_config_root(tmp, scene, REFERENCE_ORB)
        classes = yaml_subset.load(root / "Replica" / "eval_info.yaml")[
            "class_names_reduced"]
        mesh = io_utils._read_ply_vertices(
            Path(tmp) / "data/input/Datasets/Replica" / f"{scene}_mesh.ply")
        os.chdir(tmp)
        try:
            with CPUDrawnWeights(clip_seed=1):
                for device in ("cuda", "cpu"):
                    cuda_build.reset_launch_counts()
                    with OrbRunRecorder() as rec:
                        metrics = _cli(_cli_argv(scene, device, "run",
                                                 "segment", "eval",
                                                 device=device), root)
                    sem_map, probe = rec.runs[0]
                    exp = Path(tmp) / "data/output/Replica" / device
                    ovo = sem_map.ovo
                    out[device] = dict(
                        metrics=metrics, counts=cuda_build.launch_counts(),
                        map=sem_map.slam_backbone.get_map(),
                        backbone=sem_map.slam_backbone, ovo=ovo,
                        probe=probe.record(), near=probe.near_gate_pairs(),
                        sims=ovo.query(classes, ["This is a photo of a {}"]),
                        labels=io_utils.read_labels(
                            exp / "replica" / f"{scene}.txt"))
        finally:
            os.chdir(cwd)
    card, cpu = out["cuda"], out["cpu"]
    for key in ("big_changes", "tracker_keyframes", "culled_keyframes",
                "mapped_keyframes", "tracker_states"):
        if card["probe"][key] != cpu["probe"][key]:
            raise AssertionError(f"reference_orb: {key} differ: "
                                 f"{card['probe'][key]} / {cpu['probe'][key]}")
    if cpu["probe"]["big_changes"] < 1 or not cpu["probe"]["culled_keyframes"] \
            or card["probe"]["update_map"]["calls"] < 1:
        raise AssertionError(f"reference_orb: no loop closure: "
                             f"{cpu['probe']}")
    ms_card, ms_cpu = card["map"], cpu["map"]
    n = int(ms_cpu.count)
    if int(ms_card.count) != n or not all(
            torch.equal(getattr(ms_card, f)[:n].cpu(), getattr(ms_cpu, f)[:n])
            for f in ("point_ids", "obj_ids")):
        raise AssertionError("reference_orb: card and CPU maps differ")
    pts_err = float((ms_card.points[:n].cpu() - ms_cpu.points[:n]).abs()
                    .max())
    if pts_err > 1e-5:
        raise AssertionError(f"reference_orb: points off by {pts_err}")
    ids = cpu["ovo"].active_ids()
    if not np.array_equal(card["ovo"].active_ids(), ids):
        raise AssertionError("reference_orb: active ids differ")
    near = set().union(*card["near"]) if card["near"] else set()
    flipped = set()
    for fc, fp in zip(card["probe"]["fused"], cpu["probe"]["fused"]):
        flipped |= {(i, j) for j, i in set(fc) ^ set(fp)}
    if len(card["probe"]["fused"]) != len(cpu["probe"]["fused"]) \
            or flipped - near:
        raise AssertionError(f"reference_orb: fused pairs differ: "
                             f"{card['probe']['fused']} / "
                             f"{cpu['probe']['fused']}")
    a = card["ovo"].store.clip_feature.cpu().double()[ids]
    b = cpu["ovo"].store.clip_feature.double()[ids]
    has = cpu["ovo"].store.has_clip[ids]
    cos = (a * b).sum(1) / (a.norm(dim=1) * b.norm(dim=1)).clamp_min(1e-30)
    worst = float((cos[has] - 1).abs().max()) if bool(has.any()) else 0.0
    if not bool(has.any()) or worst > 1e-4:
        raise AssertionError(f"reference_orb: cosine off by {worst}")
    top2 = np.sort(cpu["sims"], axis=1)
    clear_ids = set(ids[top2[:, -1] - top2[:, -2] > 1e-4].tolist())
    mesh_ins, _, _ = match_labels_to_vtx(
        ms_cpu.obj_ids[:n].numpy(), ms_cpu.points[:n].numpy(), mesh)
    clear = np.isin(mesh_ins, list(clear_ids))
    if clear.mean() < 0.5 or not np.array_equal(card["labels"][clear],
                                                cpu["labels"][clear]):
        raise AssertionError(f"reference_orb: labels differ on clear "
                             f"vertices ({clear.mean():.2f} clear)")
    labels_equal = bool(np.array_equal(card["labels"], cpu["labels"]))
    if labels_equal and json.dumps(card["metrics"]) != json.dumps(
            cpu["metrics"]):
        raise AssertionError(f"reference_orb: metrics differ: "
                             f"{card['metrics']} / {cpu['metrics']}")
    return dict(points=n, instances=len(ids), max_points_err=pts_err,
                max_cos_dev=worst, labels_equal=labels_equal,
                clear_vertex_share=float(clear.mean()),
                pairs_near_gate=card["probe"]["pairs_near_gate"],
                fused=card["probe"]["fused"],
                big_changes=card["probe"]["big_changes"],
                culled_keyframes=card["probe"]["culled_keyframes"],
                update_map_calls=card["probe"]["update_map"]["calls"],
                miou=card["metrics"]["iou"], launches=card["counts"])


# the full-width CLI scene: configs/ovo.yaml's chain for Replica (680x1200,
# SAM2 Hiera-L at 1024^2, TextRegion on PE-Core-L14-336, 2^21-point map)
# with the vanilla backbone, debug records and logging off (they read the
# card every keyframe) and the random-weight gates at 0, as the amg_slice
CLI_SCENE = {
    "slam": {"slam_module": "vanilla"}, "debug": False, "debug_info": False,
    "semantic": {"log": False,
                 "sam": {"pred_iou_th": 0.0, "stability_score_th": 0.0,
                         "nms_score_th": 0.0, "gate_prompts": 128}}}


class ClipSeed:
    """While active, the factory's random CLIP card is drawn from ``seed``
    (on the card, as the factory draws it)."""

    def __init__(self, seed: int):
        self.seed = seed

    def __enter__(self):
        from ovo_tpu_torch.models.clip import CLIPModel

        self.saved = CLIPModel.random_init
        init, fixed = self.saved.__func__, self.seed
        CLIPModel.random_init = staticmethod(
            lambda name, seed=0, device="cuda": init(CLIPModel, name,
                                                     seed=fixed,
                                                     device=device))

    def __exit__(self, *exc):
        from ovo_tpu_torch.models.clip import CLIPModel

        CLIPModel.random_init = classmethod(self.saved.__func__)


def classifying_clip_seed(card: str, image: np.ndarray, classes, dev,
                          tries: int = 6) -> int:
    """Of the seeds below ``tries``, the one whose random ``card`` gives the
    whole of ``image`` a TextRegion descriptor with the highest similarity
    to some class, which must be above 0. Random towers score every class
    below 0 as often as not; then classification leaves every vertex
    unlabelled and the mIoU is nan (the PE card at seed 0 does, on this
    scene)."""
    from ovo_tpu_torch.models.clip import CLIPModel
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    mask = torch.ones((1,) + image.shape[:2], dtype=torch.bool, device=dev)
    valid = torch.ones((1,), dtype=torch.bool, device=dev)
    best = []
    for seed in range(tries):
        emb = TextRegionEmbedder(CLIPModel.random_init(card, seed=seed,
                                                       device=dev))
        txt = emb.embed_text([f"This is a photo of a {c}" for c in classes])
        desc = emb.embed_masks(image, mask, valid)
        best.append(float(emb.similarity(txt.float(), desc.float()).max()))
    if max(best) <= 0:
        raise AssertionError(f"no seed below {tries} classifies with {card}")
    return int(np.argmax(best))


class RunRecorder:
    """While active, ``OVOSemMap.run`` keeps its mapper, counts the
    segmented keyframes, times itself (ending in a synchronize) and records
    every synchronizing CUDA call with its source line; the frame loop ends
    where the deferred-descriptor drain starts."""

    def __init__(self, prof=None):
        self.prof = prof  # a torch.profiler context around the timed run

    def __enter__(self):
        from ovo_tpu_torch.mapping.pipeline import OVOSemMap

        self.cls, self.orig, rec = OVOSemMap, OVOSemMap.run, self

        def run(sem_map):
            rec.sem_map = sem_map
            rec.masks = RecordingMaskSource(sem_map.ovo.mask_source)
            sem_map.ovo.mask_source = rec.masks
            drain = sem_map.ovo.complete_semantic_info

            def marked_drain():
                rec.loop_end = len(rec.caught)
                drain()

            sem_map.ovo.complete_semantic_info = marked_drain
            torch.cuda.synchronize()
            if rec.prof is not None:
                rec.prof.__enter__()
            t0 = time.time()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    rec.caught = caught
                    rec.orig(sem_map)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            rec.wall = time.time() - t0
            if rec.prof is not None:
                rec.prof.__exit__(None, None, None)

        OVOSemMap.run = run
        return self

    def __exit__(self, *exc):
        self.cls.run = self.orig

    def syncs(self, in_loop: bool):
        caught = self.caught[:self.loop_end] if in_loop else self.caught
        return [f"{w.filename.split('ovo_tpu_torch/')[-1]}:{w.lineno}"
                for w in caught if "synchroniz" in str(w.message)]


def run_cli(dev, frames: int = 40, profile_path=None) -> dict:
    """The user's command at full width: ``python -m ovo_tpu_torch.run_eval
    --run --segment --eval`` (called as ``main``) on a 680x1200 PNG scene
    of ``frames`` frames, OVO_FUSED_BLOCK=1, a copied config tree; the wall
    of each phase, launches per embedded keyframe, host syncs in the frame
    loop (none allowed), a finite mIoU / mAcc. With ``profile_path``, the
    card's activity in ``--run``'s loop is traced (_profile_summary, the
    kernel table written there) and B12's device time per embedded
    keyframe read from it."""
    import os

    from ovo_tpu_torch.config import assemble_run_config
    from ovo_tpu_torch.ops import cuda_build
    from ovo_tpu_torch.utils import yaml_subset

    scene = "smoke_cli"
    cam = REPLICA_CONFIG["cam"]
    t0 = time.time()
    wall = WallScene(frames, cam["H"], cam["W"], cam["fx"], cam["fy"],
                     cam["cx"], cam["cy"], seed=0)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        write_replica_scene(tmp, scene, wall)
        t_scene = time.time() - t0
        root = cli_config_root(tmp, scene, CLI_SCENE)
        classes = yaml_subset.load(root / "Replica" / "eval_info.yaml")[
            "class_names_reduced"]
        card = assemble_run_config(root, "Replica", scene)["semantic"][
            "clip"]["model_card"]
        seed = classifying_clip_seed(card, wall.frames[0][1], classes, dev)
        del wall
        torch.cuda.empty_cache()
        os.chdir(tmp)
        try:
            with FusedBlockEnv(), ClipSeed(seed):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                cuda_build.reset_launch_counts()
                t0 = time.time()
                prof = _profiler() if profile_path else None
                with RunRecorder(prof) as rec:
                    _cli(_cli_argv(scene, "cli", "run"), root)
                t_run = time.time() - t0
                counts = cuda_build.launch_counts()
                peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
                t0 = time.time()
                _cli(_cli_argv(scene, "cli", "segment"), root)
                t_segment = time.time() - t0
                t0 = time.time()
                metrics = _cli(_cli_argv(scene, "cli", "eval"), root)
                t_eval = time.time() - t0
        finally:
            os.chdir(cwd)
    ovo = rec.sem_map.ovo
    n_emb, n_seg = len(ovo.kf_descriptors), len(rec.masks.valid_counts)
    depth = len(ovo.embedder.model.visual.blocks)
    expect = dict.fromkeys(cuda_build.LAUNCH_NAMES, 0)
    expect.update(fused_attn_block=depth * n_emb,
                  fused_mlp_block=depth * n_emb, masked_pool=n_emb)
    expect.update({k: v * n_seg for k, v in AMG_LAUNCHES_PER_KF.items()})
    if n_emb == 0 or counts != expect:
        raise AssertionError(f"cli: launches {counts}, expected {expect}")
    loop_syncs = rec.syncs(in_loop=True)
    if loop_syncs:
        raise AssertionError(f"cli: host syncs in the frame loop: "
                             f"{collections.Counter(loop_syncs)}")
    descs = torch.cat([d[k] for _, d, k in ovo.kf_descriptors.values()])
    if not torch.isfinite(descs).all():
        raise AssertionError("cli: non-finite descriptors")
    st = rec.sem_map.slam_backbone.get_map()
    record = dict(frames=frames, clip_seed=seed, keyframes=ovo.kf_id,
                segmented_keyframes=n_seg,
                embedded_keyframes=n_emb,
                valid_masks_per_keyframe=[int(c) for c in
                                          rec.masks.valid_counts],
                scene_setup_s=t_scene, run_s=t_run, run_loop_s=rec.wall,
                keyframes_per_s=ovo.kf_id / rec.wall,
                segment_s=t_segment, eval_s=t_eval,
                miou=metrics["iou"], macc=metrics["acc"],
                map_points=int(st.count), instances=len(ovo.active_ids()),
                max_memory_gb=peak_gb,
                launches_per_embedded_keyframe={
                    k: v / n_emb for k, v in counts.items()
                    if k in ("fused_attn_block", "fused_mlp_block",
                             "rope_packed_attention", "masked_pool")},
                host_syncs=len(rec.syncs(in_loop=False)),
                host_syncs_in_loop=len(loop_syncs), launches=counts)
    if prof is not None:
        record.update(_profile_summary(prof, rec.wall, profile_path))
        b12 = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type.name == "CUDA" and _is_b12_kernel(e.name))
        record["b12_device_ms_per_embedded_keyframe"] = b12 / 1e3 / n_emb
    if not (np.isfinite(metrics["iou"]) and np.isfinite(metrics["acc"])):
        raise AssertionError(f"cli: metrics not finite: {record}")
    return record


def _is_b9b_kernel(name: str) -> bool:
    """B9b's device code in bf16: the tensor-core kernel, or the FMA kernel
    that other widths (and the first design) take."""
    return ("small_i2t_mma_kernel" in name
            or "i2t_kernel<__nv_bfloat16>" in name)


def _is_b12_kernel(name: str) -> bool:
    """B12a / B12b's device code on the cli path (bf16, hd 64, no causal
    block, no B5 launch): block_common.cuh's kernels and B12a's attention."""
    return "ovo_block::" in name or "two_pass_mma_kernel" in name


def run_kernel_device(dev) -> dict:
    """B5, B6, B1, B2, B11, B9a, B3, B4 (also at SAM1's 7 tokens, B3's
    8-token time beside it), B7, B9b, B13, B12a, B12b and B14 in
    bf16 and B10 in f32 at the kernel phase's shapes: the card's kernel time
    per call beside the library's on the same operands (device_ms): SDPA for
    B5 (on the rotated heads), B6 (the path's layout, the masks as a boolean
    mask), B1, B2, B11, B9a, B9b (on the per-head views) and B10, the whole
    function's library route for B3, B4 and B7 (_b3_library, _b4_library,
    _b7_library), the default route's block half for B12a and B12b, the
    decoder's unfused tail for B13, F.layer_norm for B14."""
    from ovo_tpu_torch.ops.attention import (cross_attention_small_head,
                                             cross_i2t_from_keys,
                                             cross_i2t_tail_from_keys,
                                             cross_t2i_from_keys,
                                             flash_attention, fused_attention,
                                             packed_heads_attention,
                                             rope_packed_attention,
                                             windowed_fused_attention)
    from ovo_tpu_torch.ops.layer_norm import layer_norm_rows
    from ovo_tpu_torch.ops.masked_pool import masked_pool

    bf, sdpa = torch.bfloat16, torch.nn.functional.scaled_dot_product_attention
    calls = {}
    # each call binds its operands as defaults: the names are reused below
    qkv, cos, sin, (q, k, v, mask) = _b5_inputs(dev, bf)
    calls["rope_packed_attention"] = (
        lambda x=qkv, c=cos, s=sin: rope_packed_attention(
            x, c, s, heads=B5_SHAPE[1], kv_len=B5_SHAPE[3]),
        lambda q=q, k=k, v=v, m=mask: sdpa(q, k, v, attn_mask=m))
    q, k, v, mask, _, _ = _b6_inputs(dev, bf)
    scale = q.shape[-1] ** -0.5
    calls["masked_pool"] = (
        lambda q=q, k=k, v=v, m=mask, s=scale: masked_pool(q, k, v, m, s),
        lambda q=q.transpose(0, 1)[None], k=k[None], v=v[None],
        m=mask[None, None], s=scale: sdpa(q, k, v, attn_mask=m, scale=s))
    gen = torch.Generator(device=dev).manual_seed(1)
    _, (q, k, v) = _heads_of_packed(gen, 1, 4096, 8, 72, dev, bf)
    calls["flash_attention"] = (lambda q=q, k=k, v=v: flash_attention(q, k, v),
                                lambda q=q, k=k, v=v: sdpa(q, k, v))
    for which, (n, heads, lq, lk, hd) in B2_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(2)
        _, (q, k, v) = _heads_of_packed(gen, n, lk, heads, hd, dev, bf)
        q = q[:, :, :lq]
        calls[f"windowed_attention_{which}"] = (
            lambda q=q, k=k, v=v: windowed_fused_attention(q, k, v),
            lambda q=q, k=k, v=v: sdpa(q, k, v))
    for which, (n, L, heads, hd) in B11_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(11)
        qkv = torch.randn((n, L, 3, heads * hd), generator=gen,
                          device=dev).to(bf)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qh, kh, vh = (t.reshape(n, L, heads, hd).transpose(1, 2)
                      for t in (q, k, v))
        calls[f"packed_heads_attention_{which}"] = (
            lambda q=q, k=k, v=v, h=heads: packed_heads_attention(
                q, k, v, heads=h),
            lambda q=qh, k=kh, v=vh: sdpa(q, k, v))
    # B10 in f32 at the crops' batch (the crop_slice's dtype), B9a at
    # check_b9a's per-prompt shape
    gen = torch.Generator(device=dev).manual_seed(10)
    _, (q, k, v) = _heads_of_packed(gen, B10_BATCHES[-1], 729, 16, 72, dev,
                                    torch.float32)
    calls["fused_attention_f32"] = (
        lambda q=q, k=k, v=v: fused_attention(q, k, v),
        lambda q=q, k=k, v=v: sdpa(q, k, v))
    B, T, L, heads, D = (B9_SHAPE[k] for k in ("B", "T", "L", "heads", "D"))
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((B, T, D), generator=gen, device=dev).to(bf)
    k, v = (torch.randn((B, L, D), generator=gen, device=dev).to(bf)
            for _ in range(2))
    calls["cross_small_head_t2i_kv256"] = (
        lambda q=q, k=k, v=v: cross_attention_small_head(q, k, v, heads),
        lambda q=_small_head_split(q, B, heads),
        k=_small_head_split(k, B, heads), v=_small_head_split(v, B, heads):
        sdpa(q, k, v))
    out = {tag: dict(kernel_device_ms=device_ms(kernel, tag=tag),
                     sdpa_device_ms=device_ms(library, tag=f"{tag} sdpa"))
           for tag, (kernel, library) in calls.items()}
    # B5's two launches (the rotation, the attention) apart
    parts = {}
    device_ms(calls["rope_packed_attention"][0], by_name=parts,
              tag="rope_packed_attention by name")
    out["rope_packed_attention"]["kernel_device_ms_by_name"] = parts
    # B12a / B12b at the path's shape beside the default route's block half
    # on the same input and weights, each launch apart
    from ovo_tpu_torch.ops.fused_block import fused_attn_block, fused_mlp_block

    for name, fn, path in (("fused_attn_block", fused_attn_block, _b12a_path),
                           ("fused_mlp_block", fused_mlp_block, _b12b_path)):
        args, kw, default_route = path(
            dev, bf, torch.Generator(device=dev).manual_seed(12))
        parts = {}
        out[name] = dict(
            kernel_device_ms=device_ms(lambda: fn(*args, **kw),
                                       by_name=parts, tag=name),
            kernel_device_ms_by_name=parts,
            default_route_device_ms=device_ms(
                default_route, tag=f"{name} default route"))
        del args, kw, default_route
    heads = 8
    for bk in (256, 1):
        x = _cross_inputs(dev, bf, bk)
        t2i = (x["q"], x["keys"], x["wk"], x["wv"], x["pe"], x["bv"], heads)
        i2t = (x["keys"], x["wk"], x["pe"], x["q"], x["vt"], x["wout"],
               x["bout"], x["g"], x["b"], heads)
        out[f"cross_t2i_keys{bk}"] = dict(
            kernel_device_ms=device_ms(lambda: cross_t2i_from_keys(*t2i),
                                       tag=f"cross_t2i_keys{bk}"),
            library_device_ms=device_ms(_b3_library(x, heads),
                                        tag=f"cross_t2i_keys{bk} library"))
        out[f"cross_i2t_tail_keys{bk}"] = dict(
            kernel_device_ms=device_ms(
                lambda: cross_i2t_tail_from_keys(*i2t),
                tag=f"cross_i2t_tail_keys{bk}"),
            library_device_ms=device_ms(
                _b4_library(x, heads), tag=f"cross_i2t_tail_keys{bk} library"))
        del x, t2i, i2t
        # SAM1's 7 tokens (the 8-token draw's first 7): B3 at 7 and at 8
        # tokens, in turns (the card's clock drifts between calls further
        # apart); and B4
        x8 = _cross_inputs(dev, bf, bk)
        x = _cross_inputs(dev, bf, bk, T=7)
        t2i = (x["q"], x["keys"], x["wk"], x["wv"], x["pe"], x["bv"], heads)
        t2i8 = (x8["q"],) + t2i[1:]
        i2t = (x["keys"], x["wk"], x["pe"], x["q"], x["vt"], x["wout"],
               x["bout"], x["g"], x["b"], heads)
        calls = {"8": lambda: cross_t2i_from_keys(*t2i8),
                 "7": lambda: cross_t2i_from_keys(*t2i)}
        turns = [[k, device_ms(calls[k], tag=f"cross_t2i_sam1_keys{bk} {k}")]
                 for k in ("8", "7", "7", "8")]

        def mean(k):
            return statistics.mean(ms for name, ms in turns if name == k)

        out[f"cross_t2i_sam1_keys{bk}"] = dict(
            kernel_device_ms=mean("7"), eight_tokens_device_ms=mean("8"),
            turns=turns)
        out[f"cross_i2t_tail_sam1_keys{bk}"] = dict(
            kernel_device_ms=device_ms(
                lambda: cross_i2t_tail_from_keys(*i2t),
                tag=f"cross_i2t_tail_sam1_keys{bk}"))
        del x, x8, t2i, t2i8, i2t, calls
        # B7 at the 1280^2 decoder's shape (check_b7's): the kq launch and
        # the tensor-core kernel apart, which the trace must name
        x = _cross_inputs(dev, bf, bk, B=B9_SHAPE["B"], L=B9_SHAPE["L"])
        proj = (x["keys"], x["wk"], x["pe"], x["q"], x["vt"], heads)
        parts = {}
        out[f"cross_i2t_proj_keys{bk}"] = dict(
            kernel_device_ms=device_ms(lambda: cross_i2t_from_keys(*proj),
                                       by_name=parts,
                                       tag=f"cross_i2t_proj_keys{bk}"),
            kernel_device_ms_by_name=parts,
            library_device_ms=device_ms(
                _b7_library(x, heads), tag=f"cross_i2t_proj_keys{bk} library"))
        # an untraced call (UNTRACED) names no kernel
        if parts and not any("i2t_mma_kernel" in k for k in parts):
            raise AssertionError(f"kernel_device: B7 ran {sorted(parts)}, "
                                 f"not its tensor-core kernel")
        del x, proj
        torch.cuda.empty_cache()
    # B9b at check_b9b's shapes, per-prompt and shared q, beside SDPA on
    # the per-head views; the trace must name its tensor-core kernel
    B, heads = B9_SHAPE["B"], B9_SHAPE["heads"]
    for bq in (256, 1):
        q, k, v = _b9b_inputs(dev, bf, bq)
        parts = {}
        out[f"cross_small_head_i2t_q{bq}"] = dict(
            kernel_device_ms=device_ms(
                lambda: cross_attention_small_head(q, k, v, heads),
                by_name=parts, tag=f"cross_small_head_i2t_q{bq}"),
            kernel_device_ms_by_name=parts,
            sdpa_device_ms=device_ms(
                lambda q=_small_head_split(q, B, heads),
                k=_small_head_split(k, B, heads),
                v=_small_head_split(v, B, heads): sdpa(q, k, v),
                tag=f"cross_small_head_i2t_q{bq} sdpa"))
        if parts and not any("small_i2t_mma_kernel" in name
                             for name in parts):
            raise AssertionError(f"kernel_device: B9b ran {sorted(parts)}, "
                                 f"not its tensor-core kernel")
        del q, k, v
    # B13 at check_b13's shape (128 prompts) beside the decoder's unfused
    # tail on the same inputs
    from ovo_tpu_torch.ops.mask_tail import fused_mask_tail, gather_hr0q

    H, W = B13_SHAPE["H"], B13_SHAPE["W"]
    up1g, w2q, b2, hr0, hyper = _b13_inputs(dev, bf, 128)
    hr0q = gather_hr0q(hr0, H, W)
    out["mask_tail_b128"] = dict(
        kernel_device_ms=device_ms(
            lambda: fused_mask_tail(up1g, w2q, b2, hr0q, hyper, H=H, W=W),
            tag="mask_tail_b128"),
        unfused_tail_device_ms=device_ms(
            lambda: _unfused_tail(up1g, w2q, b2, hr0, hyper, H, W),
            tag="mask_tail_b128 unfused tail"))
    del up1g, hr0, hr0q
    torch.cuda.empty_cache()
    # B14 at its gated shapes (check_b14's, f32 scale / bias) beside
    # F.layer_norm on bf16 ones
    for which, (rows, C) in B14_SHAPES.items():
        x, g, b = _b14_inputs(dev, bf, which)
        gx, bx = g.to(bf), b.to(bf)
        out[f"layer_norm_rows_{which}"] = dict(
            kernel_device_ms=device_ms(lambda: layer_norm_rows(x, g, b),
                                       tag=f"layer_norm_rows_{which}"),
            library_device_ms=device_ms(
                lambda: torch.nn.functional.layer_norm(x, (C,), gx, bx),
                tag=f"layer_norm_rows_{which} library"))
    out["untraced"] = UNTRACED
    return out


def _profiler():
    # device activity only: tracing every host op as well slows the
    # host-bound loop several times over, and the busy share would be read
    # against a wall time the tracing made
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CUDA])


def _profile_summary(prof, wall: float, path: str) -> dict:
    """From one traced slice run: the card's busy time (the union of its
    kernel, copy and set intervals) and its share of the same run's wall
    time; device time by kernel, with the whole table written to
    ``path``."""
    events = [e for e in prof.events() if e.device_type.name == "CUDA"
              and e.time_range.end > e.time_range.start]
    busy_us, last = 0.0, float("-inf")
    for start, end in sorted((e.time_range.start, e.time_range.end)
                             for e in events):
        if end > last:
            busy_us += end - max(start, last)
            last = end
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    with open(path, "w") as f:
        f.write(f"wall {wall:.6f} s, device busy {busy_us / 1e3:.3f} ms\n")
        f.write("device ms\tcount\tname\n")
        for name, (ms, n) in rows:
            f.write(f"{ms:.3f}\t{n}\t{name}\n")
    return dict(profile_device_busy_ms=busy_us / 1e3,
                profile_device_busy_share=busy_us / 1e6 / wall,
                profile_device_events=len(events),
                profile_top_device=[[k[:80], ms, n]
                                    for k, (ms, n) in rows[:15]])


# ---------------------------------------------------------------------------
# the last modules: the merger's train step, the multi-process paths and the
# viewer (no TPU kernel lies on any of these paths)
# ---------------------------------------------------------------------------

# the learned merger at the paper's width (SigLIP's 1152, 8 heads of 144,
# depth 5, head MLP 512), 1024 instances x 3 clips learning to pick the
# middle clip
MERGER_TRAIN = dict(d_model=1152, depth=5, n_heads=8, mlp_hidden=512,
                    batch=1024, steps=20, lr=1e-4)
# the card against the CPU, f32 sums in another order. Step 1's loss (a
# mean of 1024 cosines) within 1e-5 (measured 6e-8 on an H100). Its
# gradients sum 3072 token products with much cancellation: a float32
# evaluation of them is itself determined only to 2.2e-4 of their L2 norm
# (the CPU's float32 against float64, batch 256), so they are held to 1e-3
# of it (relative L2). The loss after the first update within 2e-5: an
# update differs by 2 lr where a gradient sits within float32 noise of
# zero (the CPU's float32 and float64 runs: 2.0e-6 apart there)
MERGER_LOSS_TOL = 1e-5
MERGER_GRAD_REL = 1e-3
MERGER_STEP2_TOL = 2e-5


def run_merger_train(dev) -> dict:
    """The merger's train step (``models/merger.make_train_step``: autograd
    through the forward, torch.optim.Adam) at full width: two steps on the
    card against the same steps on the CPU (step 1's loss and gradients,
    the loss after the first update), then MERGER_TRAIN's steps on the
    card; ms per step (CUDA events, median of steps 2 on), peak memory, the
    loss first and last. Attention has head size 144, so it takes the plain
    route: no kernel launches."""
    from ovo_tpu_torch.models.merger import init_merger, make_train_step
    from ovo_tpu_torch.ops import cuda_build

    c = MERGER_TRAIN
    params = init_merger(torch.Generator(device=dev).manual_seed(0),
                         d_model=c["d_model"], depth=c["depth"],
                         n_heads=c["n_heads"], mlp_hidden=c["mlp_hidden"],
                         device=dev)
    clips_cpu = torch.randn((c["batch"], 3, c["d_model"]),
                            generator=torch.Generator().manual_seed(1))
    grads = {}

    def keep(tag):
        def hook(ps):
            if tag not in grads:
                grads[tag] = [p.grad.detach().cpu().clone().double()
                              for p in ps.parameters()]
        return hook

    cpu_params = copy.deepcopy(params).cpu()
    cpu_step = make_train_step(cpu_params, c["lr"], c["n_heads"],
                               grad_hook=keep("cpu"))
    t0 = time.time()
    cpu_losses = [float(cpu_step(clips_cpu, clips_cpu[:, 1]))
                  for _ in range(2)]
    cpu_step_s = (time.time() - t0) / 2
    clips = clips_cpu.to(dev)
    step = make_train_step(params, c["lr"], c["n_heads"],
                           grad_hook=keep("card"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    cuda_build.reset_launch_counts()
    losses, times = [], []
    for _ in range(c["steps"]):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        losses.append(step(clips, clips[:, 1]))
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    counts = cuda_build.launch_counts()
    losses = [float(x) for x in losses]
    diff2 = sum(float(((a - b) ** 2).sum())
                for a, b in zip(grads["card"], grads["cpu"]))
    norm2 = sum(float((b ** 2).sum()) for b in grads["cpu"])
    grad_rel = (diff2 / norm2) ** 0.5
    grad_max = max(float((a - b).abs().max())
                   for a, b in zip(grads["card"], grads["cpu"]))
    loss_err = abs(losses[0] - cpu_losses[0])
    step2_err = abs(losses[1] - cpu_losses[1])
    if not (loss_err <= MERGER_LOSS_TOL and grad_rel <= MERGER_GRAD_REL
            and step2_err <= MERGER_STEP2_TOL):
        raise AssertionError(
            f"merger_train: card vs CPU: loss {loss_err}, gradients "
            f"{grad_rel} of their norm, loss after the update {step2_err}")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"merger_train: losses {losses}")
    if any(counts.values()):
        raise AssertionError(f"merger_train: kernels launched: {counts}")
    return dict(config=c, parameters=sum(p.numel()
                                         for p in params.parameters()),
                loss_first=losses[0], loss_last=losses[-1],
                ms_per_step=statistics.median(times[1:]),
                first_step_ms=times[0], peak_memory_gb=peak,
                cpu_step_s=cpu_step_s, step1_loss_err=loss_err,
                step1_grad_rel_l2=grad_rel, step1_grad_max_abs_err=grad_max,
                step2_loss_err=step2_err, launches={})


def map_snapshot(sem_map) -> dict:
    """A finished run's map, instances, store and per-keyframe descriptors
    on the host."""
    import dataclasses

    st = sem_map.slam_backbone.get_map()
    n = int(st.count)
    ovo = sem_map.ovo
    return dict(
        obj_ids=st.obj_ids[:n].cpu().numpy(),
        points=st.points[:n].cpu().numpy(), active=ovo.active_ids(),
        store={f.name: getattr(ovo.store, f.name).cpu().numpy()
               for f in dataclasses.fields(ovo.store)},
        descs={k: tuple(t.cpu().numpy() for t in v)
               for k, v in ovo.kf_descriptors.items()})


def snapshot_diff(a: dict, b: dict) -> dict:
    """Integer entries that differ between two snapshots (map ids, points,
    active ids, the store's integer fields, the descriptor records' ids and
    keeps) and the largest descriptor difference."""
    def ne(x, y):
        return int(np.size(x) + np.size(y)) if np.shape(x) != np.shape(y) \
            else int((x != y).sum())

    ints = ne(a["obj_ids"], b["obj_ids"]) + ne(a["points"], b["points"]) \
        + ne(a["active"], b["active"])
    flt = 0.0
    for k, x in a["store"].items():
        if x.dtype.kind == "f" and x.shape == b["store"][k].shape:
            flt = max(flt, float(np.abs(x - b["store"][k]).max(initial=0)))
        else:
            ints += ne(x, b["store"][k])
    if sorted(a["descs"]) != sorted(b["descs"]):
        ints += 1
    for k in set(a["descs"]) & set(b["descs"]):
        (i1, d1, k1), (i2, d2, k2) = a["descs"][k], b["descs"][k]
        ints += ne(i1, i2) + ne(k1, k2)
        flt = max(flt, float(np.abs(d1 - d2).max(initial=0))
                  if d1.shape == d2.shape else np.inf)
    return dict(int_mismatches=ints, desc_max_abs=flt)


MULTIDEVICE_PARALLEL = {"point_shard": True, "shard_query": True,
                        "dp_embed": True}


def run_multidevice(dev, batch: dict) -> dict:
    """The batch_slice with ``parallel`` MULTIDEVICE_PARALLEL in a world of
    one on nccl (the process joins a one-rank default group): the instance
    map, active ids, store and descriptors bit-equal to the batch_slice's
    run (``batch``: its map_snapshot). Then ``python -m
    ovo_tpu_torch.parallel.dryrun`` as a user runs it, with no arguments:
    nccl, a rank a card, so a world of one (one card holds no wider nccl
    world)."""
    from pathlib import Path

    import torch.distributed as dist

    from ovo_tpu_torch.parallel.mesh import init_world

    with tempfile.TemporaryDirectory() as tmp:
        init_world("nccl", 0, 1, f"file://{tmp}/init")
        try:
            # the communicator is made by the first collective, before the
            # run
            dist.all_reduce(torch.zeros(1, device=dev))
            torch.cuda.synchronize()
            record, sem_map = run_slice(dev, live=True, frames=30,
                                        sam_batch=2,
                                        parallel=MULTIDEVICE_PARALLEL)
            snap = map_snapshot(sem_map)
            res = sem_map.ovo.classify_instances(QUERY_CLASSES,
                                                 QUERY_TEMPLATE)
        finally:
            dist.destroy_process_group()
    del sem_map
    diff = snapshot_diff(snap, batch)
    record.update(vs_batch_slice=diff, classified=int(
        (res["classes"] >= 0).sum()), mesh=[1, 1], backend="nccl")
    if diff["int_mismatches"] or diff["desc_max_abs"]:
        raise AssertionError(f"multidevice_slice: differs from the "
                             f"batch_slice by {diff}")
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "ovo_tpu_torch.parallel.dryrun"],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun exited {proc.returncode}:\n"
                             f"{proc.stderr[-3000:]}")
    dry = json.loads(proc.stdout.strip().splitlines()[-1])
    if (dry["backend"], dry["world"], dry["ranks_ok"]) != ("nccl", 1, 1):
        raise AssertionError(f"dryrun's defaults ran {dry}")
    record["dryrun"] = dict(dry, seconds=time.time() - t0)
    return record


# the last frame segments, so the last streamed map is the final map
VIEWER_FRAMES = 21
VIEWER_QUERY = "chair"


def _pipeline_read_sites(fn) -> set:
    """The lines of ``fn`` (a host read of ``mapping/pipeline.py``:
    ``stream_rows`` for a streamed frame, ``live_obj_ids`` for a query), as
    the sync report names them."""
    import inspect

    lines, first = inspect.getsourcelines(fn)
    return {f"mapping/pipeline.py:{n}"
            for n in range(first, first + len(lines))}


class _RecordingPipe:
    """The mapper's end of the query pipe; ``on_send`` sees each answer
    before it goes out."""

    def __init__(self, conn, on_send):
        self.conn, self.on_send = conn, on_send

    def poll(self, timeout=0.0):
        return self.conn.poll(timeout)

    def recv(self):
        return self.conn.recv()

    def send(self, vals):
        self.on_send(vals)
        self.conn.send(vals)


def run_viewer(dev) -> dict:
    """The precomputed-mask slice (PE-Core-L14-336, 2^21-point map) on the
    scene's first VIEWER_FRAMES frames with ``vis.stream: true``: a spawned
    headless viewer (``viz/visualizer.stream_pcd``) takes every segment
    step's map and issues one scripted query (VIEWER_QUERY). The exports
    written; the final instance and RGB clouds equal to the final map's,
    byte for byte; the answered values equal to
    ``Visualizer.query_values_per_point`` called directly on the same map;
    the only host syncs in the frame loop, besides the query's, the stream's
    reads (``stream_rows``); the wall of ``_close_stream``."""
    from pathlib import Path

    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import (OVOSemMap, live_obj_ids,
                                                stream_rows)
    from ovo_tpu_torch.viz import visualizer as viz

    scene = replica_wall_scene(VIEWER_FRAMES)
    masks = {fid: scene.masks(fid) for fid in range(0, len(scene), 10)}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads(json.dumps(REPLICA_CONFIG))
        cfg["vis"] = {"stream": True, "show_stream": False}
        sem_map = OVOSemMap(cfg, tmp, dataset=scene, device=dev,
                            mask_source=CallableMaskSource(
                                lambda img, fid: masks[fid], 96, dev))
        sem_map.enable_stream(spawn_process=True, queries=[VIEWER_QUERY])
        served, query_spans, streamed = [], [], []

        def on_send(vals):
            # the direct call's own reads stay out of the query's count
            torch.cuda.set_sync_debug_mode(0)
            obj = live_obj_ids(sem_map.slam_backbone.get_map())
            served.append((np.asarray(vals), viz.Visualizer(
                sem_map.ovo).query_values_per_point(obj, VIEWER_QUERY)))
            torch.cuda.set_sync_debug_mode("warn")

        sem_map.query_pipe = _RecordingPipe(sem_map.query_pipe, on_send)
        serve, close, put, drain = (
            sem_map._serve_stream_query, sem_map._close_stream,
            sem_map.pcd_queue.put, sem_map.ovo.complete_semantic_info)
        # the frame loop ends where the run's last drain starts (a query
        # drains the queue too, inside its span)
        loop_end, serving = [], []

        def timed_serve(*a, **k):
            n0, s0 = len(caught), len(served)
            serving.append(True)
            serve(*a, **k)
            serving.pop()
            if len(served) > s0:
                query_spans.append((n0, len(caught)))

        def marked_drain():
            if not serving and not loop_end:
                loop_end.append(len(caught))
            drain()

        close_s = []

        def timed_close():
            t0 = time.time()
            close()
            close_s.append(time.time() - t0)

        def counted_put(item):
            if item is not None:
                streamed.append(len(item[0]))
            put(item)

        sem_map._serve_stream_query = timed_serve
        sem_map._close_stream = timed_close
        sem_map.pcd_queue.put = counted_put
        sem_map.ovo.complete_semantic_info = marked_drain
        torch.cuda.synchronize()
        t0 = time.time()
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sem_map.run()
        torch.cuda.set_sync_debug_mode(0)
        wall = time.time() - t0
        out = Path(tmp) / "stream_out"
        names = sorted(p.name for p in out.glob("*.ply"))
        st = sem_map.slam_backbone.get_map()
        pts, obj, cols = stream_rows(st)
        viz.write_ply(Path(tmp) / "inst.ply", pts, viz.instance_colors(obj))
        viz.write_ply(Path(tmp) / "rgb.ply", pts, cols)
        same_inst = (out / "stream_final_instances.ply").read_bytes() == \
            (Path(tmp) / "inst.ply").read_bytes()
        same_rgb = (out / "stream_final_rgb.ply").read_bytes() == \
            (Path(tmp) / "rgb.ply").read_bytes()
        err = (out / "viewer_err.txt").read_text() \
            if (out / "viewer_err.txt").exists() else None
    in_query = {i for a, b in query_spans for i in range(a, b)}

    def site(w):
        return f"{w.filename.split('ovo_tpu_torch/')[-1]}:{w.lineno}"

    loop_syncs = [site(w) for i, w in enumerate(caught[:loop_end[0]])
                  if "synchroniz" in str(w.message) and i not in in_query]
    # the query reads of the map only its ids (``live_obj_ids``)
    query_map_reads = [site(caught[i]) for i in sorted(in_query)
                       if "synchroniz" in str(caught[i].message)
                       and site(caught[i]).startswith("mapping/pipeline.py")]
    want = {"stream_final_instances.ply", "stream_final_rgb.ply",
            "stream_frustum.ply",
            f"stream_query_{VIEWER_QUERY}_query.ply"}
    if err or not want <= set(names):
        raise AssertionError(f"viewer: exports {names}, viewer error {err}")
    if not (same_inst and same_rgb):
        raise AssertionError("viewer: the streamed final map differs from "
                             "the map")
    if len(served) != 1 or not np.array_equal(*served[0]):
        raise AssertionError(f"viewer: {len(served)} queries answered, "
                             f"values equal to the direct call: "
                             f"{[np.array_equal(*s) for s in served]}")
    if set(loop_syncs) - _pipeline_read_sites(stream_rows):
        raise AssertionError(f"viewer: host syncs in the frame loop: "
                             f"{collections.Counter(loop_syncs)}")
    if set(query_map_reads) - _pipeline_read_sites(live_obj_ids):
        raise AssertionError(f"viewer: the query's map reads: "
                             f"{collections.Counter(query_map_reads)}")
    return dict(frames=len(scene), keyframes=sem_map.ovo.kf_id,
                seconds=wall, keyframes_per_s=sem_map.ovo.kf_id / wall,
                streamed_frames=len(streamed), streamed_points=streamed,
                map_points=len(pts), exports=names,
                query_points=len(served[0][0]),
                query_max=float(served[0][0].max()),
                host_syncs_in_loop=len(loop_syncs),
                host_syncs_per_streamed_frame=len(loop_syncs)
                / max(len(streamed), 1),
                query_syncs=len(in_query),
                query_map_reads=len(query_map_reads),
                close_stream_s=close_s[0])


def _reference_cli_parallel() -> dict:
    """``--parallel_scenes 2`` on two 64x96 scenes (the reference_cli's
    config, the factory's seeded weights on the card in every process)
    against the serial run: equal points and object ids per scene, labels
    equal where the instance's top-2 margin is above 1e-4, equal metrics
    when the labels are equal; each run's wall."""
    import os
    from pathlib import Path

    from ovo_tpu_torch.eval.transfer import match_labels_to_vtx
    from ovo_tpu_torch.run_eval import load_representation
    from ovo_tpu_torch.utils import io as io_utils
    from ovo_tpu_torch.utils import yaml_subset

    cam = REFERENCE_CLI["cam"]
    scenes = {"smoke_par0": WallScene(8, cam["H"], cam["W"], cam["fx"],
                                      cam["fy"], cam["cx"], cam["cy"], seed=3,
                                      cell=0.8),
              "smoke_par1": WallScene(6, cam["H"], cam["W"], cam["fx"],
                                      cam["fy"], cam["cx"], cam["cy"], seed=6,
                                      cell=0.8)}
    cwd, out = os.getcwd(), {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, wall in scenes.items():
            write_replica_scene(tmp, name, wall, gt_stride=1)
        root = cli_config_root(tmp, "smoke_par0", REFERENCE_CLI)
        (root / "Replica" / "smoke_par1.yaml").write_text(
            json.dumps(REFERENCE_CLI, indent=2))
        classes = yaml_subset.load(root / "Replica" / "eval_info.yaml")[
            "class_names_reduced"]
        os.chdir(tmp)
        try:
            for exp, extra in (("serial", []),
                               ("par", ["--parallel_scenes", "2"])):
                argv = (["--dataset_name", "Replica", "--scenes", *scenes,
                         "--experiment_name", exp, "--device", "cuda",
                         "--run", "--segment", "--eval"] + extra)
                t0 = time.time()
                metrics = _cli(argv, root)
                wall = time.time() - t0
                per = {}
                for name in scenes:
                    d = Path(tmp) / "data/output/Replica" / exp
                    ovo, _ = load_representation(d / name, device="cpu")
                    per[name] = dict(
                        ckpt=io_utils.load_ckpt(d / name / "ovo_map.ckpt"),
                        sims=ovo.query(classes, [QUERY_TEMPLATE]),
                        ids=ovo.active_ids(),
                        labels=io_utils.read_labels(
                            d / "replica" / f"{name}.txt"),
                        mesh=io_utils._read_ply_vertices(
                            Path(tmp) / "data/input/Datasets/Replica"
                            / f"{name}_mesh.ply"))
                out[exp] = dict(metrics=metrics, wall=wall, per=per)
        finally:
            os.chdir(cwd)
    labels_equal = True
    for name in scenes:
        s, p = out["serial"]["per"][name], out["par"]["per"][name]
        ms, mp = s["ckpt"]["map_params"], p["ckpt"]["map_params"]
        if not (np.array_equal(ms["xyz"], mp["xyz"])
                and np.array_equal(ms["obj_ids"], mp["obj_ids"])
                and np.array_equal(s["ids"], p["ids"])):
            raise AssertionError(f"reference_cli: --parallel_scenes 2 map "
                                 f"of {name} differs from the serial run")
        top2 = np.sort(s["sims"], axis=1)
        clear_ids = s["ids"][top2[:, -1] - top2[:, -2] > 1e-4].tolist()
        mesh_ins, _, _ = match_labels_to_vtx(
            np.asarray(ms["obj_ids"]).reshape(-1), np.asarray(ms["xyz"]),
            s["mesh"])
        clear = np.isin(mesh_ins, clear_ids)
        if not np.array_equal(s["labels"][clear], p["labels"][clear]):
            raise AssertionError(f"reference_cli: --parallel_scenes 2 "
                                 f"labels of {name} differ")
        labels_equal &= bool(np.array_equal(s["labels"], p["labels"]))
    if labels_equal and json.dumps(out["serial"]["metrics"]) != json.dumps(
            out["par"]["metrics"]):
        raise AssertionError("reference_cli: --parallel_scenes 2 metrics "
                             "differ from the serial run's")
    return dict(scenes=list(scenes), labels_equal=labels_equal,
                miou=out["par"]["metrics"]["iou"],
                serial_s=out["serial"]["wall"], parallel_s=out["par"]["wall"])


def main(argv) -> int:
    """No arguments: every phase. ``--profile PATH [--image-size N |
    --crop | --cli | --sam1 | --orb | --gaussian]``: only gpu, build and
    the amg_slice
    (or, at 1280, the amg1280_slice; with ``--crop`` the crop_slice; with
    ``--cli`` the cli, its ``--run`` loop traced; with ``--sam1`` the
    sam1_slice; with ``--orb`` the orb_slice; with ``--gaussian`` the
    gaussian_slice)
    three times: untraced, then with the card's
    activity traced by torch.profiler (the busy share is read within that
    run, the kernel table written to PATH), then untraced again."""
    profile_path = argv[argv.index("--profile") + 1] \
        if "--profile" in argv else None
    image_size = int(argv[argv.index("--image-size") + 1]) \
        if "--image-size" in argv else 1024
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ovo_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name = torch.cuda.get_device_name(0)
    part, peaks = peaks_for(name)
    emit("gpu", nvidia_smi=smi, name=name, peaks_from=f"H100 {part}",
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.time()
    cuda_build.build_all()
    for k in cuda_build.KERNELS:
        cuda_build.library(k)
    emit("build", seconds=time.time() - t0, kernels=list(cuda_build.KERNELS))

    if profile_path and "--cli" in argv:
        # as below: untraced, traced (the --run loop), untraced again
        emit("cli", **run_cli(dev))
        emit("profile", **run_cli(dev, profile_path=profile_path))
        emit("cli", **run_cli(dev))
        return 0
    if profile_path:
        # the first run carries the process's one-time costs; the traced
        # run's wall is read against the untraced run after it
        kw = dict(live=True, image_size=image_size,
                  frames=60 if image_size == 1024 else 30)
        tag = "amg_slice" if image_size == 1024 else f"amg{image_size}_slice"
        if "--crop" in argv:
            kw, tag = dict(frames=30, clip=CROP_CLIP), "crop_slice"
        if "--sam1" in argv:
            kw, tag = dict(live=True, frames=30, sam1=True), "sam1_slice"
        if "--orb" in argv:
            kw, tag = dict(live=True, frames=30, orb=True), "orb_slice"
        if "--gaussian" in argv:
            kw, tag = dict(live=True, frames=GAUSSIAN_FRAMES,
                           gaussian=True), "gaussian_slice"
        emit(tag, **run_slice(dev, **kw)[0])
        emit("profile", **run_slice(dev, profile_path, **kw)[0])
        emit(tag, **run_slice(dev, **kw)[0])
        return 0

    # f32: 1e-4 (the kernels reorder the sums). bf16: B5 and its plain
    # version both round the normalized softmax weights to bf16 before p.v
    # (as the reference does), so a weight on a rounding edge may flip; B6
    # and its plain version both keep them in f32 (the kernel as p_hi +
    # p_lo), as the reference's kernel does; both round the output. The
    # outputs here are attention means of N(0,1) values, below ~0.5 (B5)
    # and ~0.25 (B6) in magnitude, where one bf16 step is 2^-9 and 2^-10.
    # The limits are a few such steps: measured errors were 3.9e-3 (B5's
    # first design) and 9.8e-4 (B6) on an H100. B6's weights rounded once
    # (the reference's XLA route) stay under 4e-3 as well: B6 also holds
    # ATTN_SHARE, on its dense inputs.
    # B1-B4 in bf16 (tests/test_torch_cuda_kernels.py says the same): B1 and
    # its plain version both keep the weights in f32 and round once, means
    # of N(0,1) values below 1: 1e-2. B2 rounds the normalized weights on
    # both sides, so a weight on a rounding edge may flip a step: 1e-2. B3
    # rounds them too, and its output adds an N(0,1) bias (|out| < ~4, one
    # step 2^-6 at the top): 3e-2. B4's output is a LayerNorm of order-1
    # values up to ~4 after two more roundings (attn, y): 6e-2. Besides,
    # B1-B5 and B11 hold a step-share limit (ATTN_SHARE, B3_SHARE).
    results = {}
    checks = [(check_b5, "b5", 1e-2, {}), (check_b6, "b6", 4e-3, {}),
              (check_b1, "b1", 1e-2, {})]
    checks += [(check_b2, f"b2_{w}", 1e-2, {"which": w}) for w in B2_SHAPES]
    checks += [(check_b3, f"b3_keys{bk}", 3e-2, {"Bk": bk}) for bk in (1, 256)]
    checks += [(check_b4, f"b4_keys{bk}", 6e-2, {"Bk": bk})
               for bk in (1, 256)]
    # B3 / B4 at SAM1's 7 tokens in bf16 (the SAM1 decoder's dtype), the
    # same limits: B3 on the fixed-width instance (its eighth row masked),
    # B4 with its eighth token column masked
    checks += [(check_b3, f"b3_sam1_keys{bk}", 3e-2, {"Bk": bk, "T": 7})
               for bk in (1, 256)]
    checks += [(check_b4, f"b4_sam1_keys{bk}", 6e-2, {"Bk": bk, "T": 7})
               for bk in (1, 256)]
    # B9a / B9b, B7, B8 at the 1280^2 decoder's shapes, shared and per-prompt
    # image sides. bf16: both sides round the normalized weights, so a
    # weight on a rounding edge moves an output a step: B9a's outputs are
    # means over 6400 rows of N(0,1) values, below 1 (step 2^-8): 1e-2; B9b's
    # and B7's over 8 tokens, below 4 (step 2^-6): 3e-2. B8: a LayerNorm
    # times ~1 plus an N(0,1) bias, below 8 (step 2^-5), one f32 value
    # rounded on both sides: 6e-2. B9a, B9b and B7 in bf16 also hold
    # ATTN_SHARE, which their normalized weights left unrounded break.
    checks += [(check_b9a, f"b9a_kv{b}", 1e-2, {"Bk": b}) for b in (1, 256)]
    checks += [(check_b9b, f"b9b_q{b}", 3e-2, {"Bq": b}) for b in (1, 256)]
    checks += [(check_b7, f"b7_keys{b}", 3e-2, {"Bk": b}) for b in (1, 256)]
    checks += [(check_b8, f"b8_res{b}", 6e-2, {"Br": b}) for b in (1, 256)]
    # B10 in bf16: both sides round the normalized weights, as for B2: 1e-2
    # and ATTN_SHARE. In f32 check_b10 also holds it to B10_F32_TOL (3xTF32
    # on the tensor cores), which one TF32 product per f32 product breaks.
    checks += [(check_b10, f"b10_b{b}", 1e-2, {"batch": b})
               for b in B10_BATCHES]
    # B12a / B12b in bf16: the outputs are x plus the block half, below ~8
    # in magnitude on these inputs, where one bf16 step is up to 2^-5; the
    # two sides also round the same intermediates (LN, q, k, v, p, heads,
    # hidden), and one that sits on a rounding edge moves the output by a
    # few 2^-8 more: 6e-2. Measured 1.6e-2 on an H100 (first run).
    checks += [(check_b12a, "b12a", 6e-2, {}), (check_b12b, "b12b", 6e-2, {})]
    # B14 in bf16 as B8 (a LayerNorm times ~1 plus an N(0,1) bias, below 8,
    # one f32 value rounded on both sides): 6e-2, and ATTN_SHARE. B11 as B2
    # (both sides round the normalized weights): 1e-2.
    checks += [(check_b14, f"b14_{w}", 6e-2, {"which": w})
               for w in B14_SHAPES]
    checks += [(check_b11, f"b11_{w}", 1e-2, {"which": w})
               for w in B11_SHAPES]
    # B13 is defined in bf16 only. Its f32 product over c1 is summed in
    # another order than the plain version's GEMM, so a product on a bf16
    # rounding edge moves one gelu output a step (at most 2^-5 for |y| < 8)
    # times |hyper| < 4 in the hypernet dot: 0.125. check_b13 also bounds
    # the share of logits that differ (B13_SHARE), which the max-abs limit
    # cannot: the once-rounded gelu tail stays under 0.125. The gate keeps
    # 128 of the 256 grid prompts; both counts are checked.
    checks += [(check_b13, f"b13_b{b}", 0.125, {"B": b}) for b in (128, 256)]
    for check, tag, bf16_tol, kw in checks:
        # B13 is defined in bf16 only; SAM1's decoder runs in bf16
        dtypes = ((torch.bfloat16, bf16_tol),) if (
            check is check_b13 or "sam1" in tag) else (
            (torch.bfloat16, bf16_tol), (torch.float32, 1e-4))
        for dtype, tol in dtypes:
            r = check(dev, dtype, peaks, tol, **kw)
            emit("kernel", **r)
            results[(tag, r["dtype"])] = r
        torch.cuda.empty_cache()

    emit("reference", **run_reference(dev))
    emit("reference_amg", **run_reference_amg(dev))
    emit("reference_sam1", **run_reference_amg(dev, "vit_test", min_area=100))
    emit("reference_utility", **run_reference_utility(dev))
    utility = run_utility_path(dev)
    emit("utility_path", **utility)
    torch.cuda.empty_cache()
    emit("reference_batch", **run_reference_batch(dev))
    ref_dec = run_reference_decoder(dev)
    emit("reference_decoder", **ref_dec)
    torch.cuda.empty_cache()
    emit("reference_crop", **run_reference_crop(dev))
    pe_slice, pe_map = run_slice(dev)
    emit("slice", **pe_slice)
    amg = run_slice(dev, live=True)[0]
    emit("amg_slice", **amg)
    torch.cuda.empty_cache()
    # of the maps, only the slice's (for the query phase) stays alive across
    # the live runs, so their peaks read their own
    amg1280 = run_slice(dev, live=True, frames=30, image_size=1280)[0]
    emit("amg1280_slice", **amg1280)
    torch.cuda.empty_cache()
    batch, batch_map = run_slice(dev, live=True, frames=30, sam_batch=2)
    emit("batch_slice", **batch)
    batch = map_snapshot(batch_map)
    del batch_map
    gc.collect()
    torch.cuda.empty_cache()
    emit("multidevice_slice", **run_multidevice(dev, batch))
    torch.cuda.empty_cache()
    emit("sam1_slice", **run_slice(dev, live=True, frames=30, sam1=True)[0])
    torch.cuda.empty_cache()
    emit("orb_slice", **run_slice(dev, live=True, frames=30, orb=True)[0])
    torch.cuda.empty_cache()
    emit("reference_gaussian", **run_reference_gaussian(dev))
    emit("gaussian_slice", **run_slice(dev, live=True, frames=GAUSSIAN_FRAMES,
                                       gaussian=True)[0])
    torch.cuda.empty_cache()
    emit("checkpoint", **run_checkpoint(dev))
    torch.cuda.empty_cache()
    emit("merger_train", **run_merger_train(dev))
    torch.cuda.empty_cache()
    crop, crop_map = run_slice(dev, frames=30, clip=CROP_CLIP)
    emit("crop_slice", **crop)
    text_depth = len(crop_map.ovo.embedder.model.text.blocks)
    emit("query", **run_query(dev, crop_map.ovo,
                              {"windowed_attention": text_depth}))
    emit("query", **run_query(dev, pe_map.ovo, {}))
    del pe_map, crop_map
    gc.collect()
    torch.cuda.empty_cache()
    emit("viewer", **run_viewer(dev))
    torch.cuda.empty_cache()
    emit("reference_cli", **run_reference_cli(dev),
         parallel_scenes=_reference_cli_parallel())
    emit("reference_orb", **run_reference_orb(dev))
    cli = run_cli(dev)
    emit("cli", **cli)
    emit("kernel_device", **run_kernel_device(dev))
    launches = dict(amg["launches"],
                    fused_attention=crop["launches"]["fused_attention"],
                    fused_attn_block=cli["launches"]["fused_attn_block"],
                    fused_mlp_block=cli["launches"]["fused_mlp_block"],
                    cross_i2t_proj=ref_dec["launches"]["cross_i2t_proj"],
                    **{k: amg1280["launches"][k] for k in (
                        "cross_small_head_t2i", "cross_small_head_i2t",
                        "residual_layer_norm")},
                    packed_heads_attention=utility["launches"]["packed"][
                        "packed_heads_attention"],
                    mask_tail=utility["launches"]["fused"]["mask_tail"],
                    layer_norm_rows=utility["launches"]["layer_norm_rows"][
                        "layer_norm_rows"])
    emit("kernels", launches=launches)

    rows = []
    # per kernel, the main path's heaviest shape: B2 the stage-3 windows,
    # B3 / B4 / B7 / B9a / B9b / B8 the per-prompt image side of the second
    # layer
    for tag, kname, src, rep in (
            ("b5", "rope_packed_attention", B5_SOURCE, B5_REPLACES),
            ("b6", "masked_pool", B6_SOURCE, B6_REPLACES),
            ("b1", "flash_attention", *AMG_KERNELS["flash_attention"]),
            ("b2_stage3", "windowed_attention",
             *AMG_KERNELS["windowed_attention"]),
            ("b3_keys256", "cross_t2i", *AMG_KERNELS["cross_t2i"]),
            ("b4_keys256", "cross_i2t_tail",
             *AMG_KERNELS["cross_i2t_tail"]),
            ("b10_b96", "fused_attention", B10_SOURCE, B10_REPLACES),
            ("b12a", "fused_attn_block", B12A_SOURCE, B12A_REPLACES),
            ("b12b", "fused_mlp_block", B12B_SOURCE, B12B_REPLACES),
            ("b9a_kv256", "cross_small_head_t2i",
             *ROUTE_KERNELS["cross_small_head_t2i"]),
            ("b9b_q256", "cross_small_head_i2t",
             *ROUTE_KERNELS["cross_small_head_i2t"]),
            ("b8_res256", "residual_layer_norm",
             *ROUTE_KERNELS["residual_layer_norm"]),
            ("b7_keys256", "cross_i2t_proj", *ROUTE_KERNELS["cross_i2t_proj"]),
            ("b11_stage3", "packed_heads_attention",
             *UTILITY_KERNELS["packed_heads_attention"]),
            ("b13_b128", "mask_tail", *UTILITY_KERNELS["mask_tail"]),
            ("b14_pe", "layer_norm_rows",
             *UTILITY_KERNELS["layer_norm_rows"])):
        # B10's path (the SigLIP-384 crops) runs in f32, the others in bf16
        r = results[(tag, "float32" if tag.startswith("b10")
                     else "bfloat16")]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": rep, "launches": launches[kname],
                     "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
