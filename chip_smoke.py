"""Drive the PyTorch port on one CUDA card and check it, phase by phase.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure raises, so the script exits
non-zero and prints no result):

  gpu        the card's name and power limit, as nvidia-smi gives them
  build      compile every hand-written kernel from ovo_tpu_torch/csrc
  kernel     each kernel at the main path's shapes, in bf16 and f32, against
             its plain PyTorch version on the same inputs; kernel, plain and
             library times (CUDA events, median of 30 after warm-up) and the
             card's least time for the same work
  reference  the online pipeline on a small synthetic scene with the tiny-pe
             card, on the card (kernels) and on the CPU (plain versions):
             equal point map and instances, descriptors within cosine 1e-4
  reference_amg  the SAM2 automatic-mask program on the hiera_test card at
             256^2 in f32, on the card (kernels) and on the CPU (plain
             versions): equal valid sets, seg maps equal but for < 0.1% of
             pixels (logits within rounding of 0), and the decoder's logits
             for every grid prompt within 2e-5 of the largest
  slice      OVOSemMap on a seeded 680x1200 synthetic scene with Replica
             intrinsics, precomputed-style masks (up to 96 per keyframe) and
             TextRegion on PE-Core-L14-336 at full width with random
             weights, a 2^21-point map; launch counts of every kernel
  amg_slice  the main path: the same run with live masks from the SAM2
             Hiera-L automatic mask generator at 1024^2 (built from the
             config, seeded random bf16 weights, gates at 0); launch counts
             per keyframe, host syncs in the frame loop (none allowed)
  reference_crop  the crop ``hovsg`` embedder on a SigLIP-structured card
             built here (no class token, attention pooling, 224^2 / 14 = 256
             tokens, so the tower takes kernel B10; bidirectional text
             tower), on the small scene, on the card and on the CPU, then
             classify_instances: equal map and instances, descriptors within
             cosine 1e-4, classes equal where the top-2 margin is above 1e-4
  crop_slice the paper's descriptor: the precomputed-mask slice with the
             clip section set to the learned merger over SigLIP-384 crops
             at full width (f32, random weights), 30 frames; 81 B10 launches
             per embedded keyframe (27 layers x the seg, bbox and global
             views), no other kernel, no host sync in the frame loop
  query      classify_instances over the crop_slice's map (SigLIP-384 text
             tower, 64 tokens: 27 B2 launches per class) and over the
             slice's map (PE's causal text tower: the plain route, no
             kernel); similarities finite and in [0, 1] for SigLIP
  kernels    the kernels with their launch counts on the path that runs
             them: the amg_slice (B1-B6) and the crop_slice (B10)

The line before the last is {"kernels": [...]}; the last is
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""
from __future__ import annotations

import collections
import copy
import json
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
# core) FLOP/s, HBM bytes/s
PEAKS = {
    "PCIe": (756e12, 51e12, 2.0e12),
    "NVL": (835e12, 60e12, 3.9e12),
    "SXM": (989e12, 67e12, 3.35e12),
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
# the paper's descriptor (SURVEY.md section 6): SAM2 masks, SigLIP-384
# crops (masked, bbox, global) fused by the learned merger
CROP_CLIP = {"embed_type": "learned", "model_card": "SigLIP-384",
             "mask_res": 336, "k_top_views": 10000, "fusion": "avg_pooling"}
B10_SOURCE = "ovo_tpu_torch/csrc/fused_attention.cu"
B10_REPLACES = "ovo_tpu/ops/attention.py:218"
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


def storage_bytes(*tensors) -> int:
    """Bytes each input holds once (a broadcast view counts its storage)."""
    return sum(t.untyped_storage().nbytes() for t in tensors)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------

def check_b5(dev, dtype, peaks, tol):
    from ovo_tpu_torch.models.layers import rope2d_freqs
    from ovo_tpu_torch.ops.attention import (apply_rope,
                                             rope_packed_attention,
                                             rope_packed_attention_plain)

    B, heads, hd, Lr, L = 7, 16, 64, 577, 584   # 7 views, 577 tokens -> 584
    D = heads * hd
    gen = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((B, L, 3 * D), generator=gen, device=dev).to(dtype)
    cos, sin = rope2d_freqs(24, 24, hd, n_prefix=1, device=dev)
    pad = cos.new_zeros((L - Lr, hd // 2))
    cos, sin = torch.cat([cos, pad]), torch.cat([sin, pad])
    errs = {}
    for kv in (Lr, L):
        got = rope_packed_attention(qkv, cos, sin, heads=heads, kv_len=kv)
        ref = rope_packed_attention_plain(qkv, cos, sin, heads=heads,
                                          kv_len=kv)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError("B5 produced non-finite values")
        errs[kv] = float((got.float() - ref.float()).abs().max())
    err = max(errs.values())
    if err > tol:
        raise AssertionError(f"B5 {dtype}: max_abs_err {err} > {tol}")

    ms = time_ms(lambda: rope_packed_attention(qkv, cos, sin, heads=heads,
                                               kv_len=Lr))
    plain_ms = time_ms(lambda: rope_packed_attention_plain(
        qkv, cos, sin, heads=heads, kv_len=Lr))
    q, k, v = (t.reshape(B, L, heads, hd).transpose(1, 2)
               for t in qkv.split(D, dim=-1))
    q, k, v = apply_rope(q, cos, sin), apply_rope(k, cos, sin), v.contiguous()
    mask = (torch.arange(L, device=dev) < Lr)[None, None, None, :]
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
                bytes=nbytes, flops=flops)


def check_b6(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.masked_pool import masked_pool, masked_pool_plain

    M, H, hd, L = 96, 16, 64, 48 * 72
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn((1, H * hd), generator=gen, device=dev).to(dtype)
    q = q.reshape(1, H, hd).expand(M, H, hd).contiguous()
    k = torch.randn((H, 1, hd), generator=gen, device=dev).to(dtype)
    k = k.expand(H, L, hd)                                 # as TextRegion
    v = torch.randn((L, H * hd), generator=gen, device=dev).to(dtype)
    v = v.reshape(L, H, hd).transpose(0, 1)                # as TextRegion
    # soft-mask support of random regions; the last 30 slots are padding
    mask = torch.rand((M, L), generator=gen, device=dev) < 0.15
    mask[-30:] = False
    scale = hd ** -0.5
    # the path's layout (one probe query, k constant over tokens: a masked
    # mean) and a dense case with random q / k that exercises the softmax
    kd = torch.randn((H, L, hd), generator=gen, device=dev).to(dtype)
    qd = torch.randn((M, H, hd), generator=gen, device=dev).to(dtype)
    err = 0.0
    for qq, kk in ((q, k), (qd, kd)):
        got = masked_pool(qq, kk, v, mask, scale)
        ref = masked_pool_plain(qq, kk, v, mask, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            raise AssertionError("B6 produced non-finite values")
        err = max(err, float((got.float() - ref.float()).abs().max()))
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
                max_abs_err=max(err, err_pad), tol=tol, kernel_ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


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


def _report(name, dtype, err, tol, kernel, plain, library, nbytes, flops,
            peaks, **extra):
    """Check the error, then time kernel, plain version and library call."""
    if err > tol:
        raise AssertionError(f"{name} {dtype}: max_abs_err {err} > {tol}")
    bound_ms, bound_by = _bound(nbytes, flops, dtype, peaks)
    return dict(name=name, dtype=str(dtype)[6:], max_abs_err=err, tol=tol,
                kernel_ms=time_ms(kernel), plain_ms=time_ms(plain),
                library_ms=time_ms(library), bound_ms=bound_ms,
                bound_by=bound_by, bytes=nbytes, flops=flops, **extra)


def _heads_of_packed(gen, n, L, heads, hd, dev, dtype):
    """q, k, v as the Hiera trunk hands them over: head-split strided views
    of one packed (n, L, 3, heads, hd) projection."""
    qkv = torch.randn((n, L, 3, heads, hd), generator=gen,
                      device=dev).to(dtype)
    return qkv, [qkv[:, :, i].transpose(1, 2) for i in range(3)]


def check_b1(dev, dtype, peaks, tol):
    from ovo_tpu_torch.ops.attention import (flash_attention,
                                             flash_attention_plain)

    heads, L, hd = 8, 4096, 72          # Hiera-L global blocks at 1024^2
    gen = torch.Generator(device=dev).manual_seed(1)
    qkv, (q, k, v) = _heads_of_packed(gen, 1, L, heads, hd, dev, dtype)
    err = _max_err(flash_attention(q, k, v), flash_attention_plain(q, k, v),
                   "B1")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("flash_attention", dtype, err, tol,
                   lambda: flash_attention(q, k, v),
                   lambda: flash_attention_plain(q, k, v),
                   lambda: sdpa(q, k, v), storage_bytes(qkv) + q.numel()
                   * q.element_size(), 4.0 * heads * L * L * hd, peaks,
                   shape=[1, heads, L, hd])


# B2 at the main paths' shapes, (windows, heads, lq, lk, hd): the AMG
# windows and decoder tokens, and the SigLIP-384 text tower (one prompt of
# 64 tokens; its q, k, v are head-split views of one packed projection too)
B2_SHAPES = {"stage1": (1024, 2, 64, 64, 72), "stage3": (25, 8, 196, 196, 72),
             "decoder": (256, 8, 8, 8, 32), "text": (1, 16, 64, 64, 72)}


def check_b2(dev, dtype, peaks, tol, which):
    from ovo_tpu_torch.ops.attention import (windowed_attention_plain,
                                             windowed_fused_attention)

    n, heads, lq, lk, hd = B2_SHAPES[which]
    gen = torch.Generator(device=dev).manual_seed(2)
    qkv, (q, k, v) = _heads_of_packed(gen, n, lk, heads, hd, dev, dtype)
    q = q[:, :, :lq]
    err = _max_err(windowed_fused_attention(q, k, v),
                   windowed_attention_plain(q, k, v), "B2")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("windowed_attention", dtype, err, tol,
                   lambda: windowed_fused_attention(q, k, v),
                   lambda: windowed_attention_plain(q, k, v),
                   lambda: sdpa(q, k, v),
                   storage_bytes(qkv) + q.numel() * q.element_size(),
                   4.0 * n * heads * lq * lk * hd, peaks, case=which,
                   shape=[n * heads, lq, lk, hd])


def _cross_inputs(dev, dtype, Bk, B=256, T=8, L=4096, D=128, dk=256):
    gen = torch.Generator(device=dev).manual_seed(3)

    def rnd(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dt)

    return dict(q=rnd(B, T, D), keys=rnd(Bk, L, dk),
                wk=rnd(dk, D, std=dk ** -0.5), wv=rnd(dk, D, std=dk ** -0.5),
                pe=rnd(1, L, D), bv=rnd(D, dt=torch.float32),
                vt=rnd(B, T, D), wout=rnd(D, dk, std=D ** -0.5),
                bout=rnd(dk, dt=torch.float32),
                g=rnd(dk, std=0.1, dt=torch.float32) + 1.0,
                b=rnd(dk, dt=torch.float32))


def check_b3(dev, dtype, peaks, tol, Bk):
    from ovo_tpu_torch.ops.attention import (cross_t2i_from_keys,
                                             cross_t2i_from_keys_plain)

    heads, dh = 8, 16
    x = _cross_inputs(dev, dtype, Bk)
    (B, T, D), (_, L, dk) = x["q"].shape, x["keys"].shape
    args = (x["q"], x["keys"], x["wk"], x["wv"], x["pe"], x["bv"], heads)
    err = _max_err(cross_t2i_from_keys(*args),
                   cross_t2i_from_keys_plain(*args), "B3")
    # the library yardstick: SDPA on the pre-projected per-head operands

    def split(t, n):
        return t.reshape(t.shape[0], n, heads, dh).transpose(1, 2).expand(
            B, heads, n, dh)

    qh = split(x["q"], T)
    kk = split(x["keys"] @ x["wk"] + x["pe"], L)
    vv = split(x["keys"] @ x["wv"] + x["bv"].to(dtype), L)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 2.0 * B * heads * T * (L * (2 * dk + dh) + 2 * dk * dh)
    nbytes = (storage_bytes(*(x[k] for k in ("q", "keys", "wk", "wv", "pe",
                                             "bv")))
              + B * T * D * x["q"].element_size())
    return _report("cross_t2i", dtype, err, tol,
                   lambda: cross_t2i_from_keys(*args),
                   lambda: cross_t2i_from_keys_plain(*args),
                   lambda: sdpa(qh, kk, vv), nbytes, flops, peaks,
                   keys_batch=Bk, shape=[B, T, L, dk, D])


def check_b4(dev, dtype, peaks, tol, Bk):
    from ovo_tpu_torch.ops.attention import (cross_i2t_tail_from_keys,
                                             cross_i2t_tail_from_keys_plain)

    heads, dh = 8, 16
    x = _cross_inputs(dev, dtype, Bk)
    (B, T, D), (_, L, dk) = x["q"].shape, x["keys"].shape
    args = (x["keys"], x["wk"], x["pe"], x["q"], x["vt"], x["wout"],
            x["bout"], x["g"], x["b"], heads)
    err = _max_err(cross_i2t_tail_from_keys(*args),
                   cross_i2t_tail_from_keys_plain(*args), "B4")

    def split(t, n):
        return t.reshape(t.shape[0], n, heads, dh).transpose(1, 2).expand(
            B, heads, n, dh)

    qq = split(x["keys"] @ x["wk"] + x["pe"], L)
    kt, vt = split(x["q"], T), split(x["vt"], T)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = (2.0 * B * L * (heads * T * (dk + 2 * dh) + D * dk + 4 * dk)
             + 2.0 * B * heads * T * dk * dh)
    nbytes = (storage_bytes(*(x[k] for k in ("keys", "wk", "pe", "q", "vt",
                                             "wout", "bout", "g", "b")))
              + B * L * dk * x["keys"].element_size())
    return _report("cross_i2t_tail", dtype, err, tol,
                   lambda: cross_i2t_tail_from_keys(*args),
                   lambda: cross_i2t_tail_from_keys_plain(*args),
                   lambda: sdpa(qq, kt, vt), nbytes, flops, peaks,
                   keys_batch=Bk, shape=[B, T, L, dk, D])


def check_b10(dev, dtype, peaks, tol, batch):
    from ovo_tpu_torch.ops.attention import (fused_attention,
                                             fused_attention_plain)

    heads, L, hd = 16, 729, 72          # SigLIP-384: 27^2 tokens
    gen = torch.Generator(device=dev).manual_seed(10)
    qkv, (q, k, v) = _heads_of_packed(gen, batch, L, heads, hd, dev, dtype)
    err = 0.0
    for kv in (None, L - 100):
        err = max(err, _max_err(fused_attention(q, k, v, kv_len=kv),
                                fused_attention_plain(q, k, v, kv_len=kv),
                                "B10"))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return _report("fused_attention", dtype, err, tol,
                   lambda: fused_attention(q, k, v),
                   lambda: fused_attention_plain(q, k, v),
                   lambda: sdpa(q, k, v), storage_bytes(qkv) + q.numel()
                   * q.element_size(), 4.0 * batch * heads * L * L * hd,
                   peaks, shape=[batch, heads, L, hd])


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

    def masks(self, frame_id, max_masks=96):
        """One mask per wall cell seen, by cell id; pad_masks keeps 96."""
        cell = self.frames[frame_id][4]
        ids, seg = np.unique(cell, return_inverse=True)
        seg = seg.reshape(cell.shape).astype(np.int32)
        n = min(len(ids), max_masks)
        binary = seg[None] == np.arange(n, dtype=np.int32)[:, None, None]
        return seg, binary


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


def run_reference_amg(dev) -> dict:
    """The SAM2 AMG program (hiera_test, 256^2, f32, gates at 0) on the
    card (kernels B2-B4; its global block is short enough for B2) and on
    the CPU (plain versions): equal valid sets, seg maps and binary maps
    equal but for < 0.1% of pixels (a logit within rounding of 0 flips).
    The NMS stages leave few valid masks on random weights, so the
    decoder's logits for all grid prompts are compared as well."""
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource
    from ovo_tpu_torch.models.sam.model import SAMModel

    cpu = SAMModel.random_init("hiera_test", 256, seed=7, device="cpu",
                               compute_dtype="float32")
    card = SAMModel(cpu.cfg, copy.deepcopy(cpu.params), dev)
    kw = dict(points_per_side=8, max_masks=32, candidates=64,
              gate_prompts=32, pred_iou_thresh=0.0, stability_thresh=0.0,
              nms_score_th=0.0)
    rng = np.random.default_rng(7)
    image = (rng.random((180, 320, 3)) * 255).astype(np.uint8)
    out, logits = {}, {}
    for name, model in (("cuda", card), ("cpu", cpu)):
        source = AutomaticMaskSource(model, **kw)
        seg, bmaps, valid = source.get_masks(image)
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
        raise AssertionError(f"reference_amg: valid sets differ or empty "
                             f"({v1.sum()} / {v2.sum()})")
    if seg_diff >= 1e-3 or bmap_diff >= 1e-3:
        raise AssertionError(f"reference_amg: seg maps differ on "
                             f"{seg_diff:.2e} of pixels, masks {bmap_diff:.2e}")
    # f32 sums in another order through the trunk and the decoder: 1.6e-6
    # of the largest logit measured on an H100; the limit is 2e-5 of it
    if logit_err > 2e-5 * max(1.0, logit_scale):
        raise AssertionError(f"reference_amg: decoder logits differ by "
                             f"{logit_err} (largest {logit_scale})")
    return dict(valid_masks=int(v1.sum()), seg_pixels_differing=seg_diff,
                mask_pixels_differing=bmap_diff, logit_max_abs_err=logit_err,
                logit_max_abs=logit_scale)


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


class RecordingMaskSource:
    """Passes ``get_masks`` through and keeps each keyframe's valid-mask
    count as a device tensor (read after the run: no host sync)."""

    def __init__(self, source):
        self.source = source
        self.valid_counts = []

    def get_masks(self, image, frame_id=None):
        seg, bmaps, valid = self.source.get_masks(image, frame_id)
        self.valid_counts.append(valid.sum())
        return seg, bmaps, valid


def run_slice(dev, profile_path=None, live=False, frames=60, clip=None):
    """OVOSemMap on the 680x1200 wall scene, segmenting every 10th frame:
    precomputed-style masks from the scene, or (``live``) the SAM2 Hiera-L
    automatic masks built from the config; ``clip`` replaces the config's
    clip section. Returns the phase's record and the map."""
    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.ops import cuda_build

    tag = "amg_slice" if live else ("crop_slice" if clip else "slice")
    cam = REPLICA_CONFIG["cam"]
    t0 = time.time()
    scene = WallScene(frames, cam["H"], cam["W"], cam["fx"], cam["fy"],
                      cam["cx"], cam["cy"], seed=0)
    masks = {fid: scene.masks(fid) for fid in range(0, len(scene), 10)}
    t_scene = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cfg = json.loads(json.dumps(REPLICA_CONFIG))
        if clip:
            cfg["semantic"]["clip"] = dict(clip)
        # the embedder is built from the config (PE-Core-L14-336, or the
        # clip section given, seeded random weights, on the card); so is the
        # live mask source
        if live:
            cfg["semantic"]["sam"] = dict(SAM_LIVE)
            source = None
        else:
            source = CallableMaskSource(lambda img, fid: masks[fid], 96, dev)
        sem_map = OVOSemMap(cfg, tmp, dataset=scene, device=dev,
                            mask_source=source)
        recorder = RecordingMaskSource(sem_map.ovo.mask_source)
        sem_map.ovo.mask_source = recorder
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        cuda_build.reset_launch_counts()
        prof = _profiler() if profile_path else None
        if prof is not None:
            prof.__enter__()
        t0 = time.time()
        # every synchronizing CUDA call in the run raises a warning, with
        # the Python line that made it; the frame loop ends where the
        # deferred-descriptor drain starts
        loop_end = []
        drain = sem_map.ovo.complete_semantic_info

        def marked_drain():
            loop_end.append(len(caught))
            drain()

        sem_map.ovo.complete_semantic_info = marked_drain
        torch.cuda.set_sync_debug_mode("warn")
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            sem_map.run()
        torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        wall = time.time() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        counts = cuda_build.launch_counts()
        sync_list = [f"{w.filename.split('ovo_tpu_torch/')[-1]}:{w.lineno}"
                     for w in caught if "synchroniz" in str(w.message)]
        loop_syncs = [f"{w.filename.split('ovo_tpu_torch/')[-1]}:{w.lineno}"
                      for w in caught[:loop_end[0]]
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
    expect = {name: 0 for name in cuda_build.KERNELS}
    if clip:
        # the seg, bbox and global views each run the whole tower
        expect.update(fused_attention=3 * depth_layers * n_emb)
    else:
        expect.update(rope_packed_attention=depth_layers * n_emb,
                      masked_pool=n_emb)
    if live:
        expect.update({k: v * n_seg for k, v in AMG_LAUNCHES_PER_KF.items()})
    if n_emb == 0 or counts != expect:
        raise AssertionError(f"{tag}: launches {counts}, expected {expect}")
    if loop_syncs:
        raise AssertionError(f"{tag}: host syncs in the frame loop: "
                             f"{collections.Counter(loop_syncs)}")
    extra = _profile_summary(prof, wall, profile_path) if prof else {}
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
    expect = {name: 0 for name in cuda_build.KERNELS}
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


def main(argv) -> int:
    """No arguments: every phase. ``--profile PATH``: only gpu, build and
    the amg_slice three times: untraced, then with the card's activity
    traced by torch.profiler (the busy share is read within that run, the
    kernel table written to PATH), then untraced again."""
    profile_path = argv[argv.index("--profile") + 1] \
        if "--profile" in argv else None
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

    if profile_path:
        # the first run carries the process's one-time costs; the traced
        # run's wall is read against the untraced run after it
        emit("amg_slice", **run_slice(dev, live=True)[0])
        emit("profile", **run_slice(dev, profile_path, live=True)[0])
        emit("amg_slice", **run_slice(dev, live=True)[0])
        return 0

    # f32: 1e-4 (the online softmax reorders the sums). bf16: the plain
    # version rounds the softmax weights to bf16 before p.v (as the
    # reference does) where the kernels keep them in f32, and both round the
    # output; the outputs here are attention means of N(0,1) values, below
    # ~0.5 (B5) and ~0.25 (B6) in magnitude, where one bf16 step is 2^-9 and
    # 2^-10. The limits are a few such steps: measured errors were 3.9e-3
    # (B5) and 9.8e-4 (B6) on an H100.
    # B1-B4 in bf16 (tests/test_torch_cuda_kernels.py says the same): B1 and
    # its plain version both keep the weights in f32 and round once, means
    # of N(0,1) values below 1: 1e-2. B2 rounds the normalized weights on
    # both sides, so a weight on a rounding edge may flip a step: 1e-2. B3
    # keeps p in f32 where the plain version rounds it, and its output adds
    # an N(0,1) bias (|out| < ~4, one step 2^-6 at the top): 3e-2. B4's
    # output is a LayerNorm of order-1 values up to ~4 after two more
    # roundings (attn, y): 6e-2.
    results = {}
    checks = [(check_b5, "b5", 1e-2, {}), (check_b6, "b6", 4e-3, {}),
              (check_b1, "b1", 1e-2, {})]
    checks += [(check_b2, f"b2_{w}", 1e-2, {"which": w}) for w in B2_SHAPES]
    checks += [(check_b3, f"b3_keys{bk}", 3e-2, {"Bk": bk}) for bk in (1, 256)]
    checks += [(check_b4, f"b4_keys{bk}", 6e-2, {"Bk": bk})
               for bk in (1, 256)]
    # B10 in bf16: both sides round the normalized weights, as for B2: 1e-2
    checks += [(check_b10, f"b10_b{b}", 1e-2, {"batch": b})
               for b in B10_BATCHES]
    for check, tag, bf16_tol, kw in checks:
        for dtype, tol in ((torch.bfloat16, bf16_tol), (torch.float32, 1e-4)):
            r = check(dev, dtype, peaks, tol, **kw)
            emit("kernel", **r)
            results[(tag, r["dtype"])] = r
        torch.cuda.empty_cache()

    emit("reference", **run_reference(dev))
    emit("reference_amg", **run_reference_amg(dev))
    emit("reference_crop", **run_reference_crop(dev))
    pe_slice, pe_map = run_slice(dev)
    emit("slice", **pe_slice)
    amg, _ = run_slice(dev, live=True)
    emit("amg_slice", **amg)
    crop, crop_map = run_slice(dev, frames=30, clip=CROP_CLIP)
    emit("crop_slice", **crop)
    text_depth = len(crop_map.ovo.embedder.model.text.blocks)
    emit("query", **run_query(dev, crop_map.ovo,
                              {"windowed_attention": text_depth}))
    emit("query", **run_query(dev, pe_map.ovo, {}))
    launches = dict(amg["launches"],
                    fused_attention=crop["launches"]["fused_attention"])
    emit("kernels", launches=launches)

    rows = []
    # per kernel, the main path's heaviest shape: B2 the stage-3 windows,
    # B3 / B4 the per-prompt keys of the second layer
    for tag, kname, src, rep in (
            ("b5", "rope_packed_attention", B5_SOURCE, B5_REPLACES),
            ("b6", "masked_pool", B6_SOURCE, B6_REPLACES),
            ("b1", "flash_attention", *AMG_KERNELS["flash_attention"]),
            ("b2_stage3", "windowed_attention",
             *AMG_KERNELS["windowed_attention"]),
            ("b3_keys256", "cross_t2i", *AMG_KERNELS["cross_t2i"]),
            ("b4_keys256", "cross_i2t_tail",
             *AMG_KERNELS["cross_i2t_tail"]),
            ("b10_b96", "fused_attention", B10_SOURCE, B10_REPLACES)):
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
