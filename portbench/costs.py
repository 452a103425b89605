"""The yardstick's arithmetic: the card's peaks, each kernel call's least
time from its operations and bytes, and the model FLOPs of one keyframe.

Peaks are NVIDIA's data-sheet dense rates (copied from ``chip_smoke.PEAKS``):
bf16 tensor, f32 on the CUDA cores, HBM bytes, TF32 tensor. A kernel call's
bound is the larger of its operations over the peak of its number format
and its bytes (each operand read once, the output written once) over the
memory peak. The kernel calls and their shapes come from running the
reference, in the program's dtype and on the meta device, under
``ops.attention.recording``: the reference calls a kernel-named function
wherever the port launches that kernel.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (bf16 FLOP/s, f32 FLOP/s, bytes/s, TF32 FLOP/s) by the card's name
PEAKS = {
    "PCIe": (756e12, 51e12, 2.0e12, 378e12),
    "NVL": (835e12, 60e12, 3.9e12, 417.5e12),
    "SXM": (989e12, 67e12, 3.35e12, 494.7e12),
}


def peaks_for(device_name: str) -> Tuple[str, Tuple[float, ...]]:
    for key, val in PEAKS.items():
        if key in device_name:
            return key, val
    return "SXM", PEAKS["SXM"]


def flop_rate(dtype: torch.dtype, peaks) -> float:
    """The peak a part computed in ``dtype`` is held to: bf16 tensor cores;
    float32 on the CUDA cores (the port turns TF32 off)."""
    return peaks[0] if dtype == torch.bfloat16 else peaks[1]


def _n(shape) -> int:
    return int(math.prod(shape))


def _attention(q, k, dtype):
    B, H, Lq, D = q
    Lk = k[2]
    flops = 4.0 * B * H * Lq * Lk * D
    nbytes = (2 * B * H * Lq * D + 2 * B * H * Lk * D) * dtype.itemsize
    return flops, nbytes


def call_cost(family: str, kw) -> Tuple[float, float]:
    """(operations, bytes) of one kernel call noted by the reference."""
    dt = kw["dtype"]
    it = dt.itemsize
    if family in ("flash_attention", "windowed_attention", "fused_attention"):
        return _attention(kw["q"], kw["k"], dt)
    if family == "packed_heads_attention":
        (B, Lq, D), Lk, h = kw["q"], kw["k"][1], kw["heads"]
        return _attention((B, h, Lq, D // h), (B, h, Lk, D // h), dt)
    if family == "cross_small_head":
        (Bq, Lq, D), (Bk, Lk, _), h = kw["q"], kw["k"], kw["heads"]
        flops = 4.0 * max(Bq, Bk) * Lq * Lk * D
        return flops, (Bq * Lq * D * 2 + Bk * Lk * D * 2) * it
    if family == "rope_packed_attention":
        B, L, D3 = kw["qkv"]
        D, h = D3 // 3, kw["heads"]
        hd = D // h
        flops = 4.0 * B * h * L * kw["kv_len"] * hd
        return flops, (B * L * D3 + B * L * D) * it + 2 * L * hd // 2 * 4
    if family == "masked_pool":
        (M, H, D), L = kw["q"], kw["v"][1]
        flops = 4.0 * M * H * L * D
        return flops, (2 * M * H * D + H * D + H * L * D) * it + M * L
    if family == "cross_t2i":
        (B, T, D), (Bk, L, dk), h = kw["q"], kw["keys"], kw["heads"]
        dh = D // h
        flops = 2.0 * B * h * T * (L * (2 * dk + dh) + 2 * dk * dh)
        nbytes = (2 * B * T * D + Bk * L * dk + 2 * dk * D + L * D) * it \
            + 4 * D
        return flops, nbytes
    if family in ("cross_i2t_tail", "cross_i2t_proj"):
        (Bk, L, dk), (Bt, T, D), h = kw["keys"], kw["tok"], kw["heads"]
        B, dh = max(Bk, Bt), D // h
        if family == "cross_i2t_tail":
            flops = (2.0 * B * L * (h * T * (dk + 2 * dh) + D * dk + 4 * dk)
                     + 2.0 * B * h * T * dk * dh)
            out = B * L * dk
        else:
            flops = 2.0 * B * L * h * T * (dk + 2 * dh) \
                + 2.0 * B * h * T * dk * dh
            out = B * L * D
        nbytes = (Bk * L * dk + 2 * dk * D + L * D + 2 * Bt * T * D
                  + out) * it + 12 * dk
        return flops, nbytes
    raise KeyError(family)


def call_bound_s(family: str, kw, peaks) -> float:
    """The least time of one kernel call on the card, in seconds. The f32
    fused attention runs three TF32 products per f32 product (its route's
    least time, as ``chip_smoke.check_b10`` bounds it)."""
    flops, nbytes = call_cost(family, kw)
    if family == "fused_attention" and kw["dtype"] == torch.float32:
        t_ops = 3 * flops / peaks[3]
    else:
        t_ops = flops / flop_rate(kw["dtype"], peaks)
    return max(t_ops, nbytes / peaks[2])


class Part:
    """One part of a keyframe's work: its name, the dtype its FLOPs are
    held to, and a function that runs the reference's version of it on the
    meta device for ``per`` keyframes at once."""

    def __init__(self, name: str, dtype: torch.dtype, run, per: int = 1):
        self.name, self.dtype, self.run, self.per = name, dtype, run, per


def keyframe_costs(parts: List[Part], peaks) -> Dict[str, object]:
    """Per keyframe: model FLOPs by part, the time at peak those FLOPs
    need, and each kernel family's calls and least time."""
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.ops import attention

    flops: Dict[str, float] = {}
    peak_s = 0.0
    bound: Dict[str, float] = {}
    calls_per_kf: Dict[str, float] = {}
    for part in parts:
        counter = FlopCounterMode(display=False)
        with torch.no_grad(), attention.recording() as calls, counter:
            part.run()
        f = counter.get_total_flops() / part.per
        flops[part.name] = f
        peak_s += f / flop_rate(part.dtype, peaks)
        for family, kw in calls:
            bound[family] = (bound.get(family, 0.0)
                             + call_bound_s(family, kw, peaks) / part.per)
            calls_per_kf[family] = (calls_per_kf.get(family, 0.0)
                                    + 1.0 / part.per)
    return {"flops": flops, "peak_s": peak_s, "bound_s": bound,
            "calls": calls_per_kf}
