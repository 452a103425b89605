"""The traced window: the profiler, the reading of its Chrome trace into
device intervals and kernel times, their attribution to the harness's
spans, and the per-layer metrics read from them.

A kernel belongs to the span whose host interval holds the host call that
launched it (the trace links each kernel to its runtime call by a
correlation id). The harness's spans are taken with ``time.time_ns``; the
trace's clock is tied to it by one anchor, the runtime call that records
the window's first CUDA event. The card's busy time is the union of its
kernel, copy and set intervals (``chip_smoke._profile_summary``'s
arithmetic).
"""
from __future__ import annotations

import bisect
import importlib.util
import json
import re
from collections import defaultdict
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
N_BREAKDOWN = 10
NAME_CHARS = 96       # of a kernel's demangled name in the breakdown


def start_profiler(device):
    from torch.profiler import ProfilerActivity, profile

    # device activity only (kernels and the runtime calls that launch
    # them): tracing every host op would slow the host-paced loop
    prof = profile(activities=[ProfilerActivity.CUDA])
    prof.start()
    return prof


def union_s(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, last = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > last:
            total += end - max(start, last)
            last = end
    return total


def merged_intervals(intervals):
    out = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return out


def idle_gaps(busy, lo: float, hi: float):
    """The gaps in the merged busy intervals between ``lo`` and ``hi``:
    [(start, length)]."""
    gaps, t = [], lo
    for start, end in busy:
        if start > t:
            gaps.append((t, start - t))
        t = max(t, end)
    if hi > t:
        gaps.append((t, hi - t))
    return gaps


class Spans:
    """Disjoint named host intervals, looked up by time."""

    def __init__(self, spans):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.starts = [s[1] for s in self.spans]

    def at(self, t_ns: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t_ns) - 1
        if i >= 0 and t_ns < self.spans[i][2]:
            return self.spans[i][0]
        return None


def port_kernel_names(root: Path) -> List[str]:
    """The __global__ function names of the port's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s+)?(\w+)\s*\(")
    csrc = root / "ovo_tpu_torch" / "csrc"
    return sorted({m for f in csrc.glob("*.cu*")
                   for m in pat.findall(f.read_text())})


def read_trace(path: Path, anchor_ns: int):
    """Device events of a Chrome trace as (name, cat, start_ns, end_ns,
    launch_ns) in the host's ``time_ns`` clock; the anchor is the earliest
    event-record runtime call (the trace's events are not in time order)."""
    data = json.loads(Path(path).read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    runtime = {}
    records = []
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                runtime[corr] = e["ts"]
            if "EventRecord" in e.get("name", ""):
                records.append(e["ts"])
    anchor_us = min(records) if records else min(
        (e["ts"] for e in events if "ts" in e), default=0.0)
    off_ns = anchor_ns - anchor_us * 1e3
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        start = e["ts"] * 1e3 + off_ns
        corr = (e.get("args") or {}).get("correlation")
        launch = runtime.get(corr)
        out.append((e.get("name", ""), e["cat"], start,
                    start + e["dur"] * 1e3,
                    None if launch is None else launch * 1e3 + off_ns))
    return out


def readings(*, device, trace_path, anchor_ns, spans, n_kf, window_s,
             wall_s, latencies_s, syncs, cfg, traffic, batch, image_hw):
    """Everything the per-layer readers read, from one traced window."""
    import torch

    from . import costs
    from .spec import ROOT

    name = torch.cuda.get_device_name(device)
    _, peaks = costs.peaks_for(name)
    events = read_trace(trace_path, anchor_ns)
    sp = Spans(spans)
    t_lo = anchor_ns
    t_hi = anchor_ns + window_s * 1e9
    busy_iv = [(s, e) for _, _, s, e, _ in events]
    busy_s = union_s(busy_iv) / 1e9
    kernels = port_kernel_names(ROOT)
    pat = re.compile(r"\b(" + "|".join(map(re.escape, kernels)) + r")\b") \
        if kernels else None
    span_dev = defaultdict(float)
    by_name = defaultdict(float)
    port_s = 0.0
    unattributed = 0
    for ev_name, cat, s, e, launch in events:
        dur = (e - s) / 1e9
        by_name[ev_name] += dur
        if pat is not None and cat == "kernel" and pat.search(ev_name):
            port_s += dur
        owner = sp.at(launch) if launch is not None else None
        if launch is None:
            unattributed += 1
        span_dev[owner or "loop"] += dur
    span_host = defaultdict(float)
    for n, a, b in spans:
        span_host[n] += (b - a) / 1e9
    gaps = idle_gaps(merged_intervals(busy_iv), t_lo, t_hi)
    gaps.sort(key=lambda g: -g[1])
    breakdown = {
        "device_ops": [[k[:NAME_CHARS], v] for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:N_BREAKDOWN]],
        "idle_gaps": [[sp.at(g0) or "loop", length / 1e9]
                      for g0, length in gaps[:N_BREAKDOWN]]}
    flops = _config_flops(cfg)
    kf_costs = costs.keyframe_costs(flops.parts(cfg, batch, image_hw), peaks)
    launches = {}
    if device.type == "cuda":
        from ovo_tpu_torch.ops import cuda_build

        launches = cuda_build.launch_counts()
    r = SimpleNamespace(
        n_kf=n_kf, window_s=window_s, wall_s=wall_s, busy_s=busy_s,
        latencies_s=latencies_s,
        trace_window_s=window_s, span_device_s=dict(span_dev),
        span_host_s=dict(span_host), syncs=syncs, costs=kf_costs,
        launches=launches, port_kernel_s=port_s, peaks=peaks,
        embed_type=cfg["program"]["semantic"]["clip"]["embed_type"],
        breakdown=breakdown)
    r.facts = {"trace_device_events": len(events),
               "trace_unattributed_events": unattributed,
               "trace_span_device_s": dict(span_dev),
               "model_gflop_per_kf": {k: v / 1e9 for k, v in
                                      kf_costs["flops"].items()},
               "kernel_calls_per_kf": kf_costs["calls"],
               "kernel_launches": {k: v for k, v in launches.items() if v}}
    return r


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config_flops(cfg):
    return _load(HERE / "flops" / f"{cfg['name']}.py",
                 f"portbench_flops_{cfg['name'].replace('-', '_')}")


def per_layer(r, names: Optional[List[str]] = None) -> Dict[str, dict]:
    """Each per-layer metric's reader (``metrics/<name>.py``: ``UNIT`` and
    ``read(r)``) applied to the readings; a reader that finds nothing to
    read returns None and its metric is left out."""
    out = {}
    files = sorted((HERE / "metrics").glob("*.py"))
    for f in files:
        name = f.stem
        if names is not None and name not in names:
            continue
        mod = _load(f, "portbench_metric_" + re.sub(r"\W", "_", name))
        value = mod.read(r)
        if value is not None:
            out[name] = {"value": float(value), "unit": mod.UNIT}
    return out
