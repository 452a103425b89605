"""The arithmetic of the per-layer metrics, over the readings of one traced
window (``timeline.readings``). Each metric's file under ``metrics/``
names its unit and which of these reads it; a reader returns None where it
finds nothing to read."""
from __future__ import annotations


def percentile(values, q: float) -> float:
    """Nearest-rank percentile of all ``values`` (q in (0, 100])."""
    s = sorted(values)
    k = max(0, min(len(s) - 1, -(-len(s) * q // 100) - 1))
    return float(s[int(k)])


def idle_share(r):
    """100 - the union of the card's kernel, copy and set intervals over
    the traced window, in %."""
    if r.busy_s <= 0 or r.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.busy_s / r.window_s)


def mfu(r):
    """The model FLOPs of the window's keyframes (from shapes), each part
    at the peak of its dtype (bf16 tensor cores; float32 on the CUDA
    cores, TF32 being off), over the window, in %."""
    if r.n_kf == 0 or r.costs["peak_s"] <= 0:
        return None
    return 100.0 * r.costs["peak_s"] * r.n_kf / r.window_s


def host_syncs_per_kf(r):
    """Host synchronizations in the window (``set_sync_debug_mode("warn")``
    warnings) per segmented keyframe."""
    if r.n_kf == 0:
        return None
    return r.syncs / r.n_kf


def loop_host_ms_per_kf(r):
    """Host time of the loop outside the harness's layer spans (mask
    source, embedder, association, map insert) per segmented keyframe."""
    if r.n_kf == 0:
        return None
    return 1e3 * max(r.wall_s - sum(r.span_host_s.values()), 0.0) / r.n_kf


def span_ms_per_kf(r, *names):
    """Device time of the work launched inside the named spans per
    segmented keyframe."""
    t = sum(r.span_device_s.get(n, 0.0) for n in names)
    if not t or r.n_kf == 0:
        return None
    return 1e3 * t / r.n_kf


def kernels_roofline(r):
    """The port's kernels against their roofline: the sum of each launch's
    least time (the larger of its operations over the peak of its dtype
    and its bytes over the memory peak, at the shapes the reference's
    calls have at this cell's sizes: a family's least time per call
    averaged over a keyframe's calls, times the launches the program
    counted) over the device time of all the port's kernels, in %."""
    if r.port_kernel_s <= 0:
        return None
    bound = 0.0
    for family, per_kf in r.costs["bound_s"].items():
        launched = sum(n for k, n in r.launches.items()
                       if k.startswith(family))
        bound += per_kf / r.costs["calls"][family] * launched
    if bound <= 0:
        return None
    return 100.0 * bound / r.port_kernel_s


def latency_p95_ms(r):
    """The 95th percentile over all keyframes of the traced window of the
    time from the loop taking a keyframe's frame to its association's
    completion on the card, in ms."""
    if not r.latencies_s:
        return None
    return 1e3 * percentile(r.latencies_s, 95)
