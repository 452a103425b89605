"""The arithmetic of the end-to-end and per-layer metrics on synthetic
timelines: a stall inside the window has to move them."""
import json
from types import SimpleNamespace

import pytest

from portbench import readers, timeline
from portbench.readers import percentile
from portbench.run import window_keyframes


def test_percentile_is_over_all_values():
    lat = list(range(1, 101))
    assert percentile(lat, 95) == 95
    assert percentile(lat, 100) == 100
    # one slow keyframe among twenty moves the 95th percentile to it
    fast = [10.0] * 19
    assert percentile(fast + [500.0], 95) == 10.0
    assert percentile(fast + [500.0, 500.0], 95) == 500.0


def test_window_keyframes_whole_batches():
    assert window_keyframes(51, 10.0, 8) == 512
    assert window_keyframes(51, 0.3, 1) == 15
    assert window_keyframes(0.1, 0.3, 8) == 8


def _trace(tmp_path, kernels, launches, anchor_us=1000.0):
    # a later event record listed first: the anchor is the earliest
    ev = [{"cat": "cuda_runtime", "name": "cudaEventRecord",
           "ts": anchor_us + 900, "dur": 1, "args": {"correlation": 99}},
          {"cat": "cuda_runtime", "name": "cudaEventRecord", "ts": anchor_us,
           "dur": 1, "args": {"correlation": 0}}]
    for i, ((s, d), l) in enumerate(zip(kernels, launches), 1):
        ev.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                   "ts": l, "dur": 2, "args": {"correlation": i}})
        ev.append({"cat": "kernel", "name": f"k{i}", "ts": s, "dur": d,
                   "args": {"correlation": i}})
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return p


def test_union_idle_and_attribution(tmp_path):
    # kernels (us): [1000, 1100), [1050, 1200) overlap; [1500, 1600)
    path = _trace(tmp_path, [(1000, 100), (1050, 150), (1500, 100)],
                  [990, 995, 1450])
    anchor_ns = 5_000_000_000
    ev = timeline.read_trace(path, anchor_ns)
    busy = timeline.union_s([(s, e) for _, _, s, e, _ in ev]) / 1e9
    assert busy == pytest.approx(300e-6)
    window_s = 1e-3
    r = SimpleNamespace(busy_s=busy, window_s=window_s)
    assert readers.idle_share(r) == pytest.approx(70.0)
    # a stall: the third kernel later by 200 us inside a longer window
    path2 = _trace(tmp_path, [(1000, 100), (1050, 150), (1700, 100)],
                   [990, 995, 1650])
    ev2 = timeline.read_trace(path2, anchor_ns)
    busy2 = timeline.union_s([(s, e) for _, _, s, e, _ in ev2]) / 1e9
    r2 = SimpleNamespace(busy_s=busy2, window_s=1.2e-3)
    assert readers.idle_share(r2) > readers.idle_share(r)
    # launches in the host's clock, attributed to the span that holds them
    spans = timeline.Spans([("mask_source", anchor_ns - 20_000,
                             anchor_ns + 500_000)])
    assert [spans.at(l) for *_, l in ev] == ["mask_source"] * 3
    gaps = timeline.idle_gaps(timeline.merged_intervals(
        [(s, e) for _, _, s, e, _ in ev]), anchor_ns, anchor_ns + 1_000_000)
    assert [round(g[1]) for g in gaps] == [300_000, 400_000]


def test_rate_and_span_readers():
    r = SimpleNamespace(n_kf=10, window_s=2.0, wall_s=2.0,
                        span_device_s={"mask_source": 0.5, "association": 0.1,
                                       "map_insert": 0.05},
                        span_host_s={"mask_source": 0.8, "association": 0.2},
                        syncs=10, costs={"peak_s": 0.01,
                                         "bound_s": {"flash_attention": 0.002},
                                         "calls": {"flash_attention": 2.0}},
                        launches={"flash_attention": 20},
                        port_kernel_s=0.1)
    assert readers.span_ms_per_kf(r, "mask_source") == pytest.approx(50.0)
    assert readers.span_ms_per_kf(r, "association", "map_insert") == \
        pytest.approx(15.0)
    assert readers.span_ms_per_kf(r, "embedder") is None
    assert readers.loop_host_ms_per_kf(r) == pytest.approx(100.0)
    assert readers.host_syncs_per_kf(r) == 1.0
    assert readers.mfu(r) == pytest.approx(5.0)
    # 20 launches at 1 ms each against 100 ms of kernel time
    assert readers.kernels_roofline(r) == pytest.approx(20.0)
    r.launches = {}
    assert readers.kernels_roofline(r) is None
