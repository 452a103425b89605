"""The program's span and counter recorder (``ovo_tpu_torch/utils/trace.py``)
under a CPU ``torch.profiler``: it records only inside a profiler window,
nests spans with their parent, keyframe and batch size, keeps a second
thread on its own row, clears a window when the next opens, and shares the
trace's clock (``ts`` + ``baseTimeNanoseconds``)."""
import json
import threading

import pytest
import torch
from torch.autograd.profiler import record_function
from torch.profiler import ProfilerActivity, profile

from ovo_tpu_torch.ops import cuda_build
from ovo_tpu_torch.utils import trace


def _window():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _names(rec):
    return [s.name for s in rec.spans]


def test_nothing_is_recorded_without_a_profiler():
    before = trace.records()
    with trace.span("off", 3, 2) as s:
        with trace.wait("off"):
            torch.ones(4).sum()
    trace.count("off_count")
    trace.gauge("off_gauge", 1.0)
    after = trace.records()
    assert after == before
    # no object is made per span when off
    assert trace.span("a") is trace.span("b") is s


def test_nested_spans_carry_parent_frame_and_batch():
    prof = _window()
    try:
        with trace.span("outer", frame_id=40, n_kf=8):
            with trace.span("outer.inner"):
                with trace.wait("read"):
                    pass
            with trace.span("outer.per_kf", frame_id=50):
                pass
        trace.count("keyframes", 8)
        trace.count("keyframes")
        trace.gauge("capacity", 1024)
    finally:
        prof.stop()
    rec = trace.records()
    assert _names(rec) == ["outer", "outer.inner", "wait.read",
                           "outer.per_kf"]
    outer, inner, wait, per_kf = rec.spans
    assert (outer.parent, outer.frame_id, outer.n_kf) == (-1, 40, 8)
    # a child inherits the keyframe, not the batch size
    assert (inner.parent, inner.frame_id, inner.n_kf) == (0, 40, 1)
    assert (wait.parent, wait.frame_id) == (1, 40)
    assert (per_kf.parent, per_kf.frame_id) == (0, 50)
    assert outer.t0_ns <= inner.t0_ns <= wait.t0_ns <= wait.t1_ns \
        <= inner.t1_ns <= per_kf.t0_ns <= per_kf.t1_ns <= outer.t1_ns
    assert rec.counters["keyframes"] == 9
    assert rec.gauges == {"capacity": 1024}
    assert [v for _, n, v in rec.samples if n == "keyframes"] == [8, 9]


@pytest.mark.parametrize("between", ["read", "span"])
def test_a_second_window_clears_the_first(between):
    prof = _window()
    with trace.span("first"):
        pass
    prof.stop()
    # the recorder sees the window close when it is read, or at its next
    # call while no profiler runs
    if between == "read":
        assert _names(trace.records()) == ["first"]
    else:
        with trace.span("off"):
            pass
    prof = _window()
    with trace.span("second"):
        pass
    prof.stop()
    assert _names(trace.records()) == ["second"]


def test_a_second_thread_keeps_its_own_row():
    def read():
        with trace.span("data.read", 7):
            pass

    prof = _window()
    try:
        with trace.span("main", frame_id=1):
            worker = threading.Thread(target=read, name="producer")
            worker.start()
            worker.join()
    finally:
        prof.stop()
    rec = trace.records()
    by_name = {s.name: s for s in rec.spans}
    main, read = by_name["main"], by_name["data.read"]
    # a span of another thread has no parent on this thread's stack
    assert read.parent == -1 and read.frame_id == 7
    assert read.thread != main.thread
    assert sorted(rec.threads.values()) == sorted(
        [threading.current_thread().name, "producer"])
    events = trace.chrome_events(rec, 0)
    rows = {e["name"]: e["tid"] for e in events if e["ph"] == "X"}
    assert rows["main"] != rows["data.read"]
    names = {e["args"]["name"] for e in events
             if e["ph"] == "M" and e["name"] == "thread_name"}
    assert "producer" in names


def test_launches_count_under_the_innermost_span():
    before = cuda_build.launch_counts()["masked_pool"]
    prof = _window()
    try:
        with trace.span("embedder"):
            with trace.span("embedder.pool"):
                cuda_build.count_launch("masked_pool")
            cuda_build.count_launch("masked_pool")
    finally:
        prof.stop()
    counters = trace.records().counters
    assert counters["port_launches.embedder.pool"] == 1
    assert counters["port_launches.embedder"] == 1
    # the global counts are unchanged in meaning
    assert cuda_build.launch_counts()["masked_pool"] == before + 2


def test_keep_times_a_span_outside_a_window():
    before = trace.records()
    assert trace.last_seconds("logged") is None
    with trace.span("logged", 5, 4, keep=True):
        torch.ones(4).sum()
    seconds = trace.last_seconds("logged")
    assert seconds > 0
    assert trace.last_seconds("logged", per_kf=True) == pytest.approx(
        seconds / 4)
    assert trace.records() == before


def test_spans_share_the_trace_clock(tmp_path):
    prof = _window()
    try:
        with trace.span("program"):
            with record_function("annotated"):
                torch.ones(64).sum()
    finally:
        prof.stop()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace.export_chrome(path)
    data = json.loads(path.read_text())
    base = data["baseTimeNanoseconds"]
    events = data["traceEvents"]
    rf = next(e for e in events if e.get("name") == "annotated"
              and e.get("ph") == "X")
    ours = next(e for e in events if e.get("pid") == trace.PID
                and e.get("name") == "program")
    span = trace.records().spans[0]
    # both events' ts, and the span's own time_ns, on one clock within 1 ms
    assert abs(rf["ts"] - ours["ts"]) < 1e3
    assert abs(rf["ts"] * 1e3 + base - span.t0_ns) < 1e6
    assert ours["dur"] >= rf["dur"] - 1e3
    assert any(e.get("ph") == "M" and e.get("pid") == trace.PID
               and e["args"]["name"] == trace.PID for e in events)
