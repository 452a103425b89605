"""The per-layer metrics read from the program's own spans
(``ovo_tpu_torch/utils/trace.py``): None without records, or without the
recorder (a program that predates it), and the spans' arithmetic with
them; and, at test scale on the CPU, a window of a cell under a profiler
gives every one of them."""
import sys
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import timeline
from portbench.run import Cell
from portbench.tests.tiny_cell import tiny

READERS = ("host_wait_ms_per_kf", "host_wait_ms_per_kf.crop",
           "mask_source_host_ms_per_kf", "box_nms_host_ms_per_kf",
           "map_insert_host_ms_per_kf")


def _window():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def test_none_without_records(monkeypatch):
    from ovo_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "records",
                        lambda: trace.Records([], {}, {}, [], {}))
    assert timeline.per_layer(SimpleNamespace(n_kf=8), list(READERS)) == {}


def test_none_without_the_recorder(monkeypatch):
    import ovo_tpu_torch.utils

    # a program without the module: an entry of None in sys.modules makes
    # its import raise ImportError
    monkeypatch.delattr(ovo_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "ovo_tpu_torch.utils.trace", None)
    assert timeline.per_layer(SimpleNamespace(n_kf=8), list(READERS)) == {}


def test_the_spans_arithmetic():
    from ovo_tpu_torch.utils import trace

    prof = _window()
    try:
        with trace.span("mask_source", 0, 2):
            with trace.span("mask_source.box_nms"):
                pass
            with trace.wait("small_regions"):
                pass
        with trace.span("map_insert", 5):
            with trace.wait("insert_count"):
                pass
        with trace.wait("has_mask"):
            pass
    finally:
        prof.stop()
    spans = {s.name: s.t1_ns - s.t0_ns for s in trace.records().spans}
    got = timeline.per_layer(SimpleNamespace(n_kf=2), list(READERS))

    def ms(*names, less=()):
        return (sum(spans[n] for n in names)
                - sum(spans[n] for n in less)) / 1e6 / 2

    waits = ("wait.small_regions", "wait.insert_count", "wait.has_mask")
    want = {"host_wait_ms_per_kf": ms(*waits),
            "host_wait_ms_per_kf.crop": ms(*waits),
            "mask_source_host_ms_per_kf": ms(
                "mask_source", less=("wait.small_regions",)),
            "box_nms_host_ms_per_kf": ms("mask_source.box_nms"),
            "map_insert_host_ms_per_kf": ms(
                "map_insert", less=("wait.insert_count",))}
    assert {k: v["value"] for k, v in got.items()} == pytest.approx(want)
    assert all(v["unit"] == "ms" for v in got.values())


def test_a_window_of_a_cell_gives_every_reader(tmp_path):
    from ovo_tpu_torch.utils import trace

    _, cfg, traffic, _ = tiny("sam2_hiera_l-pe_core_l14", 2)
    c = Cell(cfg, traffic, 7, torch.device("cpu"), tmp_path / "run")
    c.stream(0, 4 * c.seg_every)                      # warm-up
    n_warm = len(c.probe.segmented)
    prof = _window()
    try:
        c.stream(4 * c.seg_every, 8 * c.seg_every)
    finally:
        prof.stop()
    n_kf = len(c.probe.segmented) - n_warm
    rec = trace.records()
    assert n_kf == 4 and rec.counters["keyframes"] == n_kf
    names = {s.name for s in rec.spans}
    assert {"step", "mask_source", "mask_source.encode",
            "mask_source.decode", "mask_source.box_nms", "association",
            "association.match", "embedder", "embedder.tower",
            "map_insert", "wait.insert_count", "wait.has_mask"} <= names
    got = timeline.per_layer(SimpleNamespace(n_kf=n_kf), list(READERS))
    assert set(got) == set(READERS)
    assert all(v["value"] > 0 for v in got.values())
