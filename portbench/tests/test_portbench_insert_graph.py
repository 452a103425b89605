"""``map_insert_replay_share``: None where the program counts no replayed
or eager insert (a program without the insert graph, or a map on the CPU),
the counter over the ``map_insert`` spans where it does; and, on the card
(marked ``cuda``), a planted insert fault replayed through the graph turns
``correct`` false at a cell's own size."""
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import timeline

READER = ["map_insert_replay_share"]


def _window():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _inserts(n, counts):
    from ovo_tpu_torch.utils import trace

    prof = _window()
    try:
        for i in range(n):
            with trace.span("map_insert", i):
                pass
        for name, k in counts.items():
            trace.count(name, k)
    finally:
        prof.stop()
    return timeline.per_layer(SimpleNamespace(n_kf=n), READER)


def test_none_without_the_insert_counters():
    assert _inserts(4, {}) == {}
    assert _inserts(0, {"map_insert.graph_replays": 2}) == {}


@pytest.mark.parametrize("counts,share", [
    ({"map_insert.graph_replays": 3, "map_insert.eager": 1}, 75.0),
    ({"map_insert.eager": 4}, 0.0),
    ({"map_insert.graph_replays": 4, "map_insert.graph_captures": 1}, 100.0),
])
def test_replays_over_inserts(counts, share):
    got = _inserts(4, counts)
    assert got == {"map_insert_replay_share": {"value": share, "unit": "%"}}


@pytest.mark.cuda
def test_insert_fault_through_the_graph_fails_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ovo_tpu_torch.mapping.insert_graph import InsertGraph
    from ovo_tpu_torch.slam import vanilla

    from portbench.run import run_cell
    from portbench.spec import load_cell
    from portbench.tests.test_portbench_correct import SEED

    replays = []
    real = InsertGraph.replay

    def counted(self):
        replays.append(1)
        return real(self)

    monkeypatch.setattr(InsertGraph, "replay", counted)
    monkeypatch.setattr(vanilla, "map_insert_frame",
                        lambda state, *a, **k: state)
    bench, cell, cfg, traffic, limits = load_cell("replica.sam2_pe.b8")
    # the allocator's statistics need the card's state, which no call of
    # this process has made yet (``run.main`` makes it naming the card)
    torch.cuda.init()
    r = run_cell(bench, cell["name"], cfg, traffic, limits, SEED, 3.0, False,
                 torch.device("cuda", 0), log=lambda s: None)
    assert replays
    assert r["checks"]["insert_mismatch"]["value"] > \
        r["checks"]["insert_mismatch"]["limit"]
