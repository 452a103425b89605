"""The vanilla map insert as a replayed CUDA graph
(``ovo_tpu_torch/mapping/insert_graph.py``).

On the CPU: the decision between an eager insert, a capture and a replay,
and the key it is made on; and ``VanillaMapper.map`` on a CPU map, which
stays eager, counts nothing and equals direct ``map_insert_frame`` calls
across its growth. On a CUDA card (marked ``cuda``, skipped without one):
8 inserts at Replica's 680 x 1200 from an empty 2^18 map through
``VanillaMapper.map``, across its grows to 2^21, an in-place ``obj_ids``
write and a replaced ``count`` between inserts, bit-equal to eager inserts
on a clone of the map after every insert; and a planted replay that keeps
the count it was captured with, which must differ. The file imports
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_insert_graph.py
"""
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ovo_tpu_torch import to_device
from ovo_tpu_torch.mapping import insert_graph
from ovo_tpu_torch.mapping.insert_graph import (CAPTURE, EAGER, REPLAY,
                                                InsertGraph, decide,
                                                insert_key)
from ovo_tpu_torch.mapping.map_state import (MapState, grow_map_state,
                                             init_map_state,
                                             map_insert_frame)
from ovo_tpu_torch.slam.vanilla import VanillaMapper
from ovo_tpu_torch.utils import trace

COUNTERS = ("map_insert.eager", "map_insert.graph_captures",
            "map_insert.graph_replays")
KW = dict(k_pooling=3, downscale=2, match_th=0.03)


def _scene(H, W, n, seed=0):
    """``n`` frames of a tilted textured wall (world z = 3 + 0.2 x), the
    camera sliding sideways and back so later frames see mapped points;
    a band of invalid depth. -> [(image, depth, c2w)] as host arrays."""
    rng = np.random.default_rng(seed)
    fx = fy = 0.8 * W
    cx, cy = (W - 1) / 2, (H - 1) / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    u = (np.arange(W, dtype=np.float64) - cx) / fx
    v = np.arange(H)
    frames = []
    for i in range(n):
        tx = 0.15 * (i if i < n // 2 else n - i)
        c2w = np.eye(4)
        c2w[:3, 3] = (tx, 0.05 * i, 0.0)
        s = (3.0 + 0.2 * tx) / (1.0 - 0.2 * u)
        depth = np.broadcast_to(s, (H, W)).astype(np.float32).copy()
        depth[(v >= H // 3 + i) & (v < H // 3 + i + H // 20)] = 0.0
        image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        frames.append((image, depth, c2w))
    return K, frames


def _clone(state: MapState) -> MapState:
    return MapState(*(t.clone() for t in (
        state.points, state.point_ids, state.obj_ids, state.colors,
        state.count, state.next_point_id)))


def _same(a: MapState, b: MapState) -> bool:
    return (a.capacity == b.capacity
            and all(torch.equal(x, y) for x, y in (
                (a.points, b.points), (a.point_ids, b.point_ids),
                (a.obj_ids, b.obj_ids), (a.colors, b.colors),
                (a.count, b.count), (a.next_point_id, b.next_point_id))))


def _eager(state, frame, K, device):
    image, depth, c2w = frame
    c2w = np.asarray(c2w, np.float32)
    return map_insert_frame(
        state, to_device(image, device), to_device(depth, device),
        to_device(c2w, device), K, w2c=to_device(
            np.linalg.inv(c2w).astype(np.float32), device), **KW)


def _config(capacity, initial):
    return {"mapping": {"k_pooling": KW["k_pooling"],
                        "downscale_res": KW["downscale"],
                        "n_points_capacity": capacity,
                        "initial_capacity": initial}}


def _window():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    return prof


def _run(mapper, frames, device, between=None, syncs=None):
    """Insert ``frames`` through ``mapper.map`` and, beside it, eagerly
    into a clone of its map grown to the same capacities. ``between(i,
    state) -> state`` edits both maps alike before insert ``i``. Returns
    whether the two maps were equal after each insert. ``syncs``: a list
    that takes the host syncs ``mapper.map`` made (on the card)."""
    K = mapper.cam_intrinsics
    ref = _clone(mapper.state)
    equal = []
    for i, frame in enumerate(frames):
        if between is not None and i:
            mapper.state = between(i, mapper.state)
            ref = between(i, ref)
        if syncs is None:
            mapper.map([i, *frame[:2]], frame[2])
        else:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    mapper.map([i, *frame[:2]], frame[2])
            finally:
                torch.cuda.set_sync_debug_mode(0)
            syncs += [str(w.message) for w in caught
                      if "synchroniz" in str(w.message)]
        ref = _eager(grow_map_state(ref, mapper.state.capacity), frame, K,
                     device)
        equal.append(_same(mapper.state, ref))
    return equal


@pytest.mark.parametrize("key,warm,held,want", [
    ("a", None, None, (EAGER, False)),      # a new key warms up
    ("a", "a", None, (CAPTURE, False)),     # the warmed key is captured
    ("a", "a", "a", (REPLAY, False)),       # the held key replays
    ("a", None, "a", (REPLAY, False)),
    ("b", "a", "a", (EAGER, True)),         # a new key releases the graph
    ("b", "b", "a", (CAPTURE, True)),
    (None, None, None, (EAGER, False)),     # a key the graph cannot take
    (None, None, "a", (EAGER, True)),
])
def test_decide(key, warm, held, want):
    assert decide(key, warm, held) == want


def test_plan_warms_captures_replays_and_releases():
    g = InsertGraph(torch.device("cpu"))
    keys = ["a", "a", "a", "a", "b", "a", "a", None, "a", "a"]
    actions = []
    held = []
    for k in keys:
        actions.append(g.plan(k))
        if actions[-1] == CAPTURE:
            g.key, g.graph = k, object()    # as a capture leaves them
        held.append((g.key, g.graph is not None))
    assert actions == [EAGER, CAPTURE, REPLAY, REPLAY, EAGER, EAGER,
                       CAPTURE, EAGER, EAGER, CAPTURE]
    # a released graph is no longer replayed but kept for the next capture,
    # which takes over its memory pool
    assert held[4] == (None, True) and held[7] == (None, True)
    assert g.key == "a" and g.graph is not None


def test_insert_key_follows_what_the_launches_depend_on():
    K, frames = _scene(40, 48, 2)
    Kt = torch.from_numpy(K)
    image, depth, _ = frames[0]
    state = init_map_state(1024)
    key = insert_key(state, image, depth, Kt, **KW)
    assert key is not None
    # what an association or a fused insert does between inserts: ids
    # written in place, a new count tensor
    state.obj_ids[:7] = 3
    state = state._replace(count=state.count + 5,
                           next_point_id=state.next_point_id + 5)
    assert insert_key(state, image, depth, Kt, **KW) == key
    changed = [
        insert_key(grow_map_state(state, 2048), image, depth, Kt, **KW),
        insert_key(state._replace(obj_ids=state.obj_ids.clone()), image,
                   depth, Kt, **KW),
        insert_key(state, image[:-2], depth[:-2], Kt, **KW),
        insert_key(state, image, depth.astype(np.float64), Kt, **KW),
        insert_key(state, image, depth, Kt.clone(), **KW),
        insert_key(state, image, depth, Kt, **{**KW, "k_pooling": 5}),
        insert_key(state, image, depth, Kt, **{**KW, "match_th": 0.05}),
    ]
    assert all(k is not None and k != key for k in changed)
    assert len(set(changed)) == len(changed)
    # eager only: a frame covering the whole map
    assert insert_key(init_map_state(20 * 24), image, depth, Kt, **KW) is None
    assert insert_key(init_map_state(20 * 24 + 1), image, depth, Kt,
                      **KW) is not None


def test_pinned_slots_are_refilled_once_their_copy_is_done(monkeypatch):
    """The pinned slot on the CPU, with stand-ins for pinned memory and
    CUDA events: the stage waits for the slot's last copy while it is in
    flight and not once it is done; the same slot is refilled every time;
    the device inputs take each frame whole, and the graph's scalars the
    map's."""
    in_flight, waits = set(), []

    class Event:
        def record(self):
            in_flight.add(self)

        def query(self):
            return self not in in_flight

        def synchronize(self):
            waits.append(self)
            in_flight.discard(self)

    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, pin_memory=False, **k:
                        empty(*a, **k))
    monkeypatch.setattr(torch.cuda, "Event", Event)
    g = InsertGraph(torch.device("cpu"))
    K, frames = _scene(40, 48, 3)
    slot = None
    for i in range(6):
        image, depth, c2w = frames[i % 3]
        c2w = c2w.astype(np.float32)
        w2c = np.linalg.inv(c2w)
        state = init_map_state(64)._replace(
            count=torch.tensor(i, dtype=torch.int32))
        if i == 4:
            in_flight.clear()                # the last copy is done
        g.stage(state, image, depth, c2w, w2c)
        for got, want in zip(g._inputs, (image, depth, c2w, w2c)):
            assert torch.equal(got, torch.from_numpy(want))
        assert int(g._count) == i
        slot = slot or g._slot.data_ptr()
        assert g._slot.data_ptr() == slot
        # no wait before the first fill, nor once the copy is done
        assert len(waits) == [0, 1, 2, 3, 3, 4][i]


def test_cpu_mapper_stays_eager_and_counts_nothing():
    cpu = torch.device("cpu")
    K, frames = _scene(40, 48, 6)
    m = VanillaMapper(_config(1 << 12, 1 << 9), K, cpu)
    assert m._graph is None
    prof = _window()
    try:
        equal = _run(m, frames, cpu, between=lambda i, s: s._replace(
            count=s.count.clone()))
    finally:
        prof.stop()
    rec = trace.records()
    assert all(equal)
    assert m.state.capacity == 1 << 12            # grew 2^9 -> 2^12
    assert rec.counters["map_grows"] == 3
    assert not set(COUNTERS) & set(rec.counters)
    assert [s.name for s in rec.spans].count("map_insert") == len(frames)
    assert "map_insert.capture" not in {s.name for s in rec.spans}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _between(i, state):
    """Ids written in place (as the association does) before every insert,
    the count replaced by a new tensor (as the fused insert does) before
    every other one."""
    state.obj_ids[: 1000 * i] = i
    if i % 2:
        state = state._replace(count=state.count.clone())
    return state


def _replica_run(device, activities=(ProfilerActivity.CPU,)):
    K, frames = _scene(680, 1200, 8)
    m = VanillaMapper(_config(1 << 21, 1 << 18), K, device)
    syncs = []
    prof = profile(activities=list(activities))
    prof.start()
    try:
        equal = _run(m, frames, device, between=_between, syncs=syncs)
    finally:
        prof.stop()
    torch.cuda.synchronize()
    return m, equal, trace.records(), syncs


@pytest.mark.cuda
@pytest.mark.parametrize("activities", [
    (ProfilerActivity.CPU,), (ProfilerActivity.CPU, ProfilerActivity.CUDA)],
    ids=["host", "host_and_card"])
def test_replay_equals_eager_inserts_on_the_card(cuda_device, activities,
                                                monkeypatch):
    pools, real = [], InsertGraph.capture

    def capture(self, *args, **kw):
        real(self, *args, **kw)
        pools.append(self.graph.pool())

    monkeypatch.setattr(insert_graph.InsertGraph, "capture", capture)
    m, equal, rec, syncs = _replica_run(cuda_device, activities)
    assert equal == [True] * 8
    # captures included: the loop never blocks on the card
    assert syncs == []
    assert m.state.capacity == 1 << 21
    c = rec.counters
    # grows before the 2nd, 3rd and 6th inserts (204000 rows of headroom
    # each): the first insert at each new key is eager, the next captured
    assert (c["map_insert.eager"], c["map_insert.graph_captures"],
            c["map_insert.graph_replays"]) == (4, 2, 4)
    assert c["map_grows"] == 3
    assert int(m.state.count) > 204000
    # the second capture took over the first one's memory pool
    assert len(pools) == 2 and pools[0] == pools[1]


@pytest.mark.cuda
def test_a_replay_with_a_stale_count_differs(cuda_device, monkeypatch):
    real = InsertGraph.stage

    def stale(self, state, *args):
        # the fixed count keeps the value it had at the capture
        kept = self._count.clone()
        real(self, state, *args)
        if self.graph is not None:
            self._count.copy_(kept)

    monkeypatch.setattr(insert_graph.InsertGraph, "stage", stale)
    _, equal, rec, _ = _replica_run(cuda_device)
    assert rec.counters["map_insert.graph_replays"] > 0
    assert not all(equal)
