"""Semantic loop closure of the PyTorch port against the JAX package: the
scenarios of ``tests/test_loop_closure.py`` through both packages'
``semantic_loop_closure`` / ``apply_fusion``, ``drop_keyframe_descriptors``
under each fusion, and ``SemanticMapper.update_map`` with culled keyframes
and a merge chain.

Tolerances: the ``fused`` dict, ``active``, ``obj_ids``, ``top_kf``,
``top_area``, ``desc_cnt``, ``n_points`` and every other integer or bool
field bit-equal; ``clip_feature`` and ``desc_sum`` within 1e-6 abs (merged
sums added in another order). The instances sit far from every gate (a
pair's centroids either ~1 cm or >= 5 m apart, cosines 1 or 0), so the f32
sums' order decides no gate.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.mapping import instances as jinst
from ovo_tpu.mapping import loop_closure as jlc
from ovo_tpu.mapping.map_state import MapState as JaxMapState
from ovo_tpu.mapping.map_state import init_map_state
from ovo_tpu.mapping.semantic import SemanticMapper as JaxSemanticMapper

from ovo_tpu_torch.mapping import instances as inst
from ovo_tpu_torch.mapping import loop_closure as lc
from ovo_tpu_torch.mapping import map_state as ms
from ovo_tpu_torch.mapping.semantic import SemanticMapper


def t(x):
    return torch.from_numpy(np.array(x))


def to_port(map_state, store):
    """Copies of a JAX map and store for the port, taken before any JAX
    program that donates them runs."""
    return (ms.MapState(*(t(x) for x in map_state)),
            inst.InstanceStore(*(t(x) for x in store)))


def unit(v):
    v = np.asarray(v, np.float32)
    return v / np.linalg.norm(v)


def build_scene(rng, clusters, D=8, K=16, fusion="avg_pooling", extra=0,
                stale=()):
    """clusters: (center, n_points, descriptor) per instance, all seen in
    keyframe 0; ``extra`` more ids minted with no points; ``stale``
    (center, n, id) point rows written past ``count`` (the rows a
    compaction leaves behind)."""
    total = sum(n for _, n, _ in clusters) + sum(n for _, n, _ in stale)
    st = init_map_state(max(total, 64))
    store = jinst.init_instance_store(
        K, clip_dim=D, store_slot_descs=fusion != "avg_pooling")
    store = jinst.mint_instances(store, jnp.asarray(len(clusters) + extra,
                                                    jnp.int32))
    pts, objs = [], []
    for iid, (c, n, desc) in enumerate(clusters):
        pts.append(np.asarray(c) + rng.normal(0, 0.02, (n, 3)))
        objs.append(np.full(n, iid, np.int32))
        ids = jnp.asarray([iid], jnp.int32)
        store = jinst.add_top_kf(store, ids, jnp.asarray(0, jnp.int32),
                                 jnp.asarray([n], jnp.int32),
                                 jnp.asarray([True]))
        store = jinst.update_descriptors(
            store, ids, jnp.asarray(desc, jnp.float32)[None],
            jnp.asarray(0, jnp.int32), jnp.asarray([True]), fusion=fusion)
    n_live = sum(len(p) for p in pts)
    for c, n, iid in stale:
        pts.append(np.asarray(c) + rng.normal(0, 0.02, (n, 3)))
        objs.append(np.full(n, iid, np.int32))
    pts = np.concatenate(pts).astype(np.float32)
    objs = np.concatenate(objs)
    m = len(pts)
    st = JaxMapState(st.points.at[:m].set(pts),
                     st.point_ids.at[:m].set(np.arange(m, dtype=np.int32)),
                     st.obj_ids.at[:m].set(objs), st.colors,
                     jnp.asarray(n_live, jnp.int32),
                     jnp.asarray(m, jnp.int32))
    return st, store


def assert_same(ours_map, ours_store, ref_map, ref_store):
    np.testing.assert_array_equal(ours_map.obj_ids.numpy(),
                                  np.asarray(ref_map.obj_ids))
    assert int(ours_map.count) == int(ref_map.count)
    for f in inst.InstanceStore.__dataclass_fields__:
        a, b = getattr(ours_store, f).numpy(), np.asarray(getattr(ref_store,
                                                                  f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _scenario(name, rng):
    d = unit(rng.standard_normal(8))
    if name == "overlapping_similar_fuse":
        return [([0, 0, 0], 200, d), ([0.01, 0, 0], 200, d),
                ([5, 5, 5], 200, unit(rng.standard_normal(8)))], {}
    if name == "distant_do_not_fuse":
        return [([0, 0, 0], 150, d), ([10, 0, 0], 150, d)], {}
    if name == "dissimilar_do_not_fuse":
        return [([0, 0, 0], 150, unit(np.eye(8)[0])),
                ([0.01, 0, 0], 150, unit(np.eye(8)[1]))], {}
    if name == "unsupported_removed":
        return [([0, 0, 0], 150, d)], {"extra": 1}
    if name == "greedy_order":
        # 0 ~ 1 ~ 2 ~ 3 all gate: in the reference's order 0 keeps walking
        # and absorbs each in turn, and no pair of the others is tried
        return [([0, 0, 0], 120, d), ([0.01, 0, 0], 120, d),
                ([0.02, 0, 0], 120, d), ([0.03, 0, 0], 120, d)], {}
    if name == "stale_rows_in_sample":
        # rows past count still carry an id: the reference samples them
        return [([0, 0, 0], 60, d), ([1, 0, 0], 60, d)], {
            "stale": [([0.01, 0, 0], 40, 1)]}
    raise KeyError(name)


SCENARIOS = ["overlapping_similar_fuse", "distant_do_not_fuse",
             "dissimilar_do_not_fuse", "unsupported_removed", "greedy_order",
             "stale_rows_in_sample"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_semantic_loop_closure_matches_jax(rng, name):
    clusters, kw = _scenario(name, rng)
    ref_map, ref_store = build_scene(rng, clusters, **kw)
    our_map, our_store = to_port(ref_map, ref_store)
    ref_map, ref_store, ref_fused = jlc.semantic_loop_closure(ref_map,
                                                              ref_store)
    our_map, our_store, fused = lc.semantic_loop_closure(our_map, our_store)
    assert fused == ref_fused
    assert list(fused.items()) == list(ref_fused.items())
    assert_same(our_map, our_store, ref_map, ref_store)
    expect = {"overlapping_similar_fuse": {1: 0},
              "greedy_order": {1: 0, 2: 0, 3: 0},
              "stale_rows_in_sample": {1: 0}}.get(name, {})
    assert fused == expect
    if name == "unsupported_removed":
        assert not bool(our_store.active[1]) and bool(our_store.active[0])


def test_apply_fusion_chain_matches_jax(rng):
    """The seventh scenario: a merge chain 2 -> 1 -> 0 given directly, with
    a dead id beside it; top-kf slots pooled into the survivor."""
    d = unit(rng.standard_normal(8))
    clusters = [([0, 0, 0], 100, d), ([0.01, 0, 0], 80, d),
                ([0.02, 0, 0], 60, d), ([4, 0, 0], 50, d)]
    ref_map, ref_store = build_scene(rng, clusters)
    # more top-kf entries than one slot row holds, across the chain
    for kf in range(1, 12):
        ids = jnp.asarray([kf % 3], jnp.int32)
        ref_store = jinst.add_top_kf(ref_store, ids, jnp.asarray(kf,
                                                                 jnp.int32),
                                     jnp.asarray([10 * kf + 3], jnp.int32),
                                     jnp.asarray([True]))
    our_map, our_store = to_port(ref_map, ref_store)
    ref_map, ref_store = jlc.apply_fusion(ref_map, ref_store, {1: 0, 2: 1},
                                          dead_ids=[3])
    our_map, our_store = lc.apply_fusion(our_map, our_store, {1: 0, 2: 1},
                                         dead_ids=[3])
    assert_same(our_map, our_store, ref_map, ref_store)
    assert our_store.active.tolist()[:4] == [True, False, False, False]
    assert int(our_store.desc_cnt[0]) == 3


def test_pair_overlap_matches_jax():
    """The sampled overlap on the surface patches of
    ``test_sampled_overlap_matches_exact_decision``, all pairs in one
    batch: the fractions equal (counts of close points over n1)."""
    def surface_patch(n, center, seed):
        r = np.random.default_rng(seed)
        return (np.stack([r.uniform(-1, 1, n), r.uniform(-1, 1, n),
                          0.02 * r.standard_normal(n)], -1)
                + np.asarray(center)).astype(np.float32)

    S = 512
    cases = [(500, 700, 0.0), (2000, 1500, 0.3), (8000, 3000, 0.6),
             (300, 4000, 0.9), (1000, 200, 1.4)]
    p1s, p2s, n1s, n2s, ref = [], [], [], [], []
    for k, (n1, n2, off) in enumerate(cases):
        a = surface_patch(n1, (0, 0, 0), 10 + k)[:S]
        b = surface_patch(n2, (off, 0, 0), 50 + k)[:S]
        pa, pb = np.zeros((S, 3), np.float32), np.zeros((S, 3), np.float32)
        pa[:len(a)], pb[:len(b)] = a, b
        ref.append(float(jlc._pair_overlap(
            jnp.asarray(pa), jnp.asarray(len(a)), jnp.asarray(pb),
            jnp.asarray(len(b)), 0.1)))
        p1s.append(pa)
        p2s.append(pb)
        n1s.append(len(a))
        n2s.append(len(b))
    ours = lc._pair_overlap(t(np.stack(p1s)), t(n1s), t(np.stack(p2s)),
                            t(n2s), 0.1)
    np.testing.assert_array_equal(ours.numpy(), np.float32(ref))


def _store_with_views(rng, fusion, K=8, D=8, T=4):
    """Instances 0-4 seen in keyframes 0-5 with per-view descriptors;
    returns the JAX store and the per-kf (ids, descs, keep) records."""
    store = jinst.init_instance_store(
        K, clip_dim=D, n_slots=T, store_slot_descs=fusion != "avg_pooling")
    store = jinst.mint_instances(store, jnp.asarray(5, jnp.int32))
    records = {}
    for kf in range(6):
        ids = np.array([kf % 5, (kf + 2) % 5, -1], np.int32)
        keep = np.array([True, kf % 2 == 0, False])
        descs = rng.standard_normal((3, D)).astype(np.float32)
        areas = rng.integers(10, 500, 3).astype(np.int32)
        store = jinst.add_top_kf(store, jnp.asarray(ids), jnp.asarray(
            kf, jnp.int32), jnp.asarray(areas), jnp.asarray(keep))
        store = jinst.update_descriptors(
            store, jnp.asarray(ids), jnp.asarray(descs),
            jnp.asarray(kf, jnp.int32), jnp.asarray(keep), fusion=fusion)
        records[kf] = (ids, descs, keep)
    return store, records


@pytest.mark.parametrize("fusion", ["avg_pooling", "l1_medoid",
                                    "cossim_medoid"])
def test_drop_keyframe_descriptors_matches_jax(rng, fusion):
    """Keyframes 1 and 4 culled (the list padded with -2, as the JAX
    mapper pads it); keyframe 5's slot evicted with no descriptor row."""
    ref, records = _store_with_views(rng, fusion)
    _, ours = to_port(init_map_state(4), ref)
    rows = [records[1], records[4]]
    ids = np.concatenate([r[0] for r in rows])
    descs = np.concatenate([r[1] for r in rows])
    keep = np.concatenate([r[2] for r in rows])
    culled = np.array([1, 4, 5, -2], np.int32)
    ref = jinst.drop_keyframe_descriptors(
        ref, jnp.asarray(ids), jnp.asarray(descs), jnp.asarray(keep),
        jnp.asarray(culled), fusion=fusion)
    ours = inst.drop_keyframe_descriptors(ours, t(ids), t(descs), t(keep),
                                          t(culled), fusion=fusion)
    for f in inst.InstanceStore.__dataclass_fields__:
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert not np.isin(ours.top_kf.numpy(), [1, 4, 5]).any()


def _mappers(D, fusion="avg_pooling"):
    cfg = {"clip": {"k_top_views": 10000, "fusion": fusion, "clip_dim": D},
           "capacity": {"n_instances": 16}, "debug_info": True}
    return (JaxSemanticMapper(cfg, eval=True),
            SemanticMapper(cfg, eval=True, device="cpu"))


def test_update_map_culls_and_merges_like_jax(rng):
    """update_map(map, kfs) with a culled keyframe and a merge chain: the
    culled keyframe's descriptors leave the store, instances 1 and 2 fuse
    into 0, and the remaining per-kf descriptor rows and debug records
    follow the merge (``_remap_kf_descriptors``)."""
    D = 8
    d = unit(rng.standard_normal(D))
    far = unit(rng.standard_normal(D))
    ref_map, ref_store = build_scene(
        rng, [([0, 0, 0], 120, d), ([0.01, 0, 0], 120, d),
              ([0.02, 0, 0], 120, d), ([6, 6, 6], 120, far)], D=D)
    views = {1: (np.array([0, 1, 2, 3], np.int32), d, 11),
             2: (np.array([1, 3, -1, -1], np.int32), far, 23)}
    for kf, (ids, desc, _) in views.items():
        keep = ids >= 0
        ref_store = jinst.update_descriptors(
            ref_store, jnp.asarray(ids),
            jnp.asarray(np.tile(desc, (4, 1))),
            jnp.asarray(kf, jnp.int32), jnp.asarray(keep))
    our_map, our_store = to_port(ref_map, ref_store)
    jm, tm = _mappers(D)
    jm.store, tm.store = ref_store, our_store
    for m in (jm, tm):
        m.kf_id = 3
        m.frame_ids = [0, 11, 23]
    for kf, (ids, desc, _) in views.items():
        descs = np.tile(desc, (4, 1)).astype(np.float32)
        keep = ids >= 0
        jm.kf_descriptors[kf] = (jnp.asarray(ids), jnp.asarray(descs),
                                 jnp.asarray(keep))
        tm.kf_descriptors[kf] = (t(ids), t(descs), t(keep))
        areas = np.arange(4, dtype=np.int32) + 10 * kf
        jm.kf_records[kf] = (ids.copy(), areas)
        tm.kf_records[kf] = (ids.copy(), areas.copy())
    # the backbone culled dataset frame 23 (keyframe 2); 0 and 11 survive
    kfs = {0: True, 11: True}
    ref_map = jm.update_map(ref_map, kfs)
    our_map = tm.update_map(our_map, kfs)
    assert_same(our_map, tm.store, ref_map, jm.store)
    assert sorted(tm.kf_descriptors) == sorted(jm.kf_descriptors) == [1]
    for k in jm.kf_descriptors:
        for a, b in zip(tm.kf_descriptors[k], jm.kf_descriptors[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tm.kf_descriptors[1][0].numpy(),
                                  [0, 0, 0, 3])
    for k in jm.kf_records:
        for a, b in zip(tm.kf_records[k], jm.kf_records[k]):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tm.kf_records[2][0], [0, 3, -1, -1])
    assert tm.store.active.tolist()[:4] == [True, False, False, True]
    assert not np.isin(tm.store.top_kf.numpy(), [2]).any()


def test_update_map_drops_culled_keyframe_descriptors_like_jax(rng):
    """The JAX package's own update_map scenario
    (``test_update_map_drops_culled_keyframe_descriptors``) through both
    mappers: the culled view leaves instance 0's mean, instance 1 loses
    its only descriptor."""
    D = 8
    d_a0, d_a1, d_b = (unit(rng.standard_normal(D)) for _ in range(3))
    ref_map, ref_store = build_scene(rng, [([0, 0, 0], 40, d_a0),
                                           ([5, 5, 5], 40, d_b)], D=D)
    ref_store = jinst.update_descriptors(
        ref_store, jnp.asarray([0], jnp.int32),
        jnp.asarray(d_a1, jnp.float32)[None], jnp.asarray(1, jnp.int32),
        jnp.asarray([True]))
    our_map, our_store = to_port(ref_map, ref_store)
    jm, tm = _mappers(D)
    jm.store, tm.store = ref_store, our_store
    rows = {0: (np.array([0, 1], np.int32), np.stack([d_a0, d_b]),
                np.array([True, True])),
            1: (np.array([0, -1], np.int32), np.stack([d_a1, np.zeros(D)]),
                np.array([True, False]))}
    for m in (jm, tm):
        m.kf_id, m.frame_ids = 2, [10, 20]
    for k, (ids, descs, keep) in rows.items():
        descs = descs.astype(np.float32)
        jm.kf_descriptors[k] = (jnp.asarray(ids), jnp.asarray(descs),
                                jnp.asarray(keep))
        tm.kf_descriptors[k] = (t(ids), t(descs), t(keep))
    ref_map = jm.update_map(ref_map, kfs={20: True})
    our_map = tm.update_map(our_map, kfs={20: True})
    assert_same(our_map, tm.store, ref_map, jm.store)
    np.testing.assert_allclose(tm.store.clip_feature[0].numpy(), d_a1,
                               rtol=1e-5)
    assert not bool(tm.store.has_clip[1])
    assert sorted(tm.kf_descriptors) == [1]


def test_loop_closure_reads_the_device_twice(rng, monkeypatch):
    """The port's loop closure reads the device at its two named sites
    only: the gates, then the candidates' overlaps."""
    d = unit(rng.standard_normal(8))
    ref_map, ref_store = build_scene(
        rng, [([0, 0, 0], 200, d), ([0.01, 0, 0], 200, d)])
    our_map, our_store = to_port(ref_map, ref_store)
    calls = []
    for name in ("_read_gates", "_read_overlaps"):
        fn = getattr(lc, name)
        monkeypatch.setattr(lc, name, lambda *a, _f=fn, _n=name: (
            calls.append(_n), _f(*a))[1])
    _, _, fused = lc.semantic_loop_closure(our_map, our_store)
    assert fused == {1: 0}
    assert calls == ["_read_gates", "_read_overlaps"]
