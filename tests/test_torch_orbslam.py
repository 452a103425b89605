"""The ORB tier of the PyTorch port against the JAX package: the native
tracker's source and build, both packages' ``NativeTracker`` on the
revisit and figure-8 sequences of ``tests/test_native_tracker.py``,
``segment_mxu.table_lookup``, ``_apply_block_deltas`` and
``WrapperORBSLAM``'s loop rebuild.

Tolerances: tracker poses, keyframes, culled flags and big-change counts
bit-equal (one C++ source, one compiler, the same flags); block ranges,
``count``, ids, colours and the compaction's order bit-equal; points
within 1e-5 abs at the scenes' metre scale (XLA fuses the rigid
transform's multiply-adds, PyTorch rounds each op).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.mapping.map_state import init_map_state
from ovo_tpu.ops import segment_mxu as jseg
from ovo_tpu.slam import orbslam as jorb

from ovo_tpu_torch.mapping import map_state as ms
from ovo_tpu_torch.ops import cuda_build
from ovo_tpu_torch.ops import segment_mxu as seg
from ovo_tpu_torch.slam import orbslam as orb

from orb_scene import CurvedWallDataset
from test_native_tracker import CX, CY, FX, FY, render_plane_noisy

LOOP_GATES = dict(min_kf_gap=5, radius=0.15, rot_limit=1.0, inlier_th=0.3)
ORB_SLAM_CFG = {"kf_trans_th": 0.05, "loop_min_kf_gap": 5,
                "loop_radius": 0.15, "loop_rot_limit": 1.0,
                "loop_inlier_th": 0.3}


def t(x):
    return torch.from_numpy(np.array(x))


def test_tracker_source_is_the_reference_copy():
    """The port's tracker is the JAX package's source byte for byte, but
    for three comments whose citation of the reference's binding dropped
    the directory it was mounted at: the same program."""
    ours = orb.TRACKER_SOURCE.read_bytes()
    ref = (orb.TRACKER_SOURCE.parents[3] / "ovo_tpu" / "native" / "tracker"
           / "tracker.cpp").read_bytes()
    mount = b"/" + b"/".join([b"root", b"reference", b"ovo"])
    assert ref.count(mount) == 3
    assert ours == ref.replace(mount, b"reference ovo")
    assert len(ours.splitlines()) == 705


def test_tracker_builds_under_build_dir():
    """The library lands in build/ovo_tpu_torch/, named by the source's
    hash, never in a source directory."""
    src_dir = orb.TRACKER_SOURCE.parent
    before = sorted(p.name for p in src_dir.iterdir())
    path = orb.build_library()
    assert path.exists() and path.parent == cuda_build.BUILD_DIR
    assert path.name.startswith("libovo_tracker-")
    assert sorted(p.name for p in src_dir.iterdir()) == before \
        == ["tracker.cpp"]
    lib = orb._load_library()
    assert lib._name == str(path)


def test_tracker_build_failure_raises_with_the_log(monkeypatch, tmp_path):
    bad = tmp_path / "tracker.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(orb, "TRACKER_SOURCE", bad)
    monkeypatch.setattr(orb, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="tracker build failed"):
        orb.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


def _sweeps(*axes, step=0.025, n=20):
    """From the origin, out and back along each axis in turn: the revisit
    (x) and figure-8 (x, then y) sequences of test_native_tracker.py."""
    xy = [(0.0, 0.0)]
    for ax in axes:
        for i in list(range(1, n + 1)) + list(range(n - 1, -1, -1)):
            xy.append((i * step, 0.0) if ax == "x" else (0.0, i * step))
    return xy


@pytest.mark.parametrize("sequence,seed,closures", [
    ("revisit", 7, 1), ("figure8", 11, 2)])
def test_native_trackers_agree(sequence, seed, closures):
    rng = np.random.default_rng(seed)
    trackers = [jorb.NativeTracker(kf_trans_th=0.05),
                orb.NativeTracker(kf_trans_th=0.05)]
    for tr in trackers:
        tr.set_loop_params(**LOOP_GATES)
    frames = _sweeps("x") if sequence == "revisit" else _sweeps("x", "y")
    for i, (x, y) in enumerate(frames):
        c2w = np.eye(4, dtype=np.float32)
        c2w[0, 3], c2w[1, 3] = x, y
        gray, depth = render_plane_noisy(c2w, rng)
        states = [tr.process_image_rgbd(gray, depth, FX, FY, CX, CY,
                                        timestamp=float(i))
                  for tr in trackers]
        assert states[0] == states[1] == orb.STATE_OK
        ref, ours = trackers
        np.testing.assert_array_equal(ours.get_last_trajectory_point(),
                                      ref.get_last_trajectory_point())
        assert ours.is_last_frame_kf() == ref.is_last_frame_kf()
        assert ours.get_last_big_change_idx() == \
            ref.get_last_big_change_idx()
        assert ours.last_inlier_ratio() == ref.last_inlier_ratio()
    ref, ours = trackers
    assert ours.get_last_big_change_idx() >= closures
    kr, ko = ref.get_keyframes(), ours.get_keyframes()
    assert len(ko) == len(kr) >= 8 and any(c for _, _, c in ko)
    for (fa, pa, ca), (fb, pb, cb) in zip(ko, kr):
        assert fa == fb and ca == cb
        np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(ours.get_keyframe_points(),
                                  ref.get_keyframe_points())
    for tr in trackers:
        tr.shutdown()


@pytest.mark.parametrize("shape,dtype", [
    ((7,), np.float32), ((7, 12), np.float32), ((5, 3), np.int32),
    ((300,), np.int32)])
def test_table_lookup_matches_jax(rng, shape, dtype):
    if dtype == np.float32:
        table = rng.standard_normal(shape).astype(dtype)
        table.reshape(-1)[0] = -0.0
    else:
        table = rng.integers(-2 ** 20, 2 ** 20, shape).astype(dtype)
    idx = rng.integers(-3, shape[0] + 3, 257).astype(np.int32)
    ref = np.asarray(jseg.table_lookup(jnp.asarray(idx), jnp.asarray(table)))
    ours = seg.table_lookup(t(idx), t(table)).numpy()
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))


def _block_map(rng, cap=64, n=50):
    st = init_map_state(cap)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 3
    cols = rng.integers(0, 256, (cap, 3)).astype(np.uint8)
    return st._replace(
        points=st.points.at[:n].set(pts),
        point_ids=st.point_ids.at[:n].set(np.arange(n, dtype=np.int32)),
        obj_ids=st.obj_ids.at[:n].set(np.arange(n, dtype=np.int32) % 5),
        colors=jnp.asarray(cols),
        count=jnp.asarray(n, jnp.int32),
        next_point_id=jnp.asarray(n, jnp.int32))


@pytest.mark.parametrize("keep", [None, (1, 0, 1, 1), (0, 1, 0, 1),
                                  (0, 0, 0, 1)])
def test_apply_block_deltas_matches_jax(rng, keep):
    """Blocks [0, 20), [20, 35), [35, 50) and the identity row; with
    ``keep`` whole blocks are dropped and the survivors compacted in
    order."""
    ref = _block_map(rng)
    ours = ms.MapState(*(t(x) for x in ref))  # before the donating call
    th = 0.3
    deltas = np.tile(np.eye(3, 4, dtype=np.float32), (4, 1, 1))
    deltas[1, :, :3] = [[np.cos(th), -np.sin(th), 0],
                        [np.sin(th), np.cos(th), 0], [0, 0, 1]]
    deltas[1, :, 3] = [0.1, -0.2, 0.3]
    deltas[2, :, 3] = [1.0, 2.0, 3.0]
    starts = np.array([0, 20, 35, 50], np.int32)
    k = np.float32(keep if keep is not None else (1, 1, 1, 1))
    ref = jorb._apply_block_deltas(ref, jnp.asarray(starts),
                                   jnp.asarray(deltas), jnp.asarray(k),
                                   compact=keep is not None)
    ours = orb._apply_block_deltas(ours, t(starts), t(deltas), t(k),
                                   compact=keep is not None)
    assert int(ours.count) == int(ref.count)
    assert ours.count.dtype == torch.int32
    n = int(ref.count)
    np.testing.assert_allclose(ours.points[:n].numpy(),
                               np.asarray(ref.points[:n]), atol=1e-5)
    for f in ("point_ids", "obj_ids", "colors"):
        a, b = getattr(ours, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(ours.next_point_id) == int(ref.next_point_id)


def _run_wrappers(config, ds):
    ref = jorb.WrapperORBSLAM(config, ds.K, world_ref=ds[0][3])
    ours = orb.WrapperORBSLAM(config, ds.K, world_ref=ds[0][3],
                              device="cpu")
    for i in range(len(ds)):
        fd = ds[i]
        for m in (ref, ours):
            m.track_camera(fd)
            c2w = m.get_c2w(i)
            if c2w is not None:
                m.map(fd, c2w)
        assert int(ours.state.count) == int(ref.state.count), i
    return ref, ours


def assert_same_wrapper(ours, ref):
    assert ours.last_big_change == ref.last_big_change
    assert list(ours.kf_blocks) == list(ref.kf_blocks)
    for fid, blk in ref.kf_blocks.items():
        assert ours.kf_blocks[fid]["range"] == blk["range"]
        np.testing.assert_array_equal(ours.kf_blocks[fid]["c2w"], blk["c2w"])
    assert sorted(ours.kfs) == sorted(ref.kfs)
    assert sorted(ours.estimated_c2ws) == sorted(ref.estimated_c2ws)
    for k, v in ref.estimated_c2ws.items():
        np.testing.assert_array_equal(ours.estimated_c2ws[k], v)
    n = int(ref.state.count)
    assert int(ours.state.count) == n and ours.state.capacity == \
        ref.state.capacity
    np.testing.assert_allclose(ours.state.points[:n].numpy(),
                               np.asarray(ref.state.points[:n]), atol=1e-5)
    for f in ("point_ids", "obj_ids", "colors"):
        np.testing.assert_array_equal(getattr(ours.state, f).numpy(),
                                      np.asarray(getattr(ref.state, f)),
                                      err_msg=f)


def test_wrapper_loop_rebuild_matches_jax():
    """Out and back over the curved wall through both wrappers: the big
    change fires, the keyframe blocks move to the corrected poses, the
    culled keyframes' blocks go, and the blocks stay a disjoint ascending
    partition of [0, count)."""
    config = {"mapping": {"n_points_capacity": 1 << 16, "downscale_res": 2,
                          "initial_capacity": 1 << 13},
              "slam": dict(ORB_SLAM_CFG)}
    ref, ours = _run_wrappers(config, CurvedWallDataset(40))
    assert_same_wrapper(ours, ref)
    assert ours.last_big_change >= 1 and ours.map_updated
    culled = {int(round(f)) for f, _, c in ours.tracker.get_keyframes() if c}
    assert culled and not (culled & set(ours.kf_blocks))
    assert not (culled & set(ours.kfs))
    prev = 0
    for blk in ours.kf_blocks.values():
        assert blk["range"][0] == prev
        prev = blk["range"][1]
    assert prev == int(ours.state.count) == ours._blocks_end
    # the host's count bounds stay bounds after the compactions
    assert ours._count_ub >= int(ours.state.count)
    assert ours.count_upper_bound() >= int(ours.state.count)


def test_wrapper_reads_count_once_per_keyframe(monkeypatch):
    """The ORB tier reads the device once per tracker keyframe (the map's
    count after the insert), the reference twice; the rebuilds read
    nothing. close_loops: false keeps the tracker to odometry, as in the
    reference."""
    reads = []
    monkeypatch.setattr(orb, "map_count",
                        lambda st: reads.append(1) or int(st.count))
    config = {"mapping": {"n_points_capacity": 1 << 16, "downscale_res": 2,
                          "initial_capacity": 1 << 16},
              "slam": dict(ORB_SLAM_CFG, close_loops=False)}
    ref, ours = _run_wrappers(config, CurvedWallDataset(40))
    assert_same_wrapper(ours, ref)
    assert ours.last_big_change == 0
    assert len(reads) == ours.tracker.num_keyframes() == len(ours.kf_blocks)
