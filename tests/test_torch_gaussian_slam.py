"""The Gaussian-SLAM tier's functions, port (``ovo_tpu_torch/slam/
gaussian``) against ``ovo_tpu`` on the same numpy-seeded inputs: losses,
the fixed-capacity map's updates, seeding, one Adam step of the mapper and
of the tracker, short runs judged by the reference tests' own outcome
checks, checkpoint dicts and PLY files across the packages, the backbone's
semantic view, the native odometry and the config loader.

Tolerances: integers and bools bit-equal (slots, ids, valid, seed indices,
seeding masks, the view's permutation and ids); f32 within 1e-6 where the
two sides compute alike (losses, the map's parameters) and within 1e-5 of
the largest after an Adam step (the render's gradients sum in another
order; one step moves a parameter by about lr * sign(g)). A median that
takes the lower middle value (``torch.median``) must fail the seeding
case.
"""
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.config import assemble_run_config as jax_assemble
from ovo_tpu.config import load_config as jax_load_config
from ovo_tpu.ops import splat as jsplat
from ovo_tpu.slam.gaussian import losses as jlosses
from ovo_tpu.slam.gaussian import mapper as jmapper
from ovo_tpu.slam.gaussian import model as jmodel
from ovo_tpu.slam.gaussian import tracker as jtracker
from ovo_tpu.slam.gaussian.backbone import WrapperGaussianSLAM as JaxGS

from ovo_tpu_torch.config import assemble_run_config, load_config
from ovo_tpu_torch.ops import splat as tsplat
from ovo_tpu_torch.slam.gaussian import losses as tlosses
from ovo_tpu_torch.slam.gaussian import mapper as tmapper
from ovo_tpu_torch.slam.gaussian import model as tmodel
from ovo_tpu_torch.slam.gaussian import tracker as ttracker
from ovo_tpu_torch.slam.gaussian.backbone import WrapperGaussianSLAM

ROOT = Path(__file__).resolve().parents[1]
IMG_HW = (48, 64)
K = np.array([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]], np.float32)
FIELDS = ("xyz", "f_dc", "scales_log", "quats", "opacity_logit", "ids",
          "obj_ids", "valid", "next_id")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the tests share
    the machine's cores with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def to_port(state) -> tmodel.GaussianState:
    """A JAX GaussianState, every slot, as the port's."""
    return tmodel.GaussianState(**{f: t(getattr(state, f)) for f in FIELDS})


def assert_state_equal(ts, js, atol=1e-6):
    for f in FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, atol=atol, rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


def _textured_cloud(n=256, seed=0):
    """The reference tests' fronto-parallel wall of points, z in [2, 2.3]."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-1.4, 1.4, n), rng.uniform(-1.0, 1.0, n),
                    2.0 + 0.3 * rng.random(n)], -1).astype(np.float32)
    return pts, rng.uniform(0.1, 1.0, (n, 3)).astype(np.float32)


def _fitted(capacity=512):
    """Both packages' state of the reference's tracker test."""
    pts, cols = _textured_cloud(256)
    js = jmodel.add_points(jmodel.init_gaussian_state(capacity),
                           jnp.asarray(pts), jnp.asarray(cols),
                           jnp.ones(256, bool))
    js = js._replace(opacity_logit=jnp.full((capacity,), 2.0))
    return js, to_port(js)


# ---------------------------------------------------------------- losses --
def test_losses_match_jax():
    rng = np.random.default_rng(0)
    a, b = (rng.random((32, 40, 3)).astype(np.float32) for _ in range(2))
    mask = rng.random((32, 40)) < 0.6
    s = rng.standard_normal((64, 3)).astype(np.float32)
    valid = rng.random(64) < 0.7
    pairs = [(tlosses.ssim(t(a), t(b)), jlosses.ssim(a, b)),
             (tlosses.psnr(t(a), t(b)), jlosses.psnr(a, b)),
             (tlosses.psnr(t(a), t(b), t(mask)),
              jlosses.psnr(a, b, jnp.asarray(mask))),
             (tlosses.isotropic_loss(t(s), t(valid)),
              jlosses.isotropic_loss(s, jnp.asarray(valid)))]
    pairs += [(tlosses.l1_loss(t(a), t(b), agg),
               jlosses.l1_loss(jnp.asarray(a), jnp.asarray(b), agg))
              for agg in ("mean", "sum", "none")]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    assert float(tlosses.ssim(t(a), t(a))) > 0.999


# ----------------------------------------------------------------- model --
def test_add_prune_densify_bit_equal():
    pts, cols = _textured_cloud(64, seed=1)
    mask = np.ones(64, bool)
    mask[50:] = False
    js = jmodel.add_points(jmodel.init_gaussian_state(128),
                           jnp.asarray(pts), jnp.asarray(cols),
                           jnp.asarray(mask))
    ts = tmodel.add_points(tmodel.init_gaussian_state(128), t(pts), t(cols),
                           t(mask))
    assert_state_equal(ts, js)
    # the second batch fills the free slots, the overflow is dropped
    js = jmodel.add_points(js, jnp.asarray(pts), jnp.asarray(cols),
                           jnp.ones(64, bool))
    ts = tmodel.add_points(ts, t(pts), t(cols), torch.ones(64, dtype=bool))
    assert_state_equal(ts, js)
    assert tmodel.n_valid(ts) == 114
    low = np.zeros(128, np.float32)
    low[[0, 7, 60]] = -5.0
    js = jmodel.prune_by_opacity(js._replace(
        opacity_logit=js.opacity_logit + low), 0.1)
    ts = tmodel.prune_by_opacity(ts._replace(
        opacity_logit=ts.opacity_logit + t(low)), 0.1)
    assert_state_equal(ts, js)
    # clone and split on planted gradients, the JAX package's draw injected
    scl = np.asarray(js.scales_log).copy()
    scl[[1, 9]] = np.log(2.0)
    js = js._replace(scales_log=jnp.asarray(scl),
                     obj_ids=js.obj_ids.at[1].set(7).at[2].set(9))
    ts = ts._replace(scales_log=t(scl), obj_ids=t(np.asarray(js.obj_ids)))
    grad = np.zeros(128, np.float32)
    grad[[1, 2, 3, 9, 20]] = 1.0
    key = jax.random.PRNGKey(3)
    jout, japp = jmodel.densify_clone_split(
        js, jnp.asarray(grad), key, jnp.asarray(0.5), jnp.asarray(0.01))
    tout, tapp = tmodel.densify_clone_split(
        ts, t(grad), 0.5, 0.01,
        noise=t(jax.random.normal(key, (2, 128, 3))))
    assert_state_equal(tout, jout)
    np.testing.assert_array_equal(tapp.numpy(), np.asarray(japp))
    assert tmodel.n_valid(tout) == tmodel.n_valid(ts) + 3 + 2


# ------------------------------------------------------------- seeding --
def test_select_seeds_bit_equal():
    """Seed order: edge pixels first, then the 16-bit pixel hash (2^16
    values over the frame: ties everywhere), lower pixel index first."""
    rng = np.random.default_rng(2)
    H, W = IMG_HW
    image = np.repeat(np.repeat(rng.uniform(0, 1, (6, 8, 3)), 8, 0), 8, 1)
    image = image.astype(np.float32)
    mask = rng.random((H, W)) < 0.7
    # depth encodes the pixel index exactly: the seeds' z names their pixel
    depth = (1.0 + np.arange(H * W) / 4096.0).reshape(H, W).astype(np.float32)
    w2c = np.eye(4, dtype=np.float32)
    for n in (600, 4000):
        jp, jc, jv = jmapper.select_seeds(
            jnp.asarray(mask), jnp.asarray(depth), jnp.asarray(image),
            jnp.asarray(w2c), jnp.asarray(K), max_seeds=n)
        tp, tc, tv = tmapper.select_seeds(t(mask), t(depth), t(image),
                                          t(w2c), t(K), max_seeds=n)
        np.testing.assert_array_equal(tp[:, 2].numpy(), np.asarray(jp)[:, 2])
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    assert not tv.all() and tv.any()   # 4000 > the masked pixels


def test_median_is_jnp_median():
    rng = np.random.default_rng(4)
    for n in (7, 8, 3072):
        x = rng.standard_normal(n).astype(np.float32)
        assert float(tmapper.median(t(x))) == float(jnp.median(x))


def _seeding_case():
    """The fitted state's render, and an input depth off it by 0.001 on
    half the pixels and 0.1 (a fifth of them 3.0) on the other half: the
    two middle errors are 0.001 and 0.1, so a lower-middle median moves
    the outlier gate from ~2.5 to ~0.05."""
    js, ts = _fitted()
    w2c = np.eye(4, dtype=np.float32)
    out = jsplat.render_gaussians(js.xyz, js.scales(), js.quats,
                                  js.opacity(), js.colors(), js.valid,
                                  jnp.asarray(w2c), jnp.asarray(K),
                                  img_hw=IMG_HW, k_per_tile=32)
    rng = np.random.default_rng(5)
    perm = rng.permutation(IMG_HW[0] * IMG_HW[1])
    off = np.select([perm % 2 == 0, perm % 10 == 1], [0.001, 3.0],
                    0.1).reshape(IMG_HW)
    depth = (np.asarray(out.depth) + off).astype(np.float32)
    image = np.asarray(out.color)
    args = (image, depth, w2c, K)
    jm = jmapper.seeding_mask(js, *map(jnp.asarray, args), jnp.asarray(False),
                              img_hw=IMG_HW, k_per_tile=32)
    return ts, args, np.asarray(jm)


def test_seeding_mask_matches_jax():
    ts, args, jm = _seeding_case()
    tm = tmapper.seeding_mask(ts, *map(t, args), False, img_hw=IMG_HW,
                              k_per_tile=32)
    np.testing.assert_array_equal(tm.numpy(), jm)
    assert 0 < jm.mean() < 1
    new = tmapper.seeding_mask(ts, *map(t, args), True, img_hw=IMG_HW)
    assert new.all()


def test_lower_median_breaks_seeding_mask(monkeypatch):
    ts, args, jm = _seeding_case()
    monkeypatch.setattr(tmapper, "median",
                        lambda x: torch.median(x.reshape(-1)))
    tm = tmapper.seeding_mask(ts, *map(t, args), False, img_hw=IMG_HW,
                              k_per_tile=32)
    assert (tm.numpy() != jm).mean() > 0.2


# ------------------------------------------------------- one Adam step --
def _window():
    rng = np.random.default_rng(6)
    H, W = IMG_HW
    imgs = rng.uniform(0.2, 0.8, (2, H, W, 3)).astype(np.float32)
    deps = np.full((2, H, W), 2.1, np.float32)
    w2cs = np.stack([np.eye(4, dtype=np.float32)] * 2)
    w2cs[1, 0, 3] = 0.05
    return imgs, deps, w2cs


def test_optimize_phase_one_step_matches_jax():
    js, ts = _fitted()
    imgs, deps, w2cs = _window()
    cfg = jmapper.MapperConfig(k_per_tile=32)
    params = {k: getattr(js, k) for k in jmapper.OPT_FIELDS}
    zeros = jax.tree_util.tree_map(jnp.zeros_like, params)
    sched = np.array([1, 0], np.int32)
    jout = jmapper.optimize_phase(
        js, zeros, zeros, jnp.zeros(512), jnp.zeros(512, jnp.int32),
        jnp.asarray(imgs), jnp.asarray(deps), jnp.asarray(w2cs),
        jnp.asarray(sched), jnp.asarray(K), img_hw=IMG_HW, cfg=cfg, it0=0,
        n_iters=1)
    m, v, ga, dn = tmapper._zero_moments(ts)
    tout = tmapper.optimize_phase(ts, m, v, ga, dn, t(imgs), t(deps),
                                  t(w2cs), sched, t(K), img_hw=IMG_HW,
                                  cfg=tmapper.MapperConfig(k_per_tile=32),
                                  it0=0, n_iters=1)
    assert_state_equal(tout[0], jout[0], atol=1e-5)
    for k in jmapper.OPT_FIELDS:
        for i in (1, 2):   # the moments
            b = np.asarray(jout[i][k])
            np.testing.assert_allclose(tout[i][k].numpy(), b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(tout[3].numpy(), np.asarray(jout[3]),
                               rtol=0, atol=1e-5 * float(jout[3].max()))
    np.testing.assert_array_equal(tout[4].numpy(), np.asarray(jout[4]))
    assert int(tout[5]) > 0


def test_short_pair_buffer_reruns_to_the_same_result(monkeypatch):
    """A pair buffer too small for the renders is seen at the next host
    read and the chunk (mapper) or the loop (tracker) runs again with a
    larger one: the same result as renders sized exactly."""
    js, ts = _fitted()
    imgs, deps, w2cs = _window()
    cfg = tmapper.MapperConfig(iters=5, k_per_tile=32)
    sched = np.array([1, 0, 1, 1, 0], np.int32)
    monkeypatch.setattr(tmapper, "PAIR_CHECK_EVERY", 2)
    args = (ts, t(imgs), t(deps), t(w2cs), sched, t(K))
    exact = tmapper.optimize_submap(*args, img_hw=IMG_HW, cfg=cfg)
    short = tmapper.optimize_submap(*args, img_hw=IMG_HW, cfg=cfg,
                                    pair_cap=10)
    for k in tmapper.OPT_FIELDS:
        assert torch.equal(getattr(short, k), getattr(exact, k)), k
    _, _, image, depth, w2c_init = _tracking_frame()
    kw = dict(img_hw=IMG_HW, iters=3, k_per_tile=32)
    a = ttracker.track_pose(ts, t(image), t(depth), t(w2c_init), t(K), **kw)
    b = ttracker.track_pose(ts, t(image), t(depth), t(w2c_init), t(K),
                            pair_cap=10, **kw)
    np.testing.assert_array_equal(a.w2c, b.w2c)
    assert a.loss == b.loss and b.pair_cap > 10


def _tracking_frame():
    js, ts = _fitted()
    w2c_true = np.eye(4, dtype=np.float32)
    out = jsplat.render_gaussians(js.xyz, js.scales(), js.quats,
                                  js.opacity(), js.colors(), js.valid,
                                  jnp.asarray(w2c_true), jnp.asarray(K),
                                  img_hw=IMG_HW, k_per_tile=32)
    alpha = np.asarray(out.alpha)
    depth = np.where(alpha > 0.5, np.asarray(out.depth)
                     / np.maximum(alpha, 1e-6), 0.0).astype(np.float32)
    w2c_init = w2c_true.copy()
    w2c_init[0, 3] += 0.04  # 4 cm lateral error
    return js, ts, np.asarray(out.color), depth, w2c_init


def test_track_pose_one_step_matches_jax():
    js, ts, image, depth, w2c_init = _tracking_frame()
    for iters in (1, 3):
        jres = jtracker.track_pose(js, jnp.asarray(image), jnp.asarray(depth),
                                   jnp.asarray(w2c_init), jnp.asarray(K),
                                   img_hw=IMG_HW, iters=iters, k_per_tile=32)
        tres = ttracker.track_pose(ts, t(image), t(depth), t(w2c_init), t(K),
                                   img_hw=IMG_HW, iters=iters, k_per_tile=32)
        np.testing.assert_allclose(tres.w2c, np.asarray(jres.w2c), atol=1e-5)
        for a, b in ((tres.loss, jres.loss),
                     (tres.init_loss, jres.init_loss)):
            np.testing.assert_allclose(a, float(b), rtol=1e-5)


def test_short_runs_pass_the_reference_outcome_checks():
    """The reference's tests/test_gaussian_slam.py outcome checks, on the
    port: tracking recovers a 4 cm perturbation; mapping a wall covers it
    at the right depth and a second pass seeds little."""
    _, ts, image, depth, w2c_init = _tracking_frame()
    res = ttracker.track_pose(ts, t(image), t(depth), t(w2c_init), t(K),
                              img_hw=IMG_HW, iters=80, k_per_tile=32)
    assert res.loss < 0.7 * res.init_loss
    assert abs(float(res.w2c[0, 3])) < 0.03

    rng = np.random.default_rng(2)
    H, W = IMG_HW
    depth = torch.full((H, W), 2.0)
    image = t(rng.uniform(0.2, 0.8, (H, W, 3)).astype(np.float32))
    w2c = torch.eye(4)
    cfg = tmapper.MapperConfig(iters=25, max_seeds=2048, k_per_tile=32)
    kw = dict(img_hw=IMG_HW, cfg=cfg)
    views = (image[None], depth[None], w2c[None])
    st = tmapper.map_keyframe(tmodel.init_gaussian_state(8192), image, depth,
                              w2c, t(K), *views, is_new_submap=True, seed=0,
                              **kw)
    assert tmodel.n_valid(st) > 500
    out = tsplat.render_gaussians(st.xyz, st.scales(), st.quats,
                                  st.opacity(), st.colors(), st.valid, w2c,
                                  t(K), img_hw=IMG_HW, k_per_tile=32)
    alpha = out.alpha.numpy()
    assert alpha.mean() > 0.5
    covered = alpha > 0.7
    d_err = np.abs(out.depth.numpy() / np.maximum(alpha, 1e-6)
                   - 2.0)[covered]
    assert np.median(d_err) < 0.05
    st2 = tmapper.map_keyframe(st, image, depth, w2c, t(K), *views,
                               is_new_submap=False, seed=1, **kw)
    assert tmodel.n_valid(st2) - tmodel.n_valid(st) < \
        0.5 * tmodel.n_valid(st)


# ------------------------------------------------ checkpoints and files --
def test_map_dict_and_ply_cross_package(tmp_path):
    js, _ = _fitted(capacity=300)
    js = jmodel.prune_by_opacity(js._replace(
        opacity_logit=js.opacity_logit.at[::5].set(-6.0),
        obj_ids=js.obj_ids.at[:200].set(jnp.arange(200) % 7)), 0.1)
    jd = jmodel.gaussian_map_dict(js)
    ts = tmodel.from_gaussian_map_dict(jd, 300)
    back = jmodel.from_gaussian_map_dict(tmodel.gaussian_map_dict(ts), 300)
    assert_state_equal(ts, back, atol=0)
    jmodel.save_gaussian_ply(js, tmp_path / "jax.ply")
    tmodel.save_gaussian_ply(ts, tmp_path / "port.ply")
    assert (tmp_path / "jax.ply").read_bytes() == \
        (tmp_path / "port.ply").read_bytes()
    assert_state_equal(tmodel.load_gaussian_ply(tmp_path / "jax.ply", 300),
                       jmodel.load_gaussian_ply(tmp_path / "port.ply", 300),
                       atol=0)
    assert tmodel.n_valid(ts) == int(js.valid.sum()) == 256 - 52


def test_semantic_view_and_obj_id_writeback_bit_equal():
    cfg = {"dataset_name": "synthetic",
           "mapping": {"n_gaussians_capacity": 512},
           "tracking": {"gt_camera": True}}
    js, _ = _fitted()
    js = jmodel.prune_by_opacity(js._replace(
        opacity_logit=js.opacity_logit.at[::3].set(-6.0)), 0.1)
    jb = JaxGS(copy.deepcopy(cfg), K)
    tb = WrapperGaussianSLAM(copy.deepcopy(cfg), K, device="cpu")
    jb.state, tb.state = js, to_port(js)
    jv, tv = jb.get_map(), tb.get_map()
    for f in ("points", "point_ids", "obj_ids", "colors", "count",
              "next_point_id"):
        np.testing.assert_array_equal(getattr(tv, f).numpy(),
                                      np.asarray(getattr(jv, f)), err_msg=f)
    ids = np.random.default_rng(7).integers(-1, 9, 512).astype(np.int32)
    jb.update_pcd_obj_ids(ids)
    tb.update_pcd_obj_ids(ids)
    np.testing.assert_array_equal(tb.state.obj_ids.numpy(),
                                  np.asarray(jb.state.obj_ids))
    np.testing.assert_array_equal(tb.get_pcd_colors(), jb.get_pcd_colors())
    assert tb.supports_fused_insert is False and tb.map_updated is False


def test_odometer_matches_jax():
    """Both packages' VisualOdometer on the same three frames of the
    curved-wall scene: the same native tracker, the same relative poses."""
    from orb_scene import CurvedWallDataset

    from ovo_tpu.slam.gaussian.odometer import VisualOdometer as JaxOdo
    from ovo_tpu_torch.slam.gaussian.odometer import VisualOdometer

    ds = CurvedWallDataset(3)
    Kc = ds.intrinsics
    args = (float(Kc[0, 0]), float(Kc[1, 1]), float(Kc[0, 2]),
            float(Kc[1, 2]))
    jo, to = JaxOdo(*args), VisualOdometer(*args)
    for i in range(3):
        _, image, depth, _ = ds[i]
        a, b = to.estimate_rel_pose(image, depth), \
            jo.estimate_rel_pose(image, depth)
        assert (a is None) == (b is None) == (i == 0)
        if b is not None:
            np.testing.assert_array_equal(a, b)
            assert np.abs(a[:3, 3]).max() > 1e-3
    jo.shutdown()
    to.shutdown()


# ---------------------------------------------------------------- config --
def test_replica_config_reads_as_jax():
    path = ROOT / "configs" / "slam" / "gaussian_slam" / "replica.yaml"
    ours = load_config(path)
    assert ours == jax_load_config(path)
    assert ours["mapping"]["new_points_radius"] == 1e-7
    over = {"slam": {"slam_module": "gaussian_slam"}}
    args = (ROOT / "configs", "Replica", "room0")
    cfg = assemble_run_config(*args, overrides=copy.deepcopy(over))
    assert cfg == jax_assemble(*args, overrides=copy.deepcopy(over))
    assert cfg["mapping"]["n_gaussians_capacity"] == 2 ** 20
    # the backbone reads the config's knobs as the reference's does
    cfg["tracking"]["odometry_type"] = "const_speed"
    jb, tb = JaxGS(copy.deepcopy(cfg), K), \
        WrapperGaussianSLAM(copy.deepcopy(cfg), K, device="cpu")
    assert tb.cfg._asdict() == jb.cfg._asdict()
    for k in ("track_iters", "track_color_w", "track_depth_w", "track_lr_q",
              "track_lr_t", "init_err_ratio", "kf_window", "max_k_per_tile",
              "new_submap_every", "gt_camera"):
        assert getattr(tb, k) == getattr(jb, k), k
