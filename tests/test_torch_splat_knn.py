"""The Gaussian-SLAM tier's device ops, port against ``ovo_tpu``: the
Morton-window kNN ops (``ops/knn.py``) and the differentiable tile splatter
(``ops/splat.py``), on the same numpy-seeded inputs.

Tolerances: Morton codes and dedup masks bit-equal, kNN mean distances
within 1e-6; render color / depth / alpha / trunc_residual within 2e-4 and
radii equal; the gradients of a random linear functional of the render
with respect to all five parameters within 1e-5 of the largest (f32: the
two packages sum the compositing weights' products in another order, and
atomic-free scatters of the gathers' gradients add in another order);
``render_gaussians_adaptive``'s k equal. The render cases: z ties on a
flat wall (every gaussian at one depth: the selection must break ties
toward the lower index, as ``lax.top_k``), truncation (K below the
touching count) and K = G. A selection by ``torch.topk`` (ties in no
promised order) must fail the tie case.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ovo_tpu.ops import knn as jknn
from ovo_tpu.ops import splat as jsplat
from ovo_tpu_torch.ops import knn as tknn
from ovo_tpu_torch.ops import splat as tsplat

HW = (48, 64)
K_CAM = np.array([[50.0, 0, 31.5], [0, 50.0, 23.5], [0, 0, 1]], np.float32)
FIELDS = ("xyz", "scales", "quats", "opacity", "colors")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: these tensors are small, and the tests share
    the machine's cores with other test processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(n, seed, grid=False):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    if grid:  # coarse grid: many equal Morton codes, so the tie order counts
        pts = (np.round(pts * 6) / 6).astype(np.float32)
    valid = rng.random(n) < 0.85
    return pts, valid


@pytest.mark.parametrize("grid", [False, True])
def test_morton_and_knn_mean_dist_match_jax(grid):
    pts, valid = _cloud(600, 1, grid)
    lo, hi = pts.min(0), pts.max(0)
    np.testing.assert_array_equal(
        tknn.morton_codes(torch.tensor(pts), torch.tensor(lo),
                          torch.tensor(hi)).numpy(),
        np.asarray(jknn.morton_codes(jnp.asarray(pts), jnp.asarray(lo),
                                     jnp.asarray(hi))).astype(np.int64))
    got = tknn.approx_knn_mean_dist(torch.tensor(pts), torch.tensor(valid),
                                    k=3).numpy()
    ref = np.asarray(jknn.approx_knn_mean_dist(jnp.asarray(pts),
                                               jnp.asarray(valid), k=3))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    assert (got[~valid] == 0).all() and (got[valid] > 0).mean() > 0.5


@pytest.mark.parametrize("grid", [False, True])
def test_radius_dedup_mask_matches_jax(grid):
    ref, ref_valid = _cloud(400, 2, grid)
    new, new_valid = _cloud(300, 3, grid)
    new[:60] = ref[:60] + 1e-4                 # duplicates: dropped
    args = (new, new_valid, ref, ref_valid)
    got = tknn.radius_dedup_mask(*map(torch.tensor, args), 0.02).numpy()
    want = np.asarray(jknn.radius_dedup_mask(*map(jnp.asarray, args), 0.02))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def render_scene(kind, n=300, seed=0):
    """``wall``: every gaussian at depth 2 (z ties everywhere); ``stack``:
    gaussians stacked over the same tiles at distinct depths."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    if kind == "wall":
        xyz[:, 0] = rng.uniform(-1.0, 1.0, n)
        xyz[:, 1] = rng.uniform(-0.7, 0.7, n)
        xyz[:, 2] = 2.0
        base = 0.04
    else:
        xyz[:, 0] = rng.uniform(-0.15, 0.15, n)
        xyz[:, 1] = rng.uniform(-0.15, 0.15, n)
        xyz[:, 2] = np.linspace(1.5, 3.5, n) + 0.01 * rng.standard_normal(n)
        base = 0.12
    scene = {
        "xyz": xyz,
        "scales": (base * rng.uniform(0.7, 1.3, (n, 3))).astype(np.float32),
        "quats": rng.standard_normal((n, 4)).astype(np.float32),
        "opacity": rng.uniform(0.2, 0.9, n).astype(np.float32),
        "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
    }
    valid = rng.random(n) < 0.9
    w2c = np.eye(4, dtype=np.float32)
    w2c[0, 3] = 0.02
    return scene, valid, w2c


def _weights(seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(HW + (3,)).astype(np.float32),
            rng.standard_normal(HW).astype(np.float32),
            rng.standard_normal(HW).astype(np.float32))


def _functional(out, w, lib):
    wc, wd, wa = (lib(x) for x in w)
    return ((out.color * wc).sum() + (out.depth * wd).sum()
            + (out.alpha * wa).sum())


def jax_render_and_grads(scene, valid, w2c, k):
    def f(*params):
        out = jsplat.render_gaussians(
            *params, jnp.asarray(valid), jnp.asarray(w2c),
            jnp.asarray(K_CAM), img_hw=HW, k_per_tile=k)
        return _functional(out, _weights(), jnp.asarray), out

    (_, out), grads = jax.value_and_grad(f, argnums=tuple(range(5)),
                                         has_aux=True)(
        *(jnp.asarray(scene[k_]) for k_ in FIELDS))
    return out, [np.asarray(g) for g in grads]


def torch_render_and_grads(scene, valid, w2c, k, pair_cap=None):
    params = [torch.tensor(scene[k_], requires_grad=True) for k_ in FIELDS]
    out = tsplat.render_gaussians(*params, torch.tensor(valid),
                                  torch.tensor(w2c), torch.tensor(K_CAM),
                                  img_hw=HW, k_per_tile=k, pair_cap=pair_cap)
    grads = torch.autograd.grad(_functional(out, _weights(), torch.tensor),
                                params)
    return out, [g.numpy() for g in grads]


def assert_render_close(tout, tgrads, jout, jgrads):
    for f in ("color", "depth", "alpha", "trunc_residual"):
        np.testing.assert_allclose(getattr(tout, f).detach().numpy(),
                                   np.asarray(getattr(jout, f)), atol=2e-4,
                                   rtol=0, err_msg=f)
    np.testing.assert_array_equal(tout.radii.detach().numpy(),
                                  np.asarray(jout.radii))
    for name, a, b in zip(FIELDS, tgrads, jgrads):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(),
                                   err_msg=f"d/d{name}")


@pytest.mark.parametrize("kind, k", [("wall", 16), ("stack", 64),
                                     ("stack", 300)],
                         ids=["z_ties", "truncated", "k_equals_g"])
def test_render_and_gradients_match_jax(kind, k):
    scene, valid, w2c = render_scene(kind)
    jout, jgrads = jax_render_and_grads(scene, valid, w2c, k)
    tout, tgrads = torch_render_and_grads(scene, valid, w2c, k)
    assert_render_close(tout, tgrads, jout, jgrads)
    if k < 300:   # the case's point: tiles hold more than K gaussians
        assert float(jout.trunc_residual) > 0
    else:
        assert float(tout.trunc_residual) == 0.0
    # a pair buffer with room to spare renders the same; a short one is
    # seen short by its n_pairs
    need = int(tout.n_pairs)
    roomy, _ = torch_render_and_grads(scene, valid, w2c, k,
                                      pair_cap=tsplat.pair_bucket(need))
    np.testing.assert_array_equal(roomy.color.detach().numpy(),
                                  tout.color.detach().numpy())
    short, _ = torch_render_and_grads(scene, valid, w2c, k,
                                      pair_cap=need // 2)
    assert int(short.n_pairs) == need > need // 2
    counted = tsplat.pair_count(*(torch.tensor(scene[f]) for f in FIELDS[:3]),
                                torch.tensor(valid), torch.tensor(w2c),
                                torch.tensor(K_CAM), img_hw=HW)
    assert int(counted) == need


def _select_by_topk(proj, visible, tile, n_tx, n_ty, k_sel, pair_cap):
    """The reference's dense form with torch.topk: ties in no promised
    order (a wrong variant)."""
    uv, radius, z = proj["uv"], proj["radius"], proj["z"]
    tx0, tx1, ty0, nb = tsplat._tile_boxes(uv, radius, visible, tile, n_tx,
                                           n_ty)
    ty1 = torch.clamp(torch.div(uv[:, 1] + radius, tile,
                                rounding_mode="floor"), 0, n_ty - 1)
    ti = torch.arange(n_tx * n_ty)
    ty, tx = (ti // n_tx)[:, None], (ti % n_tx)[:, None]
    touches = visible & (tx >= tx0) & (tx <= tx1) & (ty >= ty0) & (ty <= ty1)
    score = torch.where(touches, -z, float("-inf"))
    top, idx = torch.topk(score, k_sel, dim=1)
    return idx, torch.isfinite(top), touches.sum(1), nb.sum()


def test_topk_tie_order_breaks_the_tie_case(monkeypatch):
    scene, valid, w2c = render_scene("wall")
    jout, _ = jax_render_and_grads(scene, valid, w2c, 16)
    monkeypatch.setattr(tsplat, "_select", _select_by_topk)
    tout, _ = torch_render_and_grads(scene, valid, w2c, 16)
    assert np.abs(tout.color.detach().numpy()
                  - np.asarray(jout.color)).max() > 1e-2


def _scene_of(n, op, spread, seed):
    """The reference's stress scenes (tests/test_knn_splat.py): n
    gaussians stacked over the same tiles, or spread across the view."""
    rng = np.random.default_rng(seed)
    xyz = np.zeros((n, 3), np.float32)
    w = 0.95 if spread else 0.15
    xyz[:, 0] = rng.uniform(-w, w, n)
    xyz[:, 1] = rng.uniform(-w, w, n)
    xyz[:, 2] = (2.0 + 0.02 * rng.standard_normal(n) if spread else
                 np.linspace(1.5, 3.5, n) + 0.01 * rng.standard_normal(n))
    return {"xyz": xyz,
            "scales": np.full((n, 3), 0.03 if spread else 0.12, np.float32),
            "quats": np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
            "opacity": np.full((n,), op, np.float32),
            "colors": rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)}


@pytest.mark.parametrize("spread", [False, True], ids=["stack", "spread"])
def test_adaptive_k_matches_jax(spread):
    """The 0.05-opacity stack escalates past 64; the 0.9-opacity spread
    scene stays at 64 (the reference's tests/test_knn_splat.py cases)."""
    scene = _scene_of(256, 0.9 if spread else 0.05, spread,
                      9 if spread else 5)
    w2c = np.eye(4, dtype=np.float32)
    kw = dict(img_hw=(64, 64), tile=16, k_per_tile=64, residual_th=0.01)
    K = np.array([[60.0, 0, 32], [0, 60.0, 32], [0, 0, 1]], np.float32)
    valid = np.ones(256, bool)
    jout, jk = jsplat.render_gaussians_adaptive(
        *(jnp.asarray(scene[f]) for f in FIELDS), jnp.asarray(valid),
        jnp.asarray(w2c), jnp.asarray(K), **kw)
    tout, tk, _ = tsplat.render_gaussians_adaptive(
        *(torch.tensor(scene[f]) for f in FIELDS), torch.tensor(valid),
        torch.tensor(w2c), torch.tensor(K), **kw)
    assert tk == jk and (tk > 64) == (not spread)
    np.testing.assert_allclose(tout.color.numpy(), np.asarray(jout.color),
                               atol=2e-4, rtol=0)
