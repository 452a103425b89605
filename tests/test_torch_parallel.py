"""The port's multi-process paths (``ovo_tpu_torch/parallel``) in one gloo
world of 4 CPU ranks, against the JAX package's single-device path and its
8-device mesh (``tests/test_parallel.py``'s cases on the same numpy
inputs), and against the port's own single-process path.

The ranks run ``tests/torch_parallel_ranks.py`` (torch only; the world is
spawned once for the module). Tolerances: integers bit-equal (votes,
decisions, relabelled ids, the store, the keyframe match, the pipeline's
map, active ids and descriptors); the sharded query within 1e-5 with the
same argmax (its matmul sums blocks of rows); the data-parallel embedder
within 2e-5 (a tower batch of 2 against one of 6); the tensor-parallel tower
within 2e-4 (PARITY.md section 1: its sums split over ranks); the dp merger
step's averaged gradients within 1e-6 and its parameters within lr / 2
(``ovo_tpu_torch/parallel/dryrun.py``: where a gradient is zero in exact
arithmetic Adam scales each side's rounding noise up to that)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ovo_tpu.mapping.association import associate_keyframe
from ovo_tpu.mapping.instances import init_instance_store
from ovo_tpu.mapping.map_state import init_map_state
from ovo_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ovo_tpu.parallel.shard import (sharded_associate_keyframe,
                                    sharded_associate_step,
                                    sharded_vote_step)

from torch_parallel_ranks import World, run_port_pipeline

N_RANKS = 4

# one world for the module: under xdist every worker that takes a test of
# this module spawns its own, so the module goes to one worker whole (the
# tier-1 run's ``--dist loadfile`` does so for every file; the group does it
# under ``--dist loadgroup``)
pytestmark = pytest.mark.xdist_group("torch_parallel_world")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(N_RANKS, tmp_path_factory.mktemp("world"))
    yield w
    w.close()


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) == 8, "conftest must force 8 cpu devices"
    return jax_make_mesh((8, 1))


def _frame(rng, N=1024, H=32, W=48, M=8, seg_scale=1):
    K = np.array([[40.0, 0, W / 2 - 0.5], [0, 40.0, H / 2 - 0.5],
                  [0, 0, 1]], dtype=np.float32)
    depth = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    uu = rng.integers(1, W - 1, N)
    vv = rng.integers(1, H - 1, N)
    z = depth[vv, uu]
    pts = np.stack([(uu - K[0, 2]) * z / K[0, 0],
                    (vv - K[1, 2]) * z / K[1, 1], z], 1).astype(np.float32)
    obj = rng.integers(-1, 5, N).astype(np.int32)
    seg = rng.integers(-1, M, (seg_scale * H, seg_scale * W)).astype(
        np.int32)
    return dict(pts=pts, obj=obj, seg=seg, depth=depth,
                c2w=np.eye(4, dtype=np.float32), K=K)


def _concat_blocks(results, key):
    return np.concatenate([r["res"][key] if isinstance(key, int)
                           else r[key] for r in results])


def test_mesh_shapes_and_groups(world):
    res = world.run("mesh_shapes")
    for r, out in enumerate(res):
        # default: tp 2 once the rank count is even and at least 4
        assert out["None"]["shape"] == (2, 2)
        assert out["(2, 2)"]["axes"] == ("dp", "tp")
        np.testing.assert_array_equal(out["(4, 1)"]["devices"],
                                      np.arange(4).reshape(4, 1))
        assert (out["(2, 2)"]["dp"], out["(2, 2)"]["tp"]) == divmod(r, 2)
        assert (out["(1, 4)"]["dp"], out["(1, 4)"]["tp"]) == (0, r)
        # rank = dp * 2 + tp: tp groups {0, 1}, {2, 3}; dp groups {0, 2},
        # {1, 3}
        assert out["tp_sum"] == (1.0 if r < 2 else 5.0)
        assert out["dp_sum"] == (2.0 if r % 2 == 0 else 4.0)
    assert jax_make_mesh((4, 2)).devices.shape == (4, 2)


def test_sharded_votes_match_jax(world, mesh8, rng):
    f = _frame(rng)
    M, Kc, N = 8, 32, len(f["pts"])
    valid = np.ones(N, bool)
    res = world.run("votes", pts=f["pts"], obj=f["obj"], valid=valid,
                    seg=f["seg"], depth=f["depth"], c2w=f["c2w"], K=f["K"],
                    M=M, Kc=Kc)
    jax_out = sharded_vote_step(
        mesh8, jnp.asarray(f["pts"]), jnp.asarray(f["obj"]),
        jnp.asarray(valid), jnp.asarray(f["seg"]), jnp.asarray(f["depth"]),
        jnp.asarray(f["c2w"]), jnp.asarray(f["K"]), n_masks=M,
        n_instances=Kc)
    for r in res:
        for i in range(3):
            np.testing.assert_array_equal(r["res"][i],
                                          np.asarray(jax_out[i]))
        assert r["counts"] == {"all_reduce": 1}
    assert [(r["lo"], r["hi"]) for r in res] == [
        (i * 256, (i + 1) * 256) for i in range(4)]
    np.testing.assert_array_equal(_concat_blocks(res, 3),
                                  np.asarray(jax_out[3]))


def test_sharded_associate_step_one_collective_matches_jax(world, mesh8,
                                                           rng):
    """Votes, decisions, minting and the local relabel: exactly one
    collective on each rank, the relabelled ids and the per-mask decisions
    equal to JAX's single-device associate_keyframe and its mesh8 step."""
    f = _frame(rng)
    M, Kc, N = 8, 32, len(f["pts"])
    mask_valid = np.ones(M, bool)
    mask_valid[3] = False
    binary = np.stack([f["seg"] == m for m in range(M)])
    res = world.run("associate_step", pts=f["pts"], obj=f["obj"],
                    seg=f["seg"], mask_valid=mask_valid, depth=f["depth"],
                    c2w=f["c2w"], K=f["K"], next_id=5, M=M, Kc=Kc,
                    track_th=20)
    state = init_map_state(N)._replace(
        points=jnp.asarray(f["pts"]), obj_ids=jnp.asarray(f["obj"]),
        count=jnp.asarray(N, jnp.int32))
    store = init_instance_store(Kc, 4)
    store = store._replace(next_id=jnp.asarray(5, jnp.int32),
                           active=store.active.at[:5].set(True))
    ref_state, _, ref_match = associate_keyframe(
        state, store, jnp.asarray(f["seg"]), jnp.asarray(binary),
        jnp.asarray(mask_valid), jnp.asarray(f["depth"]),
        jnp.asarray(f["c2w"]), jnp.asarray(f["K"]), jnp.asarray(0, jnp.int32),
        match_distance_th=0.05, track_th=20, use_depth_filter=False,
        unbounded_top_k=True)
    sh = NamedSharding(mesh8, P("dp"))
    j_obj, j_ins, j_new, j_drop, j_un, j_matched = sharded_associate_step(
        mesh8, jax.device_put(jnp.asarray(f["pts"]), sh),
        jax.device_put(jnp.asarray(f["obj"]), sh),
        jax.device_put(jnp.ones(N, bool), sh), jnp.asarray(f["seg"]),
        jnp.asarray(mask_valid), jnp.asarray(f["depth"]),
        jnp.asarray(f["c2w"]), jnp.asarray(f["K"]),
        jnp.asarray(5, jnp.int32), match_distance_th=0.05, track_th=20,
        n_masks=M, n_instances=Kc)
    new_obj = _concat_blocks(res, 0)
    np.testing.assert_array_equal(new_obj, np.asarray(ref_state.obj_ids))
    np.testing.assert_array_equal(new_obj, np.asarray(j_obj))
    kept = np.asarray(ref_match.keep)
    for r in res:
        assert r["counts"] == {"all_reduce": 1}, r["counts"]
        _, ins, n_new, dropped, unassigned, n_matched = r["res"]
        np.testing.assert_array_equal(ins, np.asarray(j_ins))
        np.testing.assert_array_equal(ins[kept],
                                      np.asarray(ref_match.ins_ids)[kept])
        assert int(n_new) == int(j_new) == int(ref_match.n_new)
        assert int(dropped) == int(j_drop)
        np.testing.assert_array_equal(unassigned, np.asarray(j_un))
        assert int(n_matched) == int(j_matched) == int(ref_match.n_matched)


@pytest.mark.parametrize("use_filter,ratio", [
    (False, None), (True, None), (False, (2.0, 2.0, 0))])
def test_sharded_associate_keyframe_matches_jax(world, mesh8, rng,
                                                use_filter, ratio):
    """The drop-in wrapper and the blocks' gather: the map's ids, the whole
    store and the keyframe match bit-equal to JAX's associate_keyframe and
    its mesh8 wrapper, with and without the depth filter and the RGB / depth
    resolution remap; one collective in the association, one in the
    gather."""
    f = _frame(rng, seg_scale=2 if ratio else 1)
    M, Kc, N = 8, 32, len(f["pts"])
    mask_valid = np.ones(M, bool)
    mask_valid[3] = False
    binary = np.stack([f["seg"] == m for m in range(M)])
    res = world.run("associate_keyframe", pts=f["pts"], obj=f["obj"],
                    seg=f["seg"], binary=binary, mask_valid=mask_valid,
                    depth=f["depth"], c2w=f["c2w"], K=f["K"], Kc=Kc,
                    track_th=20, use_filter=use_filter, ratio=ratio,
                    next_id=5)

    def fresh():
        state = init_map_state(N)._replace(
            points=jnp.asarray(f["pts"]), obj_ids=jnp.asarray(f["obj"]),
            count=jnp.asarray(N, jnp.int32))
        store = init_instance_store(Kc, 4)
        return state, store._replace(next_id=jnp.asarray(5, jnp.int32),
                                     active=store.active.at[:5].set(True))

    args = (jnp.asarray(f["seg"]), jnp.asarray(binary),
            jnp.asarray(mask_valid), jnp.asarray(f["depth"]),
            jnp.asarray(f["c2w"]), jnp.asarray(f["K"]),
            jnp.asarray(0, jnp.int32))
    kw = dict(match_distance_th=0.05, track_th=20,
              use_depth_filter=use_filter, unbounded_top_k=True,
              rgb_depth_ratio=ratio)
    refs = [associate_keyframe(*fresh(), *args, **kw),
            sharded_associate_keyframe(mesh8, *fresh(), *args, **kw)]
    for r in res:
        assert r["counts"] == {"all_reduce": 1}, r["counts"]
        assert r["gather_counts"] == {"all_gather": 1}, r["gather_counts"]
        for ref_state, ref_store, ref_match in refs:
            np.testing.assert_array_equal(r["obj_ids"],
                                          np.asarray(ref_state.obj_ids))
            for name in ref_store._fields:
                np.testing.assert_array_equal(
                    r["store"][name], np.asarray(getattr(ref_store, name)),
                    err_msg=f"store.{name}")
            for name in ref_match._fields:
                np.testing.assert_array_equal(
                    r["match"][name], np.asarray(getattr(ref_match, name)),
                    err_msg=f"match.{name}")


def test_sharded_similarity_matches(world, mesh8, rng):
    from ovo_tpu.ops.similarity import clip_cosine_similarity
    from ovo_tpu.parallel.shard import sharded_similarity

    txt = rng.standard_normal((3, 16)).astype(np.float32)
    descs = rng.standard_normal((21, 16)).astype(np.float32)  # pads to 24
    ref = np.asarray(clip_cosine_similarity(jnp.asarray(txt),
                                            jnp.asarray(descs)))
    j = np.asarray(sharded_similarity(mesh8, clip_cosine_similarity,
                                      jnp.asarray(txt), jnp.asarray(descs)))
    for r in world.run("similarity", txt=txt, descs=descs):
        assert r["sim"].shape == (21, 3)
        assert r["counts"] == {"all_gather": 1}
        for want in (ref, j):
            np.testing.assert_allclose(r["sim"], want, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(r["sim"].argmax(1),
                                          want.argmax(1))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_dp_embed_matches_replicated(world, rng):
    """SemanticMapper._dp_embed_batch with 6 keyframes on 4 ranks (padded
    to 8) against JAX's replicated embed_masks_batch and the port's."""
    from ovo_tpu.models.clip import CLIPModel as JaxCLIP
    from ovo_tpu.models.textregion import TextRegionEmbedder as JaxTR

    from torch_parallel_ranks import _tiny_embedder

    model = JaxCLIP.random_init("tiny-test")
    B, H, W = 6, 64, 96
    imgs = (rng.random((B, H, W, 3)) * 255).astype(np.uint8)
    masks = np.zeros((B, 4, H, W), bool)
    masks[:, 0, :30, :30] = True
    masks[:, 1, 30:, 40:] = True
    keeps = np.ones((B, 4), bool)
    ref = np.asarray(JaxTR(model, resize_method="multi_resolution")
                     .embed_masks_batch(imgs, jnp.asarray(masks),
                                        jnp.asarray(keeps)))
    tree = _np_tree(model.params)
    port = _tiny_embedder(tree).embed_masks_batch(
        torch.from_numpy(imgs), torch.from_numpy(masks),
        torch.from_numpy(keeps)).numpy()
    for r in world.run("dp_embed", tree=tree, imgs=imgs, masks=masks,
                       keeps=keeps):
        assert r["descs"].shape == ref.shape == (B, 4, 32)
        assert r["counts"] == {"all_gather": 1}
        np.testing.assert_allclose(r["descs"], ref, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(r["descs"], port, rtol=2e-5, atol=2e-5)


def test_tp_tower_matches_unsharded(world, rng):
    """The Megatron tower on a (2, 2) mesh: each dp row encodes its block of
    images with half the heads and half the MLP per rank, two all_reduce a
    block, and matches the unsharded tower (and JAX's encode)."""
    from ovo_tpu.models import vit as jax_vit
    from ovo_tpu.models.clip import CLIPModel as JaxCLIP

    from ovo_tpu_torch.models import vit
    from ovo_tpu_torch.models.clip import CLIPModel

    jm = JaxCLIP.random_init("tiny-test")
    tree = _np_tree(jm.params)
    imgs = rng.random((4, 64, 64, 3)).astype(np.float32)
    model = CLIPModel.from_jax_params("tiny-test", tree, device="cpu")
    with torch.no_grad():
        ref = vit.encode(model.visual, model.cfg.vision,
                         torch.from_numpy(imgs)).numpy()
    jref = np.asarray(jax_vit.encode(jm.params["visual"], jm.cfg.vision,
                                     jnp.asarray(imgs)))
    depth = len(model.visual.blocks)
    for r in world.run("tp_tower", tree=tree, imgs=imgs):
        assert r["qkv_cols"] == 32                       # 2 of 4 heads
        assert r["counts"] == {"all_reduce": 2 * depth}
        blk = slice(2 * r["dp"], 2 * r["dp"] + 2)
        np.testing.assert_allclose(r["feats"], ref[blk], rtol=0, atol=2e-4)
        np.testing.assert_allclose(r["feats"], jref[blk], rtol=0, atol=2e-4)


def test_dp_merger_step_matches_whole_batch(world, rng):
    """The data-parallel train step (2 clips a rank, gradients averaged by
    one all_reduce in grad_hook) against the port's single-process step
    on the whole batch of 8."""
    from ovo_tpu.models import merger as jmerger

    from ovo_tpu_torch.models.convert_jax import merger_from_jax_params
    from ovo_tpu_torch.models.merger import make_train_step

    tree = _np_tree(jmerger.init_merger(jax.random.PRNGKey(4), d_model=64,
                                        depth=2, n_heads=8, mlp_hidden=32))
    clips = rng.standard_normal((8, 3, 64)).astype(np.float32)
    lr = 1e-3
    params = merger_from_jax_params(tree, "cpu").params
    grads = []
    step = make_train_step(params, lr, grad_hook=lambda ps: grads.extend(
        p.grad.clone() for p in ps.parameters()))
    x = torch.from_numpy(clips)
    loss = float(step(x, x[:, 1]))
    res = world.run("merger_dp", tree=tree, clips=clips, lr=lr)
    assert abs(np.mean([r["loss"] for r in res]) - loss) <= 1e-6
    for r in res:
        assert r["counts"] == {"all_reduce": 1}
        for g, want in zip(r["grads"], grads):
            np.testing.assert_allclose(g, want.numpy(), rtol=0, atol=1e-6)
        for name, p in params.named_parameters():
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), rtol=0,
                                       atol=lr / 2, err_msg=name)
        np.testing.assert_array_equal(r["params"]["head.fc.w"],
                                      res[0]["params"]["head.fc.w"])


def test_pipeline_point_shard_e2e(world, tmp_path):
    """tests/test_parallel.py's pipeline case: OVOSemMap with
    point_shard + shard_query on 4 ranks gives the instance map, points,
    active ids and descriptors of the port's single-process run and of
    JAX's, and the same query within 1e-5; two collectives a keyframe (the
    votes, the gather of the relabelled blocks), one for the query."""
    import copy

    from synthetic_scene import (CLASSES, SyntheticWallDataset,
                                 class_embeddings, mask_label_fn,
                                 synthetic_mask_fn)
    from ovo_tpu.data.masks import CallableMaskSource, RecordedEmbedder
    from ovo_tpu.mapping.pipeline import OVOSemMap

    from torch_parallel_ranks import pipeline_config

    embeds = class_embeddings(16)
    j = OVOSemMap(copy.deepcopy(pipeline_config({})), tmp_path / "jax",
                  mask_source=CallableMaskSource(synthetic_mask_fn,
                                                 max_masks=16),
                  embedder=RecordedEmbedder(
                      16, mask_label_fn, embeds,
                      {c: embeds[i] for i, c in enumerate(CLASSES)}),
                  dataset=SyntheticWallDataset(n_frames=10))
    j.run()
    js = j.slam_backbone.get_map()
    n = int(js.count)
    jax_run = dict(obj_ids=np.asarray(js.obj_ids[:n]),
                   points=np.asarray(js.points[:n]),
                   active=j.ovo.active_ids(),
                   descs=np.asarray(j.ovo.store.clip_feature),
                   sim=j.ovo.query(CLASSES, templates=["{}"]))
    single = run_port_pipeline({}, tmp_path / "port")
    assert single["counts"] == {}
    res = world.run("pipeline",
                    parallel={"point_shard": True, "shard_query": True})
    for r in res:
        assert r["counts"] == {"all_reduce": r["keyframes"],
                               "all_gather": r["keyframes"] + 1}
        for base in (single, jax_run):
            np.testing.assert_array_equal(r["obj_ids"], base["obj_ids"])
            np.testing.assert_array_equal(r["points"], base["points"])
            np.testing.assert_array_equal(r["active"], base["active"])
            np.testing.assert_array_equal(r["descs"], base["descs"])
            np.testing.assert_allclose(r["sim"], base["sim"], rtol=1e-5,
                                       atol=1e-5)


def test_dryrun_in_a_world_of_four(world):
    """The port's dry run (``python -m ovo_tpu_torch.parallel.dryrun``) on
    every rank of the world: the tp + dp tower, the dp merger step, the
    point-sharded votes and a whole scene with point_shard, shard_query,
    dp_embed and a loop-closure event, each against the world of one."""
    for r in world.run("dryrun", timeout=240):
        assert r["world"] == N_RANKS and r["mesh"] == [2, 2]
        assert r["scene_miou"] > 0.7 and r["scene_instances"] >= 3


def test_nccl_and_gloo_refuse_the_other_device():
    from ovo_tpu_torch.parallel.mesh import Mesh, make_mesh

    for backend, dev in (("nccl", "cpu"), ("gloo", "cuda")):
        mesh = Mesh((1, 1), ("dp", "tp"), 0, {"dp": None, "tp": None},
                    backend)
        with pytest.raises(ValueError, match=backend):
            mesh.check_device(dev)
    # no process group: a world of one with trivial collectives
    mesh = make_mesh()
    assert mesh.shape == (1, 1) and mesh.backend is None
    t = torch.arange(3)
    assert mesh.all_reduce(t, "dp") is t
    assert torch.equal(mesh.all_gather(t, "dp"), t)
