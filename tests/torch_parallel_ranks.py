"""Rank side of ``tests/test_torch_parallel.py``: a gloo world of CPU ranks
that runs the port's multi-process paths case by case. This module imports
torch and the port only, never JAX: the ranks are spawned processes that
import it by name.

``World(n, tmp)`` starts n ranks (``init_method="file://"`` under ``tmp``,
one torch thread each); ``World.run(case, **inputs)`` sends one case to
every rank and returns the ranks' results in rank order (numpy); a rank's
exception fails the call with its traceback.
"""
from __future__ import annotations

import copy
import multiprocessing as mp
import queue
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ovo_tpu_torch.parallel.mesh import counting_collectives


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x)
    return x


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# cases (run on every rank, in the same order)
# ---------------------------------------------------------------------------

def case_mesh_shapes():
    from ovo_tpu_torch.parallel.mesh import make_mesh

    out = {}
    for shape in (None, (4, 1), (2, 2), (1, 4)):
        m = make_mesh(shape)
        out[str(shape)] = dict(shape=m.shape, axes=m.axis_names,
                               devices=m.devices, dp=m.index("dp"),
                               tp=m.index("tp"))
    # the tp group sums over its own ranks only
    m = make_mesh((2, 2))
    t = torch.tensor([float(m.rank)])
    out["tp_sum"] = float(m.all_reduce(t, "tp")[0])
    out["dp_sum"] = float(m.all_reduce(torch.tensor([float(m.rank)]),
                                       "dp")[0])
    return out


def case_votes(pts, obj, valid, seg, depth, c2w, K, M, Kc):
    from ovo_tpu_torch.parallel.mesh import make_mesh, world_size
    from ovo_tpu_torch.parallel.shard import block_bounds, sharded_vote_step

    mesh = make_mesh((world_size(), 1))
    lo, hi = block_bounds(len(pts), mesh)
    with counting_collectives() as counts:
        res = sharded_vote_step(mesh, _t(pts[lo:hi]), _t(obj[lo:hi]),
                                _t(valid[lo:hi]), _t(seg), _t(depth),
                                _t(c2w), _t(K), n_masks=M, n_instances=Kc)
    return dict(res=_np(res), lo=lo, hi=hi, counts=dict(counts))


def case_associate_step(pts, obj, seg, mask_valid, depth, c2w, K, next_id,
                        M, Kc, track_th):
    from ovo_tpu_torch.parallel.mesh import make_mesh, world_size
    from ovo_tpu_torch.parallel.shard import (block_bounds,
                                              sharded_associate_step)

    mesh = make_mesh((world_size(), 1))
    lo, hi = block_bounds(len(pts), mesh)
    with counting_collectives() as counts:
        res = sharded_associate_step(
            mesh, _t(pts[lo:hi]), _t(obj[lo:hi]),
            torch.ones(hi - lo, dtype=torch.bool), _t(seg), _t(mask_valid),
            _t(depth), _t(c2w), _t(K), torch.tensor(next_id,
                                                     dtype=torch.int32),
            match_distance_th=0.05, track_th=track_th, n_masks=M,
            n_instances=Kc)
    return dict(res=_np(res), lo=lo, hi=hi, counts=dict(counts))


def case_associate_keyframe(pts, obj, seg, binary, mask_valid, depth, c2w, K,
                            Kc, track_th, use_filter, ratio, next_id):
    from ovo_tpu_torch.mapping.instances import init_instance_store
    from ovo_tpu_torch.mapping.map_state import init_map_state
    from ovo_tpu_torch.parallel.mesh import make_mesh, world_size
    from ovo_tpu_torch.parallel.shard import (gather_point_blocks,
                                              sharded_associate_keyframe)

    N = len(pts)
    state = init_map_state(N)
    state.points.copy_(_t(pts))
    state.obj_ids.copy_(_t(obj))
    state.count.fill_(N)
    store = init_instance_store(Kc, 4)
    store = store._replace(
        next_id=torch.tensor(next_id, dtype=torch.int32),
        active=torch.arange(Kc) < next_id)
    mesh = make_mesh((world_size(), 1))
    with counting_collectives() as counts:
        state, store, match = sharded_associate_keyframe(
            mesh, state, store, _t(seg), _t(binary), _t(mask_valid),
            _t(depth), _t(c2w), _t(K), 0, match_distance_th=0.05,
            track_th=track_th, use_depth_filter=use_filter,
            unbounded_top_k=True,
            rgb_depth_ratio=tuple(ratio) if ratio else None)
    with counting_collectives() as gather_counts:
        gather_point_blocks(mesh, state.obj_ids)
    import dataclasses

    return dict(obj_ids=_np(state.obj_ids),
                store={f.name: _np(getattr(store, f.name))
                       for f in dataclasses.fields(store)
                       if isinstance(getattr(store, f.name), torch.Tensor)},
                match={f.name: _np(getattr(match, f.name))
                       for f in dataclasses.fields(match)},
                counts=dict(counts), gather_counts=dict(gather_counts))


def case_similarity(txt, descs):
    from ovo_tpu_torch.ops.similarity import clip_cosine_similarity
    from ovo_tpu_torch.parallel.mesh import make_mesh, world_size
    from ovo_tpu_torch.parallel.shard import sharded_similarity

    mesh = make_mesh((world_size(), 1))
    with counting_collectives() as counts:
        out = sharded_similarity(mesh, clip_cosine_similarity, _t(txt),
                                 _t(descs))
    return dict(sim=_np(out), counts=dict(counts))


def _tiny_embedder(tree):
    from ovo_tpu_torch.models.clip import CLIPModel
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder

    model = CLIPModel.from_jax_params("tiny-test", tree, device="cpu")
    return TextRegionEmbedder(model, resize_method="multi_resolution")


def case_dp_embed(tree, imgs, masks, keeps):
    from ovo_tpu_torch.mapping.semantic import SemanticMapper

    sem = SemanticMapper(
        {"capacity": {"n_instances": 16, "n_masks": 4},
         "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                  "clip_dim": 32},
         "log": False, "parallel": {"dp_embed": True}},
        cam_intrinsics=np.eye(3, dtype=np.float32),
        embedder=_tiny_embedder(tree), device="cpu")
    with counting_collectives() as counts:
        out = sem._dp_embed_batch(imgs, _t(masks), _t(keeps))
    return dict(descs=_np(out), counts=dict(counts))


def case_tp_tower(tree, imgs):
    from ovo_tpu_torch.models.clip import CLIPModel
    from ovo_tpu_torch.parallel.mesh import make_mesh, tp_encode, \
        tp_shard_tower

    model = CLIPModel.from_jax_params("tiny-test", tree, device="cpu")
    mesh = make_mesh((2, 2))
    i = mesh.index("dp")
    per = len(imgs) // mesh.size("dp")
    shard = tp_shard_tower(model.visual, mesh, mesh.rank)
    with counting_collectives() as counts:
        feats = tp_encode(shard, model.cfg.vision,
                          _t(imgs[i * per:(i + 1) * per]), mesh)
    heads = shard.blocks[0].attn.qkv.w.shape[1] // 3
    return dict(feats=_np(feats), dp=i, tp=mesh.index("tp"),
                qkv_cols=heads, counts=dict(counts))


def case_merger_dp(tree, clips, lr):
    from ovo_tpu_torch.models.convert_jax import merger_from_jax_params
    from ovo_tpu_torch.models.merger import make_train_step
    from ovo_tpu_torch.parallel.mesh import (dp_average_gradients,
                                             make_mesh, world_size)
    from ovo_tpu_torch.parallel.shard import block_bounds

    mesh = make_mesh((world_size(), 1))
    params = merger_from_jax_params(tree, "cpu").params
    lo, hi = block_bounds(len(clips), mesh)
    grads = []
    avg = dp_average_gradients(mesh)

    def hook(ps):
        avg(ps)
        grads.extend(p.grad.clone() for p in ps.parameters())

    step = make_train_step(params, lr, grad_hook=hook)
    x = _t(clips[lo:hi])
    with counting_collectives() as counts:
        loss = step(x, x[:, 1])
    return dict(params={n: _np(p) for n, p in params.named_parameters()},
                grads=_np(grads), loss=float(loss), counts=dict(counts))


def pipeline_config(parallel):
    """tests/test_parallel.py's pipeline config."""
    return {
        "dataset_name": "synthetic", "use_wandb": False, "debug": False,
        "slam": {"slam_module": "vanilla", "save_estimated_cam": False},
        "mapping": {"map_every": 2, "k_pooling": 1, "downscale_res": 1,
                    "n_points_capacity": 1 << 16,
                    "initial_capacity": 1 << 16},
        "tracking": {"track_every": 1},
        "data": {"scene_name": "wall0"},
        "cam": {},
        "semantic": {
            "segment_every": 2, "match_distance_th": 0.05, "track_th": 40,
            "depth_filter": False, "log": False, "kf_queue_delay": 2,
            "capacity": {"n_instances": 64, "n_masks": 16},
            "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                     "clip_dim": 16},
            "parallel": parallel,
        },
    }


def run_port_pipeline(parallel, out_dir):
    """The synthetic wall through the port's OVOSemMap on the CPU; returns
    (obj_ids, points, active ids, descriptors, query) and the collectives
    counted over the run and the query."""
    from synthetic_scene import (CLASSES, SyntheticWallDataset,
                                 class_embeddings, mask_label_fn,
                                 synthetic_mask_fn)

    from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap

    embeds = class_embeddings(16)
    text_embeds = {c: embeds[i] for i, c in enumerate(CLASSES)}
    sem_map = OVOSemMap(
        pipeline_config(parallel), out_dir,
        mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
        embedder=RecordedEmbedder(16, mask_label_fn, embeds, text_embeds,
                                  device="cpu"),
        dataset=SyntheticWallDataset(n_frames=10), device="cpu")
    with counting_collectives() as counts:
        sem_map.run()
        sim = sem_map.ovo.query(CLASSES, templates=["{}"])
    state = sem_map.slam_backbone.get_map()
    n = int(state.count)
    return dict(obj_ids=_np(state.obj_ids[:n]), points=_np(state.points[:n]),
                active=sem_map.ovo.active_ids(),
                descs=_np(sem_map.ovo.store.clip_feature), sim=sim,
                keyframes=sem_map.ovo.kf_id, counts=dict(counts))


def case_pipeline(parallel):
    with tempfile.TemporaryDirectory() as out:
        return run_port_pipeline(parallel, out)


def case_dryrun():
    from ovo_tpu_torch.parallel.dryrun import rank_checks

    return rank_checks(torch.device("cpu"))


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def serve(rank, world, init_method, inbox, outbox):
    from ovo_tpu_torch.parallel.mesh import init_world

    torch.set_num_threads(1)
    init_world("gloo", rank, world, init_method)
    try:
        while True:
            msg = inbox.get()
            if msg is None:
                break
            name, kwargs = msg
            try:
                outbox.put((rank, True, CASES[name](**copy.deepcopy(kwargs))))
            except Exception:  # noqa: BLE001 -- reported to the test
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    def __init__(self, n: int, tmp):
        ctx = mp.get_context("spawn")
        self.n = n
        self.inboxes = [ctx.Queue() for _ in range(n)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(
            target=serve, args=(r, n, f"file://{tmp}/init", self.inboxes[r],
                                self.outbox), daemon=True)
            for r in range(n)]
        for p in self.procs:
            p.start()

    def run(self, case: str, timeout: float = 120.0, **inputs):
        for q in self.inboxes:
            q.put((case, inputs))
        got = {}
        for _ in range(self.n):
            try:
                rank, ok, res = self.outbox.get(timeout=timeout)
            except queue.Empty:
                raise AssertionError(f"{case}: a rank did not answer in "
                                     f"{timeout} s") from None
            if not ok:
                raise AssertionError(f"{case} failed on rank {rank}:\n{res}")
            got[rank] = res
        return [got[r] for r in range(self.n)]

    def close(self):
        for q in self.inboxes:
            q.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join()
