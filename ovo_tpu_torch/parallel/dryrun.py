"""Multi-process dry run of the port's parallel axes (the counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``):

    python -m ovo_tpu_torch.parallel.dryrun [--world N] [--backend {nccl,gloo}]

spawns N ranks under ``torch.multiprocessing``. The default is the card:
``nccl``, one rank a card, N the card count (at most the card count: nccl
refuses two ranks on one card); it raises when no card is present. The CPU
runs only when asked: ``--backend gloo --world N`` spawns N CPU processes.
Every rank runs, on small shapes:

  1. the tensor-parallel (tp) tower on its data-parallel (dp) block of
     images (``make_mesh``'s default shape), against the unsharded tower;
  2. a dp train step of the learned merger (one block at its width, 1152,
     head size 144), its gradients averaged by one ``all_reduce`` in the
     step's ``grad_hook``, against the single-process step on the whole
     batch;
  3. the point-sharded votes (``parallel/shard.sharded_vote_step``) against
     the same call in a world of one;
  4. a whole synthetic-wall scene through ``OVOSemMap`` with
     ``point_shard``, ``shard_query`` and ``dp_embed`` (``sam.batch: 2``)
     and a loop-closure event, against the same scene without them: equal
     object ids, classes and mIoU.

The scene is ``tests/synthetic_scene.py``'s painted wall (numpy only), as
the reference's dry run uses it. The last line printed is one JSON object
with rank 0's results.
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .mesh import (Mesh, dp_average_gradients, init_world, make_mesh,
                   tp_encode, tp_shard_tower, world_rank, world_size)
from .shard import block_bounds, sharded_vote_step

TESTS = Path(__file__).resolve().parents[2] / "tests"
# f32 limits: the tower's sums split over tp ranks (PARITY.md section 1);
# the dp step's loss and averaged gradients (order 1e-2) against the whole
# batch's; its parameters after one Adam step, where a gradient that is zero
# in exact arithmetic (a softmax ignores a shift) keeps each side's rounding
# noise, which Adam scales to at most lr / 2
TOWER_TOL = 2e-4
GRAD_TOL = 1e-6
MERGER_LR = 1e-3


def _tower(device) -> dict:
    from ..models import vit
    from ..models.clip import CLIPModel

    mesh = make_mesh()
    dp_i = mesh.index("dp")
    model = CLIPModel.random_init("tiny-test", seed=0, device=device)
    g = torch.Generator().manual_seed(1)
    imgs = torch.rand((2 * mesh.size("dp"), 64, 64, 3), generator=g)
    imgs = imgs[2 * dp_i:2 * dp_i + 2].to(device)
    shard = tp_shard_tower(model.visual, mesh, mesh.rank)
    got = tp_encode(shard, model.cfg.vision, imgs, mesh)
    with torch.no_grad():
        ref = vit.encode(model.visual, model.cfg.vision, imgs)
    err = float((got - ref).abs().max())
    if not err <= TOWER_TOL:
        raise AssertionError(f"tp tower off by {err}")
    return dict(mesh=list(mesh.shape), tower_max_abs_err=err,
                tower_out=list(got.shape))


def _merger(device) -> dict:
    from ..models.merger import init_merger, make_train_step

    mesh = make_mesh((world_size(), 1))
    n = mesh.size("dp")
    # the merger's own width and head size (144: attention takes the plain
    # route, which the step differentiates), one block
    params = init_merger(torch.Generator(device=device).manual_seed(0),
                         d_model=1152, depth=1, mlp_hidden=64, device=device)
    g = torch.Generator().manual_seed(2)
    clips = torch.randn((2 * n, 3, 1152), generator=g).to(device)
    target = clips[:, 1]
    lo, hi = block_bounds(2 * n, mesh)
    grads = {}

    def keep(tag, hook=None):
        def grad_hook(ps):
            if hook is not None:
                hook(ps)
            grads[tag] = [p.grad.clone() for p in ps.parameters()]
        return grad_hook

    dp_params = copy.deepcopy(params)
    loss = make_train_step(dp_params, MERGER_LR, grad_hook=keep(
        "dp", dp_average_gradients(mesh)))(clips[lo:hi], target[lo:hi])
    loss = mesh.all_reduce(loss.reshape(1), "dp") / n
    one = copy.deepcopy(params)
    ref_loss = make_train_step(one, MERGER_LR, grad_hook=keep("one"))(
        clips, target)
    grad_err = max(float((a - b).abs().max())
                   for a, b in zip(grads["dp"], grads["one"]))
    err = max(float((a - b).abs().max()) for a, b in zip(
        dp_params.parameters(), one.parameters()))
    loss_err = float((loss[0] - ref_loss).abs())
    if not (grad_err <= GRAD_TOL and loss_err <= GRAD_TOL
            and err <= MERGER_LR / 2 and torch.isfinite(loss).all()):
        raise AssertionError(f"dp merger step: gradients off by {grad_err}, "
                             f"loss by {loss_err}, params by {err}")
    return dict(merger_loss=float(loss[0]), merger_grad_max_abs_err=grad_err,
                merger_param_max_abs_err=err)


def _votes(device) -> dict:
    mesh = make_mesh((world_size(), 1))
    N = mesh.size("dp") * 128
    H, W, M, Kc = 24, 32, 8, 32
    rng = np.random.default_rng(2)
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)
    depth = rng.uniform(1.0, 3.0, (H, W)).astype(np.float32)
    uu, vv = rng.integers(0, W, N), rng.integers(0, H, N)
    z = depth[vv, uu]
    pts = np.stack([(uu - K[0, 2]) * z / K[0, 0],
                    (vv - K[1, 2]) * z / K[1, 1], z], 1).astype(np.float32)
    obj = rng.integers(-1, 4, N).astype(np.int32)
    seg = rng.integers(-1, M, (H, W)).astype(np.int32)

    def t(x):
        return torch.from_numpy(x).to(device)

    args = (t(pts), t(obj), torch.ones(N, dtype=torch.bool, device=device),
            t(seg), t(depth), t(np.eye(4, dtype=np.float32)), t(K))
    lo, hi = block_bounds(N, mesh)
    got = sharded_vote_step(mesh, *(a[lo:hi] for a in args[:3]), *args[3:],
                            n_masks=M, n_instances=Kc)
    ref = sharded_vote_step(Mesh.single(), *args, n_masks=M, n_instances=Kc)
    for a, b in zip(got[:3], ref[:3]):
        if not torch.equal(a, b):
            raise AssertionError("point-sharded votes differ")
    if not torch.equal(got[3], ref[3][lo:hi]):
        raise AssertionError("point-sharded mask slots differ")
    return dict(votes_total=int(got[0].sum()))


class _BatchRecordedEmbedder:
    """``data/masks.RecordedEmbedder`` with ``embed_masks_batch`` (the
    keyframes' lookups stacked), so that ``sam.batch`` and ``dp_embed``
    take the batched embedder path."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def embed_masks_batch(self, images, fused_maps, valid):
        return torch.stack([self.inner.embed_masks(*a)
                            for a in zip(images, fused_maps, valid)])


def _scene(device, parallel: dict) -> tuple:
    sys.path.insert(0, str(TESTS))
    from synthetic_scene import (CLASSES, SyntheticWallDataset,
                                 class_embeddings, gt_mesh, mask_label_fn,
                                 synthetic_mask_fn)

    from ..data.masks import CallableMaskSource, RecordedEmbedder
    from ..eval.semantics import iou_acc_from_confmat, update_confmat
    from ..eval.transfer import match_labels_to_vtx
    from ..mapping.pipeline import OVOSemMap

    config = {
        "dataset_name": "synthetic", "use_wandb": False,
        "slam": {"slam_module": "vanilla"},
        "mapping": {"map_every": 2, "k_pooling": 1, "downscale_res": 1,
                    "n_points_capacity": 1 << 17},
        "tracking": {"track_every": 1},
        "data": {"scene_name": "wall0"}, "cam": {},
        "semantic": {
            # segment 4 / map 2: frames 2, 6, 10 are map-only, so the
            # loop-closure event at frame 6 fires outside the segment path
            "segment_every": 4, "match_distance_th": 0.05, "track_th": 40,
            "depth_filter": False, "log": False, "kf_queue_delay": 1,
            "capacity": {"n_instances": 64, "n_masks": 16},
            "sam": {"batch": 2},
            "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                     "clip_dim": 16},
            "parallel": parallel,
        },
    }
    embeds = class_embeddings(16)
    text = {f"This is a photo of a {c}": embeds[i]
            for i, c in enumerate(CLASSES)}
    with tempfile.TemporaryDirectory() as out:
        sem_map = OVOSemMap(
            config, out, dataset=SyntheticWallDataset(n_frames=12),
            mask_source=CallableMaskSource(synthetic_mask_fn, 16, device),
            embedder=_BatchRecordedEmbedder(RecordedEmbedder(
                16, mask_label_fn, embeds, text, device=device)),
            device=device)
        backbone = sem_map.slam_backbone
        orig_map = backbone.map

        def lc_map(frame_data, c2w):
            orig_map(frame_data, c2w)
            backbone.kfs[frame_data[0]] = True
            if frame_data[0] == 6:
                backbone.map_updated = True

        backbone.map = lc_map
        # keyframes live on the segment cadence, the vanilla backbone's kf
        # dict on the map cadence: skip the keyframe cull
        backbone.get_kfs = lambda: None
        sem_map.run()
        state = backbone.get_map()
        n = int(state.count)
        info = sem_map.ovo.classify_instances(CLASSES)
    pts = state.points[:n].cpu().numpy()
    obj = state.obj_ids[:n].cpu().numpy()
    vtx, gt_labels = gt_mesh()
    mesh_ins, _, _ = match_labels_to_vtx(obj, pts, vtx)
    id_to_idx = {int(i): k for k, i in enumerate(info["ids"])}
    pred = info["classes"][np.vectorize(lambda v: id_to_idx[int(v)])(
        mesh_ins)]
    seen = (np.abs(vtx[:, 0]) < 1.9) & (np.abs(vtx[:, 1]) < 0.9)
    conf = np.zeros((len(CLASSES), len(CLASSES)), np.ulonglong)
    update_confmat(conf, gt_labels[seen], pred[seen], ignore=[])
    iou, mask_v, *_ = iou_acc_from_confmat(conf, len(CLASSES), [])
    return obj, info, float(np.mean(iou[mask_v]))


def _full_scene(device) -> dict:
    obj_1, info_1, miou_1 = _scene(device, {})
    obj_n, info_n, miou_n = _scene(device, {
        "point_shard": True, "shard_query": True, "dp_embed": True})
    if not (np.array_equal(obj_1, obj_n)
            and np.array_equal(info_1["classes"], info_n["classes"])
            and np.array_equal(info_1["ids"], info_n["ids"])
            and miou_1 == miou_n):
        raise AssertionError(f"the sharded scene differs: mIoU {miou_n} / "
                             f"{miou_1}")
    if not miou_1 > 0.7:
        raise AssertionError(f"full-scene mIoU degenerate: {miou_1}")
    return dict(scene_points=len(obj_n), scene_instances=len(info_n["ids"]),
                scene_miou=miou_n)


def rank_checks(device) -> dict:
    """The four checks on this rank of an initialised world (or a world of
    one); raises on a mismatch. Every rank must call it."""
    out = dict(world=world_size(), rank=world_rank(), device=str(device))
    for check in (_tower, _merger, _votes, _full_scene):
        out.update(check(device))
    return out


def _rank_main(rank: int, world: int, backend: str, init_method: str,
               out_dir: str) -> None:
    torch.set_num_threads(1)
    # f32 products stay f32 on the card (no TF32), as the port's pipeline
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = init_world(backend, rank, world, init_method)
    try:
        res = rank_checks(device)
        (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--world", type=int, default=None,
                        help="ranks (default: the card count, or 1)")
    parser.add_argument("--backend", choices=("nccl", "gloo"),
                        default="nccl",
                        help="nccl on the cards (default) or gloo on the CPU")
    args = parser.parse_args(argv)
    if args.backend == "nccl" and not torch.cuda.is_available():
        raise RuntimeError("ovo_tpu_torch: no CUDA device is available for "
                           "nccl; pass --backend gloo to run the ranks on "
                           "the CPU")
    if args.world is None:
        args.world = max(torch.cuda.device_count(), 1)
    if args.backend == "nccl":
        if args.world > torch.cuda.device_count():
            raise ValueError(f"nccl takes one rank a card: --world "
                             f"{args.world} > {torch.cuda.device_count()} "
                             f"cards")
    import torch.multiprocessing as tmp_mp

    with tempfile.TemporaryDirectory() as tmp:
        tmp_mp.spawn(_rank_main, args=(args.world, args.backend,
                                       f"file://{tmp}/init", tmp),
                     nprocs=args.world, join=True)
        results = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                   for r in range(args.world)]
    for r in results:
        print(f"[dryrun] rank {r['rank']}: {r}")
    print(json.dumps(dict(results[0], backend=args.backend,
                          ranks_ok=len(results))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
