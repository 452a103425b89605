"""The ORB tier end to end, through both packages: ``OVOSemMap`` with
``slam_module: orbslam`` on an out-and-back scene (poses from the native
tracker, mapping on its keyframes, loop closures through
``SemanticMapper.update_map``), and the CLI (``run_eval.main --run
--segment --eval``) on the ``configs/ovo.yaml`` chain, whose backbone is
orbslam.

Tolerances: keyframes, ``update_map`` calls, the map's ``count``,
``point_ids`` and ``obj_ids``, the active ids and the ``spf`` list's length
equal; points within 1e-5 abs (the rebuild's rigid transform: XLA fuses
its multiply-adds); descriptors within cosine 1e-4 (culled views
subtracted from sums added in another order). The CLI: labels equal where
an instance's top-2 margin is above 1e-4, metrics equal when the labels
are, as ``tests/test_torch_cli.py``.
"""
import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

from ovo_tpu.data.masks import CallableMaskSource as JaxMasks
from ovo_tpu.data.masks import RecordedEmbedder as JaxRecorded
from ovo_tpu.mapping.pipeline import OVOSemMap as JaxOVOSemMap
from ovo_tpu.mapping.semantic import SemanticMapper as JaxSemanticMapper

from ovo_tpu_torch import run_eval as port_cli
from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
from ovo_tpu_torch.eval.transfer import match_labels_to_vtx
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.mapping.semantic import SemanticMapper
from ovo_tpu_torch.utils import io as tio

from orb_scene import CurvedWallDataset
from synthetic_scene import class_embeddings, mask_label_fn, synthetic_mask_fn
from test_torch_orbslam import ORB_SLAM_CFG

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]
import chip_smoke  # noqa: E402
import run_eval as jax_cli  # noqa: E402


def make_config():
    return {
        "dataset_name": "synthetic", "use_wandb": False, "debug": False,
        "slam": dict(ORB_SLAM_CFG, slam_module="orbslam",
                     save_estimated_cam=True),
        "mapping": {"map_every": 2, "k_pooling": 1, "downscale_res": 1,
                    "n_points_capacity": 1 << 16},
        "tracking": {"track_every": 1},
        "data": {"scene_name": "orbwall"},
        "cam": {},
        "semantic": {
            "segment_every": 2, "match_distance_th": 0.05, "track_th": 40,
            "depth_filter": False, "log": False, "kf_queue_delay": 2,
            "capacity": {"n_instances": 64, "n_masks": 16},
            "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                     "clip_dim": 16},
        },
    }


class CountingUpdates:
    """Counts ``update_map`` calls on a mapper, passing them through."""

    def __init__(self, ovo):
        self.calls = 0
        inner = ovo.update_map

        def update_map(*args, **kw):
            self.calls += 1
            return inner(*args, **kw)

        ovo.update_map = update_map


def test_pipeline_orbslam_matches_jax(tmp_path):
    embeds = class_embeddings(16)
    cfg = make_config()
    j = JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax",
                     mask_source=JaxMasks(synthetic_mask_fn, max_masks=16),
                     embedder=JaxRecorded(16, mask_label_fn, embeds),
                     dataset=CurvedWallDataset(40))
    t = OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch",
                  mask_source=CallableMaskSource(synthetic_mask_fn, 16,
                                                 "cpu"),
                  embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                            device="cpu"),
                  dataset=CurvedWallDataset(40), device="cpu")
    counts = CountingUpdates(j.ovo), CountingUpdates(t.ovo)
    j.run()
    t.run()
    jb, tb = j.slam_backbone, t.slam_backbone
    assert counts[1].calls == counts[0].calls >= 1
    assert tb.last_big_change == jb.last_big_change >= 1
    assert sorted(tb.kfs) == sorted(jb.kfs)
    assert [b["range"] for b in tb.kf_blocks.values()] == \
        [b["range"] for b in jb.kf_blocks.values()]
    culled = {int(round(f)) for f, _, c in tb.tracker.get_keyframes() if c}
    assert culled and not (culled & set(tb.kfs))
    js, ts = jb.get_map(), tb.get_map()
    n = int(js.count)
    assert n > 1000 and int(ts.count) == n
    np.testing.assert_allclose(ts.points[:n].numpy(),
                               np.asarray(js.points[:n]), atol=1e-5)
    for f in ("point_ids", "obj_ids", "colors"):
        np.testing.assert_array_equal(getattr(ts, f)[:n].numpy(),
                                      np.asarray(getattr(js, f)[:n]))
    np.testing.assert_array_equal(t.ovo.active_ids(), j.ovo.active_ids())
    assert len(t.ovo.active_ids()) >= 3
    assert sorted(t.ovo.kf_descriptors) == sorted(j.ovo.kf_descriptors)
    a = t.ovo.store.clip_feature.numpy()
    b = np.asarray(j.ovo.store.clip_feature)
    for i in t.ovo.active_ids():
        cos = a[i] @ b[i] / (np.linalg.norm(a[i]) * np.linalg.norm(b[i]))
        assert abs(cos - 1.0) <= 1e-4, (i, cos)
    assert len(t.logger.stats["spf"][0]) == len(j.logger.stats["spf"][0])


def _patch_weights(mp):
    from test_torch_cli import _patch_weights as patch

    patch(mp)


@pytest.fixture(scope="module")
def orb_cli_runs(tmp_path_factory):
    """The JAX and the port's CLI, each --run --segment --eval on the
    out-and-back PNG scene, on a copied config tree whose scene file keeps
    configs/ovo.yaml's backbone (orbslam)."""
    tmp = tmp_path_factory.mktemp("orbcli")
    scene = "orbwall"
    chip_smoke.reference_orb_scene(tmp, scene)
    root = chip_smoke.cli_config_root(tmp, scene, chip_smoke.REFERENCE_ORB)
    argv = ["--dataset_name", "Replica", "--scenes", scene, "--run",
            "--segment", "--eval", "--experiment_name"]
    metrics, updates = {}, {"jax": 0, "port": 0}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp)
        mp.setenv("DISABLE_WANDB", "true")
        _patch_weights(mp)
        for cls, key in ((JaxSemanticMapper, "jax"), (SemanticMapper,
                                                      "port")):
            def counted(self, *a, _inner=cls.update_map, _key=key, **kw):
                updates[_key] += 1
                return _inner(self, *a, **kw)

            mp.setattr(cls, "update_map", counted)
        mp.setattr(jax_cli, "CONFIG_ROOT", root)
        ns = port_cli.parse_args(argv + ["jax"])
        jax_cli.main(argparse.Namespace(**{k: v for k, v in vars(ns).items()
                                           if k != "device"}))
        metrics["port"] = port_cli.main(port_cli.parse_args(
            argv + ["port", "--device", "cpu"]), config_root=root)
        classes = yaml.safe_load(open(root / "Replica/eval_info.yaml"))[
            "class_names_reduced"]
        out = tmp / "data/output/Replica"
        ovo, _ = jax_cli.load_representation(out / "jax" / scene)
        sims = ovo.query(classes, ["This is a photo of a {}"])
    top2 = np.sort(sims, axis=1)
    margins = dict(zip(ovo.active_ids().tolist(),
                       (top2[:, -1] - top2[:, -2]).tolist()))
    return tmp, out, scene, dict(metrics, updates=updates), margins


def test_cli_orbslam_run_matches_jax(orb_cli_runs):
    tmp, out, scene, metrics, _ = orb_cli_runs
    # the run closed loops: the semantic map followed each big change
    assert metrics["updates"]["port"] == metrics["updates"]["jax"] >= 1
    jcfg = yaml.safe_load(open(out / "jax" / scene / "config.yaml"))
    tcfg = yaml.safe_load(open(out / "port" / scene / "config.yaml"))
    assert jcfg == tcfg and tcfg["slam"]["slam_module"] == "orbslam"
    j = tio.load_ckpt(out / "jax" / scene / "ovo_map.ckpt")
    t = tio.load_ckpt(out / "port" / scene / "ovo_map.ckpt")
    jm, tm = j["map_params"], t["map_params"]
    assert len(np.asarray(jm["xyz"])) > 1000
    for key in ("obj_ids", "ids", "color"):
        np.testing.assert_array_equal(np.asarray(tm[key]),
                                      np.asarray(jm[key]))
    np.testing.assert_allclose(np.asarray(tm["xyz"]), np.asarray(jm["xyz"]),
                               atol=1e-5)
    jo, to = j["ovo_map_params"], t["ovo_map_params"]
    assert sorted(to) == sorted(jo)
    ids = np.asarray(jo["ins_3d_ids"])
    np.testing.assert_array_equal(np.asarray(to["ins_3d_ids"]), ids)
    n = 0
    for i in ids:
        a, b = to[f"ins3d_{i}_clip_feature"], jo[f"ins3d_{i}_clip_feature"]
        assert (a is None) == (b is None)
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
            assert abs(cos - 1.0) <= 1e-4, (i, cos)
            n += 1
    assert n >= 1
    # the tracker's poses, saved by both
    jc = np.load(out / "jax" / scene / "estimated_c2w.npy",
                 allow_pickle=True).item()
    tc = np.load(out / "port" / scene / "estimated_c2w.npy",
                 allow_pickle=True).item()
    assert sorted(jc) == sorted(tc) and len(tc) == 23
    for k in jc:
        np.testing.assert_array_equal(tc[k], jc[k])


def test_cli_orbslam_segment_eval_match_jax(orb_cli_runs):
    tmp, out, scene, metrics, margins = orb_cli_runs
    ckpt = tio.load_ckpt(out / "jax" / scene / "ovo_map.ckpt")["map_params"]
    _, pcd_gt = tio.load_scene_data("Replica", scene,
                                    str(tmp / "data/input/Datasets"),
                                    {"ignore": []})
    mesh_ins, _, _ = match_labels_to_vtx(
        np.asarray(ckpt["obj_ids"]).reshape(-1), np.asarray(ckpt["xyz"]),
        pcd_gt)
    la = tio.read_labels(out / "jax" / "replica" / f"{scene}.txt")
    lb = tio.read_labels(out / "port" / "replica" / f"{scene}.txt")
    assert la.shape == lb.shape and len(la) > 100
    clear = np.array([margins.get(int(i), 0.0) > 1e-4 for i in mesh_ins])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(la[clear], lb[clear])
    if (la == lb).all():
        assert (out / "port/replica/statistics.txt").read_text() == \
            (out / "jax/replica/statistics.txt").read_text()
    assert np.isfinite(metrics["port"]["iou"])
