"""The online pipeline end to end through both packages on the synthetic
wall scene: ``ovo_tpu``'s OVOSemMap and ``ovo_tpu_torch``'s on the same
frames and masks.

Run 1 embeds with TextRegion on the ``tiny-pe`` card, the JAX random weights
carried into the port: the point map's ``obj_ids``, the instance ids and the
checkpoint keys must be equal, descriptors within cosine 1 +- 1e-5, and
``ovo_tpu``'s ``load_ckpt`` must read the port's checkpoint. Run 2 uses a
RecordedEmbedder (no tower) and maps on every frame, so association drift
shows apart from tower drift: there descriptors must agree to 1e-6.
"""
import copy

import jax
import numpy as np
import pytest

from ovo_tpu.data.masks import CallableMaskSource as JaxMasks
from ovo_tpu.data.masks import RecordedEmbedder as JaxRecorded
from ovo_tpu.mapping.pipeline import OVOSemMap as JaxOVOSemMap
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.models.textregion import TextRegionEmbedder as JaxTextRegion
from ovo_tpu.utils import io as jax_io

from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.textregion import TextRegionEmbedder

from synthetic_scene import (SyntheticWallDataset, class_embeddings,
                             mask_label_fn, synthetic_mask_fn)


def make_config(clip_dim, map_every=2):
    return {
        "dataset_name": "synthetic", "use_wandb": False, "debug": False,
        "slam": {"slam_module": "vanilla", "save_estimated_cam": True},
        "mapping": {"map_every": map_every, "k_pooling": 1,
                    "downscale_res": 1, "n_points_capacity": 1 << 17},
        "tracking": {"track_every": 1},
        "data": {"scene_name": "wall0"},
        "cam": {},
        "semantic": {
            "segment_every": 2, "match_distance_th": 0.05, "track_th": 40,
            "depth_filter": False, "log": False, "kf_queue_delay": 2,
            "capacity": {"n_instances": 64, "n_masks": 16},
            "clip": {"k_top_views": 10000, "fusion": "avg_pooling",
                     "clip_dim": clip_dim},
        },
    }


def run_both(tmp_path, jax_embedder, torch_embedder, cfg):
    j = JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax",
                     mask_source=JaxMasks(synthetic_mask_fn, max_masks=16),
                     embedder=jax_embedder,
                     dataset=SyntheticWallDataset(n_frames=12))
    j.run()
    t = OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch",
                  mask_source=CallableMaskSource(synthetic_mask_fn,
                                                 max_masks=16, device="cpu"),
                  embedder=torch_embedder,
                  dataset=SyntheticWallDataset(n_frames=12), device="cpu")
    t.run()
    return j, t


def assert_same_map_and_instances(j, t):
    js, ts = j.slam_backbone.get_map(), t.slam_backbone.get_map()
    n = int(js.count)
    assert n > 1000 and int(ts.count) == n
    np.testing.assert_array_equal(ts.obj_ids[:n].numpy(),
                                  np.asarray(js.obj_ids[:n]))
    np.testing.assert_array_equal(ts.point_ids[:n].numpy(),
                                  np.asarray(js.point_ids[:n]))
    np.testing.assert_allclose(ts.points[:n].numpy(),
                               np.asarray(js.points[:n]), atol=1e-6)
    np.testing.assert_array_equal(t.ovo.active_ids(), j.ovo.active_ids())
    assert len(t.ovo.active_ids()) >= 4
    np.testing.assert_array_equal(t.ovo.store.desc_cnt.numpy(),
                                  np.asarray(j.ovo.store.desc_cnt))


def assert_checkpoints(tmp_path, cos_tol):
    jc = jax_io.load_ckpt(tmp_path / "jax" / "ovo_map.ckpt")
    tc = jax_io.load_ckpt(tmp_path / "torch" / "ovo_map.ckpt")
    assert set(tc) == set(jc) == {"map_params", "ovo_map_params"}
    for part in tc:
        assert set(tc[part]) == set(jc[part]), part
    for k in ("xyz", "obj_ids", "ids", "color"):
        assert tc["map_params"][k].dtype == jc["map_params"][k].dtype, k
        np.testing.assert_allclose(tc["map_params"][k], jc["map_params"][k],
                                   atol=1e-6)
    jo, to = jc["ovo_map_params"], tc["ovo_map_params"]
    np.testing.assert_array_equal(to["ins_3d_ids"], jo["ins_3d_ids"])
    for i in jo["ins_3d_ids"]:
        a, b = to[f"ins3d_{i}_clip_feature"], jo[f"ins3d_{i}_clip_feature"]
        assert (a is None) == (b is None)
        if a is not None:
            cos = float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))
            assert abs(cos - 1.0) <= cos_tol, (i, cos)


def test_pipeline_textregion_tiny_pe_matches_jax(tmp_path):
    jm = JaxCLIP.random_init("tiny-pe")
    tm = CLIPModel.from_jax_params(
        "tiny-pe", jax.tree_util.tree_map(np.asarray, jm.params),
        device="cpu")
    j, t = run_both(tmp_path, JaxTextRegion(jm), TextRegionEmbedder(tm),
                    make_config(32))
    assert_same_map_and_instances(j, t)
    assert_checkpoints(tmp_path, cos_tol=1e-5)
    assert (tmp_path / "torch" / "config.yaml").exists()
    assert (tmp_path / "torch" / "logger" / "avg_fps.log").exists()


def test_pipeline_recorded_descriptors_match_jax(tmp_path):
    embeds = class_embeddings(16)
    j, t = run_both(
        tmp_path, JaxRecorded(16, mask_label_fn, embeds),
        RecordedEmbedder(16, mask_label_fn, embeds, device="cpu"),
        make_config(16, map_every=1))
    assert_same_map_and_instances(j, t)
    np.testing.assert_allclose(t.ovo.store.clip_feature.numpy(),
                               np.asarray(j.ovo.store.clip_feature),
                               atol=1e-6)
    assert_checkpoints(tmp_path, cos_tol=1e-6)


def test_pipeline_rejects_unported_options(tmp_path):
    """The viewer stream and the multi-device keys still raise; the
    ORB-SLAM backbone (tests/test_torch_orbslam.py), the Gaussian-SLAM
    backbone (tests/test_torch_gaussian_pipeline.py), the profiler hook,
    map restore, SAM micro-batching and the debug restore are ported
    (tests/test_torch_orchestrator.py) and construct; the ORB backbone runs
    two frames."""
    cfg = make_config(16)
    embeds = class_embeddings(16)
    kw = dict(mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
              embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                        device="cpu"),
              dataset=SyntheticWallDataset(n_frames=2), device="cpu")
    bad = copy.deepcopy(cfg)
    bad["vis"] = {"stream": True}
    with pytest.raises(NotImplementedError):
        OVOSemMap(bad, tmp_path / "vis", **kw)
    orb = copy.deepcopy(cfg)
    orb["slam"]["slam_module"] = "orbslam"
    pipe = OVOSemMap(orb, tmp_path / "orb", **dict(
        kw, dataset=SyntheticWallDataset(n_frames=2, textured=True)))
    pipe.run()
    assert sorted(pipe.slam_backbone.estimated_c2ws) == [0, 1]
    assert int(pipe.slam_backbone.get_map().count) > 1000
    for key in ("point_shard", "shard_query", "dp_embed"):
        bad = copy.deepcopy(cfg)
        bad["semantic"]["parallel"] = {key: True}
        with pytest.raises(NotImplementedError):
            OVOSemMap(bad, tmp_path / key, **kw)
    ok = copy.deepcopy(cfg)
    ok["profile_trace"] = str(tmp_path / "trace")
    ok["semantic"].setdefault("sam", {})["batch"] = 2
    ok["debug"] = ok["debug_info"] = True
    pipe = OVOSemMap(ok, tmp_path / "ported", **kw)
    assert pipe.ovo.debug_info and pipe.ovo.sam_batch == 2
    pipe.run()
    restored = copy.deepcopy(ok)
    restored["restore_map"] = True
    again = OVOSemMap(restored, tmp_path / "ported", **kw)
    assert again.first_frame == 2 and again.ovo.kf_id == pipe.ovo.kf_id


def test_precomputed_masks_through_factory_match_live(tmp_path):
    """Config 1 of the reference, precomputed masks: ``sam.precompute``
    segments every segment-cadence frame once, writes the reference's npy
    layout, and the run reads them back through PrecomputedMaskSource --
    the same map and instances as feeding the masks live. The saved files
    read the same through ``ovo_tpu``'s PrecomputedMaskSource, and the
    written config.yaml loads with a YAML reader."""
    import yaml

    from ovo_tpu.data.masks import PrecomputedMaskSource as JaxPrecomputed
    from ovo_tpu_torch.data.masks import PrecomputedMaskSource
    from ovo_tpu_torch.factory import build_mask_source

    embeds = class_embeddings(16)

    def run(cfg, out):
        m = OVOSemMap(cfg, out, dataset=SyntheticWallDataset(n_frames=12),
                      mask_source=CallableMaskSource(synthetic_mask_fn, 16,
                                                     "cpu"),
                      embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                                device="cpu"),
                      device="cpu")
        m.run()
        return m

    live = run(make_config(16), tmp_path / "live")
    cfg = make_config(16)
    cfg["semantic"]["sam"] = {"precompute": True,
                              "masks_base_path": str(tmp_path / "masks")}
    pre = run(copy.deepcopy(cfg), tmp_path / "pre")
    assert isinstance(pre.ovo.mask_source, PrecomputedMaskSource)
    a, b = live.slam_backbone.get_map(), pre.slam_backbone.get_map()
    n = int(a.count)
    assert int(b.count) == n
    np.testing.assert_array_equal(a.obj_ids[:n].numpy(), b.obj_ids[:n].numpy())
    np.testing.assert_array_equal(live.ovo.active_ids(), pre.ovo.active_ids())

    cfg["semantic"]["sam"]["precomputed"] = True
    src = build_mask_source(cfg["semantic"], "wall0", device="cpu")
    ref = JaxPrecomputed(str(tmp_path / "masks" / "wall0"), max_masks=16)
    for fid in (0, 4, 10, 3):
        ours, theirs = src.get_masks(None, fid), ref.get_masks(None, fid)
        if theirs[0] is None:
            assert ours[0] is None and fid % 2
            continue
        for x, y in zip(ours, theirs):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))

    with open(tmp_path / "pre" / "config.yaml") as f:
        loaded = yaml.safe_load(f)
    assert loaded["semantic"]["sam"]["precompute"] is True
    assert loaded["mapping"] == make_config(16)["mapping"]


def test_factory_builds_textregion_and_rejects_unported(tmp_path):
    from ovo_tpu_torch.factory import build_embedder, build_mask_source
    from ovo_tpu_torch.models.textregion import TextRegionEmbedder as TR

    emb = build_embedder({"clip": {"embed_type": "TextRegion",
                                   "model_card": "tiny-pe"}}, device="cpu")
    assert isinstance(emb, TR) and emb.clip_dim == 32
    from ovo_tpu_torch.models.clip import CropCLIPEmbedder

    crop = build_embedder({"clip": {"embed_type": "vanilla",
                                    "model_card": "tiny-test"}}, device="cpu")
    assert isinstance(crop, CropCLIPEmbedder) and crop.clip_dim == 32
    # a present checkpoint is loaded (tests/test_torch_checkpoints.py); an
    # empty one is refused by torch.load, as the reference refuses it
    from ovo_tpu.models.clip import build_clip_embedder as jax_build

    ckpt = tmp_path / "open_clip_model.safetensors"
    ckpt.write_bytes(b"")
    clip_cfg = {"embed_type": "vanilla", "model_card": "tiny-test",
                "ckpt_path": str(ckpt)}
    with pytest.raises(Exception) as ours:
        build_embedder({"clip": clip_cfg}, device="cpu")
    with pytest.raises(Exception) as ref:
        jax_build(clip_cfg, "vanilla")
    assert type(ours.value) is type(ref.value)
    from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource

    live = build_mask_source({"sam": {"precomputed": False,
                                      "sam_encoder": "hiera_test",
                                      "image_size": 128},
                              "capacity": {"n_masks": 16}}, "s", device="cpu")
    assert isinstance(live, AutomaticMaskSource) and live.max_masks == 16
    assert live.stability_thresh == 0.95 and live.min_area == 0
    sam1 = build_mask_source({"sam": {"precomputed": False,   # SAM1
                                      "sam_encoder": "vit_test",
                                      "sam_version": "", "image_size": 256},
                              "capacity": {"n_masks": 16}}, "s", device="cpu")
    assert sam1.model.cfg.family == "sam1" and sam1.max_masks == 16
    assert sam1.stability_thresh == 0.85 and sam1.min_area == 100


def test_log_mode_records_stats_and_matches_hot_path(tmp_path):
    """``semantic.log`` swaps the async mirrors for exact host reads and
    logs the reference's per-keyframe stats; the map and instances are the
    same as on the sync-free hot path."""
    embeds = class_embeddings(16)

    def run(log, out):
        cfg = make_config(16)
        cfg["semantic"]["log"] = log
        m = OVOSemMap(cfg, out, dataset=SyntheticWallDataset(n_frames=12),
                      mask_source=CallableMaskSource(synthetic_mask_fn, 16,
                                                     "cpu"),
                      embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                                device="cpu"),
                      device="cpu")
        m.run()
        return m

    hot, logged = run(False, tmp_path / "hot"), run(True, tmp_path / "log")
    stats = logged.logger.stats
    assert len(stats["n_matches"]) == logged.ovo.kf_id == 6
    assert sum(n[0] for n in stats["n_obj"]) == int(logged.ovo.store.next_id)
    assert len(stats["t_clip"]) == 6
    a, b = hot.slam_backbone.get_map(), logged.slam_backbone.get_map()
    n = int(a.count)
    np.testing.assert_array_equal(a.obj_ids[:n].numpy(), b.obj_ids[:n].numpy())
    np.testing.assert_array_equal(hot.ovo.active_ids(), logged.ovo.active_ids())
