"""The orchestrator's remaining paths in the PyTorch port against the JAX
package, on the CPU: SAM micro-batching (``sam.batch: 2``), ``restore_map``,
``restore_dict(debug_info=True)`` and the ``profile_trace`` hook.

  - ``sam.batch: 2`` on recorded synthetic masks with TextRegion on tiny-pe
    (the batched tower), and on live hiera_test SAM2 masks: the point map,
    instance ids and store counts bit-equal to the JAX pipeline at
    ``sam.batch: 2``, descriptors within cosine 1 +- 1e-6;
  - ``restore_map``: a run stopped halfway by each package, resumed by the
    port from either checkpoint, equals the JAX package's resumed run;
  - ``restore_dict(debug_info=True)`` both ways on the layout of
    ``tests/test_ckpt_interop.py``: capture, restore, capture again is equal
    across the packages;
  - ``profile_trace`` writes a Chrome trace of the step window, with the
    program's spans and counters on a track of their own.
"""
import copy
import json
import shutil

import jax
import numpy as np
import pytest

from ovo_tpu.data.masks import CallableMaskSource as JaxMasks
from ovo_tpu.data.masks import RecordedEmbedder as JaxRecorded
from ovo_tpu.mapping.pipeline import OVOSemMap as JaxOVOSemMap
from ovo_tpu.mapping.semantic import SemanticMapper as JaxSemanticMapper
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.models.sam.amg import AutomaticMaskSource as JaxAMG
from ovo_tpu.models.sam.model import SAMConfig as JaxSAMConfig
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.models.textregion import TextRegionEmbedder as JaxTextRegion
from ovo_tpu.utils import io as jax_io

from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.mapping.semantic import SemanticMapper
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.sam.amg import AutomaticMaskSource
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.models.textregion import TextRegionEmbedder
from ovo_tpu_torch.utils import io as io_utils

from synthetic_scene import (SyntheticWallDataset, class_embeddings,
                             mask_label_fn, synthetic_mask_fn)
from test_torch_pipeline_e2e import make_config
from test_torch_sam_pipeline import AMG

N_FRAMES = 12


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class Head:
    """The first ``n`` frames of a dataset (its poses unchanged)."""

    def __init__(self, ds, n):
        self.ds, self.n = ds, n
        for k in ("intrinsics", "height", "width", "crop_edge",
                  "dataset_config"):
            setattr(self, k, getattr(ds, k))

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.ds[i]


def assert_same_run(j, t, min_instances=1, cos_tol=1e-6):
    jm, tm = j.slam_backbone.get_map(), t.slam_backbone.get_map()
    n = int(jm.count)
    assert n > 1000 and int(tm.count) == n
    np.testing.assert_array_equal(tm.obj_ids[:n].numpy(),
                                  np.asarray(jm.obj_ids[:n]))
    np.testing.assert_array_equal(tm.point_ids[:n].numpy(),
                                  np.asarray(jm.point_ids[:n]))
    np.testing.assert_array_equal(t.ovo.active_ids(), j.ovo.active_ids())
    assert len(t.ovo.active_ids()) >= min_instances
    assert t.ovo.kf_id == j.ovo.kf_id
    np.testing.assert_array_equal(t.ovo.store.desc_cnt.numpy(),
                                  np.asarray(j.ovo.store.desc_cnt))
    has = t.ovo.store.has_clip.numpy()
    np.testing.assert_array_equal(has, np.asarray(j.ovo.store.has_clip))
    a = t.ovo.store.clip_feature.numpy()[has].astype(np.float64)
    b = np.asarray(j.ovo.store.clip_feature)[has].astype(np.float64)
    assert len(a) >= 1
    cos = (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                             * np.linalg.norm(b, axis=-1))
    np.testing.assert_allclose(cos, 1.0, atol=cos_tol)


# ---------------------------------------------------------------------------
# sam.batch > 1
# ---------------------------------------------------------------------------

def _batch_config(clip_dim):
    cfg = make_config(clip_dim)
    cfg["semantic"].setdefault("sam", {})["batch"] = 2
    return cfg


def test_sam_batch_on_recorded_masks_matches_jax(tmp_path):
    """Synthetic masks through the loop fallback, TextRegion on tiny-pe
    through ``embed_masks_batch`` (one tower call over 2 x (1 + crops)
    views); the frame loop segments every second keyframe's pair."""
    jm = JaxCLIP.random_init("tiny-pe")
    tm = CLIPModel.from_jax_params("tiny-pe", np_tree(jm.params),
                                   device="cpu")
    cfg = _batch_config(32)
    j = JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax",
                     mask_source=JaxMasks(synthetic_mask_fn, max_masks=16),
                     embedder=JaxTextRegion(jm),
                     dataset=SyntheticWallDataset(n_frames=N_FRAMES))
    j.run()
    emb = TextRegionEmbedder(tm)
    batched = []
    orig = emb.embed_masks_batch
    emb.embed_masks_batch = lambda *a: batched.append(1) or orig(*a)
    t = OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch",
                  mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
                  embedder=emb, dataset=SyntheticWallDataset(
                      n_frames=N_FRAMES), device="cpu")
    assert t.ovo.sam_batch == j.ovo.sam_batch == 2
    t.run()
    assert_same_run(j, t, min_instances=4)
    assert len(batched) >= 2 and not t.ovo._pending


def test_sam_batch_on_live_sam_masks_matches_jax(tmp_path):
    """hiera_test SAM2 masks (f32, gates at 0): the trunk runs once over
    each pair of keyframes, then each keyframe decodes."""
    js = JaxSAM.random_init("hiera_test", image_size=128, seed=4)
    js = JaxSAM(JaxSAMConfig("hiera_test", 128, compute_dtype="float32"),
                js.params)
    ts = SAMModel.from_jax_params("hiera_test", 128, np_tree(js.params),
                                  device="cpu", compute_dtype="float32")
    jc = JaxCLIP.random_init("tiny-pe")
    tc = CLIPModel.from_jax_params("tiny-pe", np_tree(jc.params),
                                   device="cpu")
    cfg = _batch_config(32)
    cfg["semantic"]["sam"]["precomputed"] = False
    j = JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax",
                     mask_source=JaxAMG(js, **AMG),
                     embedder=JaxTextRegion(jc),
                     dataset=SyntheticWallDataset(n_frames=N_FRAMES))
    j.run()
    src = AutomaticMaskSource(ts, **AMG)
    calls = []
    orig = src.get_masks_batch
    src.get_masks_batch = lambda imgs, fids: calls.append(len(imgs)) or orig(
        imgs, fids)
    t = OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch", mask_source=src,
                  embedder=TextRegionEmbedder(tc),
                  dataset=SyntheticWallDataset(n_frames=N_FRAMES),
                  device="cpu")
    t.run()
    assert_same_run(j, t)
    assert calls == [2, 2, 2]


def test_batched_amg_equals_per_image():
    """get_masks_batch on two images gives each image's get_masks."""
    ts = SAMModel.random_init("hiera_test", 128, seed=2, device="cpu",
                              compute_dtype="float32")
    src = AutomaticMaskSource(ts, **AMG)
    rng = np.random.default_rng(3)
    imgs = (rng.random((2, 60, 80, 3)) * 255).astype(np.uint8)
    seg_b, bmaps_b, valid_b = src.get_masks_batch(imgs, [0, 1])
    for i in range(2):
        seg, bmaps, valid = src.get_masks(imgs[i], i)
        np.testing.assert_array_equal(valid_b[i].numpy(), valid.numpy())
        assert (seg_b[i] != seg).float().mean() < 1e-3
        assert (bmaps_b[i] != bmaps).float().mean() < 1e-3


# ---------------------------------------------------------------------------
# restore_map
# ---------------------------------------------------------------------------

def _recorded_kw(pkg):
    embeds = class_embeddings(16)
    if pkg == "jax":
        return dict(mask_source=JaxMasks(synthetic_mask_fn, max_masks=16),
                    embedder=JaxRecorded(16, mask_label_fn, embeds))
    return dict(mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
                embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                          device="cpu"), device="cpu")


def test_restore_map_resumes_either_checkpoint(tmp_path):
    """Both packages map the first half of the scene and save; the JAX
    package resumes its own run, the port resumes the JAX run's and its
    own checkpoint: all three end with the same map and instances."""
    cfg = make_config(16)
    ds = SyntheticWallDataset(n_frames=N_FRAMES)
    half = Head(ds, N_FRAMES // 2)
    JaxOVOSemMap(copy.deepcopy(cfg), tmp_path / "jax", dataset=half,
                 **_recorded_kw("jax")).run()
    OVOSemMap(copy.deepcopy(cfg), tmp_path / "torch", dataset=half,
              **_recorded_kw("torch")).run()
    shutil.copytree(tmp_path / "jax", tmp_path / "torch_from_jax")
    resumed = copy.deepcopy(cfg)
    resumed["restore_map"] = True
    j = JaxOVOSemMap(copy.deepcopy(resumed), tmp_path / "jax", dataset=ds,
                     **_recorded_kw("jax"))
    j.run()
    for out in ("torch_from_jax", "torch"):
        t = OVOSemMap(copy.deepcopy(resumed), tmp_path / out, dataset=ds,
                      **_recorded_kw("torch"))
        assert t.first_frame == j.first_frame == N_FRAMES // 2
        t.run()
        assert_same_run(j, t, min_instances=4)
        tc = io_utils.load_ckpt(tmp_path / out / "ovo_map.ckpt")
        jc = jax_io.load_ckpt(tmp_path / "jax" / "ovo_map.ckpt")
        np.testing.assert_array_equal(tc["map_params"]["obj_ids"],
                                      jc["map_params"]["obj_ids"])


def test_restore_map_needs_a_checkpoint(tmp_path):
    cfg = make_config(16)
    cfg["restore_map"] = True
    with pytest.raises(FileNotFoundError):
        OVOSemMap(copy.deepcopy(cfg), tmp_path / "empty",
                  dataset=SyntheticWallDataset(n_frames=2),
                  **_recorded_kw("torch"))


# ---------------------------------------------------------------------------
# restore_dict(debug_info=True)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def debug_ckpts(tmp_path_factory):
    """The debug layout of tests/test_ckpt_interop.py (debug and debug_info
    on, recorded embeddings) written by each package."""
    out = {}
    for pkg, cls in (("jax", JaxOVOSemMap), ("torch", OVOSemMap)):
        cfg = make_config(16)
        cfg["debug"] = cfg["debug_info"] = True
        path = tmp_path_factory.mktemp(f"debug_{pkg}")
        cls(cfg, path, dataset=SyntheticWallDataset(n_frames=N_FRAMES),
            **_recorded_kw(pkg)).run()
        out[pkg] = jax_io.load_ckpt(path / "ovo_map.ckpt")
    return out


def _equal_dicts(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if a[k] is None:
            assert b[k] is None, k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_debug_restore_roundtrips_across_packages(debug_ckpts, writer):
    """Either package's debug checkpoint, restored by each package and
    captured again: the two captures are equal key for key, and so are the
    restored mappers' records and streaming fusion state."""
    ckpt = debug_ckpts[writer]
    d, map_params = ckpt["ovo_map_params"], ckpt["map_params"]
    sem = make_config(16)["semantic"]
    jo = JaxSemanticMapper(copy.deepcopy(sem), eval=True)
    jo.restore_dict(d, debug_info=True)
    to = SemanticMapper(copy.deepcopy(sem), eval=True, device="cpu")
    to.restore_dict(d, debug_info=True)
    jd = jo.capture_dict(debug_info=True, map_dict=map_params)
    td = to.capture_dict(debug_info=True, map_dict=map_params)
    _equal_dicts(jd, td)
    _equal_dicts(d, td)
    assert to.frame_ids == jo.frame_ids and to.kf_id == jo.kf_id > 0
    assert sorted(to.kf_records) == sorted(jo.kf_records)
    for kf, (ids, areas) in jo.kf_records.items():
        np.testing.assert_array_equal(to.kf_records[kf][0], ids)
        np.testing.assert_array_equal(to.kf_records[kf][1], areas)
    for name in ("desc_sum", "desc_cnt", "n_points", "next_id", "active",
                 "top_area", "top_kf"):
        np.testing.assert_array_equal(getattr(to.store, name).numpy(),
                                      np.asarray(getattr(jo.store, name)),
                                      err_msg=name)


def test_debug_restore_bounded_heaps_and_orphans():
    """A bounded top-k (k_top_views 2) keeps each instance's two largest
    (area, kf) pairs in ascending order; an instance with a feature but no
    per-kf clips counts it as one view. The JAX package's restore cannot run
    this case (``ovo_tpu/mapping/semantic.py:794`` writes into the read-only
    numpy view of a JAX array and raises), so the port is held to the
    reference's code as written there, and its capture to the layout."""
    rng = np.random.default_rng(11)
    D = 16
    scene = {"ins_3d_ids": np.array([0, 2]), "frame_id": np.array([0, 2, 4]),
             "ins_map": rng.integers(-1, 3, (3, 6, 5)).astype(np.int32)}
    for i in (0, 2):
        scene[f"ins3d_{i}_clip_feature"] = rng.normal(size=D).astype(
            np.float32)
        scene[f"ins3d_{i}_keyframes_ids"] = np.array([0, 1, 2])
        scene[f"ins3d_{i}_points_ids"] = np.arange(3 + i)
        scene[f"ins3d_{i}_top_kfs"] = np.array([[30, 0], [10, 1], [20, 2]])
    clip = rng.normal(size=D).astype(np.float32)
    scene["kf_1_ins3d_0_clips"] = clip
    sem = make_config(16)["semantic"]
    sem["clip"]["k_top_views"] = 2
    to = SemanticMapper(copy.deepcopy(sem), eval=True, device="cpu")
    to.restore_dict(copy.deepcopy(scene), debug_info=True)
    st = to.store
    for i in (0, 2):
        np.testing.assert_array_equal(st.top_area.numpy()[i], [20, 30])
        np.testing.assert_array_equal(st.top_kf.numpy()[i], [2, 0])
    np.testing.assert_array_equal(st.n_points.numpy()[[0, 2]], [3, 5])
    np.testing.assert_array_equal(st.desc_cnt.numpy()[[0, 2]], [1, 1])
    np.testing.assert_array_equal(st.desc_sum.numpy()[0], clip)
    np.testing.assert_array_equal(st.desc_sum.numpy()[2],     # the orphan
                                  scene["ins3d_2_clip_feature"])
    d = to.capture_dict(debug_info=True)
    np.testing.assert_array_equal(d["ins3d_0_top_kfs"], [[20, 2], [30, 0]])
    np.testing.assert_array_equal(d["kf_1_ins3d_0_clips"], clip)
    np.testing.assert_array_equal(d["ins_map"], scene["ins_map"])


# ---------------------------------------------------------------------------
# profile_trace
# ---------------------------------------------------------------------------

def test_profile_trace_writes_a_chrome_trace(tmp_path):
    # maps every frame: the segment frames insert fused with the
    # association, the others through the backbone's own map insert
    cfg = make_config(16, map_every=1)
    cfg["profile_trace"] = str(tmp_path / "trace")
    cfg["profile_trace_steps"] = 2
    m = OVOSemMap(cfg, tmp_path / "out",
                  dataset=SyntheticWallDataset(n_frames=N_FRAMES),
                  **_recorded_kw("torch"))
    m.run()
    assert m._trace_state == -1
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    # the program's spans and counters of the window on their own track
    assert any(e.get("ph") == "M" and e.get("name") == "process_name"
               and e["args"]["name"] == "ovo_tpu_torch" for e in events)
    spans = {e["name"] for e in events
             if e.get("pid") == "ovo_tpu_torch" and e.get("ph") == "X"}
    assert {"step", "mask_source", "association", "embedder",
            "map_insert"} <= spans
    assert any(n.startswith("wait.") for n in spans)
    assert any(e.get("pid") == "ovo_tpu_torch" and e.get("ph") == "C"
               and e["name"] == "keyframes" for e in events)
