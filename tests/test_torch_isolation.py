"""The PyTorch port stands alone: no ``jax`` and no ``ovo_tpu`` import
anywhere in ``ovo_tpu_torch/`` (the SAM2 modules, the text side, the crop
embedders, the kernel wrappers and the CLI included) or ``chip_smoke.py``,
and no module-level ``yaml`` or ``cv2`` import; it imports and runs -- the
pipeline with a text query, the crop embedders, the live SAM2 mask source
and the CLI's ``--run --segment --eval`` on a PNG scene -- with jax, yaml
and cv2 blocked; its entry points refuse to fall back to the CPU on their
own. The subprocess also builds a SAM1 mask source and loads a SAM1, an
open_clip and a merger checkpoint, and drives the ORB backbone (the native
tracker built from the port's own copy, loop closures through
``update_map``), builds the Gaussian-SLAM backbone and renders through its
splatter with a gradient. No string in the port's code names a path into the JAX
package. The last modules (the merger's train step, ``parallel/``, ``viz/``,
``visualize_scene``) import none of jax, matplotlib, yaml or ``ovo_tpu``, and
run with the four blocked: the train step, a point-sharded, data-parallel,
instance-sharded pipeline in a world of one, the viewer stream with a query
and ``visualize_scene``'s headless exports."""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "ovo_tpu")


def _sources():
    files = sorted((ROOT / "ovo_tpu_torch").rglob("*.py"))
    smoke = ROOT / "chip_smoke.py"
    return files + ([smoke] if smoke.exists() else [])


def _imported_modules(path, top_level_only=False):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in (tree.body if top_level_only else ast.walk(tree)):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_jax_or_reference_package_imports():
    files = _sources()
    assert len(files) > 20
    names = {str(p.relative_to(ROOT)) for p in files}
    assert {f"ovo_tpu_torch/models/sam/{m}.py" for m in (
        "hiera", "neck", "prompt", "decoder", "model", "amg")} <= names
    assert {"ovo_tpu_torch/ops/attention.py", "ovo_tpu_torch/ops/masks.py",
            "ovo_tpu_torch/ops/patchify.py", "ovo_tpu_torch/ops/similarity.py",
            "ovo_tpu_torch/ops/resize.py"} <= names
    assert {f"ovo_tpu_torch/models/{m}.py" for m in (
        "clip", "text", "tokenizers", "merger", "textregion",
        "convert_jax", "convert", "convert_sam", "sam/vitdet")} <= names
    assert {"ovo_tpu_torch/run_eval.py", "ovo_tpu_torch/config.py",
            "ovo_tpu_torch/ops/fused_block.py",
            "ovo_tpu_torch/utils/yaml_subset.py",
            "ovo_tpu_torch/data/images.py", "ovo_tpu_torch/data/datasets.py",
            "ovo_tpu_torch/eval/semantics.py",
            "ovo_tpu_torch/eval/transfer.py",
            "ovo_tpu_torch/ops/layer_norm.py", "ovo_tpu_torch/ops/mask_tail.py",
            "ovo_tpu_torch/ops/decoder_route.py",
            "ovo_tpu_torch/mapping/pipeline.py",
            "ovo_tpu_torch/mapping/semantic.py",
            "ovo_tpu_torch/mapping/loop_closure.py",
            "ovo_tpu_torch/slam/orbslam.py"} <= names
    bad = [(str(p.relative_to(ROOT)), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad
    # the card's machine has neither: they may only be imported where used
    lazy = [(str(p.relative_to(ROOT)), m) for p in files
            for m in _imported_modules(p, top_level_only=True)
            if m.split(".")[0] in ("yaml", "cv2")]
    assert not lazy, lazy


def _code_strings(path):
    """The string constants of a module's code (docstrings left out)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(
                    body[0].value, ast.Constant):
                docs.add(id(body[0].value))
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and id(node) not in docs:
            yield node.lineno, node.value


def test_no_path_into_the_reference_package():
    """The port loads nothing from the JAX package's tree (its tracker
    directory included): no string of its code names an ``ovo_tpu`` path
    component."""
    pat = re.compile(r"(^|[/\\])ovo_tpu([/\\]|$)")
    files = sorted((ROOT / "ovo_tpu_torch").rglob("*.py"))
    bad = [(str(p.relative_to(ROOT)), line, s) for p in files
           for line, s in _code_strings(p) if pat.search(s)]
    assert not bad, bad
    assert pat.search("ovo_tpu/native/tracker") and pat.search("ovo_tpu")
    assert not pat.search("ovo_tpu_torch/native/tracker")


_BLOCKED_RUN = r"""
import sys
import importlib.abc
class _Block(importlib.abc.MetaPathFinder):
    # an import of these fails as on a machine without them (a None entry
    # in sys.modules would also fool libraries that probe sys.modules)
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "yaml", "cv2"):
            raise ModuleNotFoundError(f"No module named {{name!r}}")
        return None
for name in [m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "yaml", "cv2")]:
    del sys.modules[name]
sys.meta_path.insert(0, _Block())
sys.path[:0] = [{root!r}, {tests!r}]
import numpy as np
from pathlib import Path
import ovo_tpu_torch
from ovo_tpu_torch.data.masks import CallableMaskSource
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.textregion import TextRegionEmbedder
from synthetic_scene import SyntheticWallDataset, synthetic_mask_fn
cfg = {{
    "dataset_name": "synthetic", "use_wandb": False, "debug": False,
    "slam": {{"slam_module": "vanilla"}},
    "mapping": {{"map_every": 2, "k_pooling": 1, "downscale_res": 1,
                "n_points_capacity": 1 << 16}},
    "data": {{"scene_name": "wall0"}}, "cam": {{}},
    "semantic": {{"segment_every": 2, "track_th": 40, "kf_queue_delay": 1,
                 "capacity": {{"n_instances": 64, "n_masks": 16}},
                 "clip": {{"k_top_views": 10000, "fusion": "avg_pooling"}}}},
}}
emb = TextRegionEmbedder(CLIPModel.random_init("tiny-pe", device="cpu"))
m = OVOSemMap(cfg, {out!r}, dataset=SyntheticWallDataset(n_frames=6),
              mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
              embedder=emb, device="cpu")
m.run()
assert int(m.slam_backbone.get_map().count) > 1000
assert len(m.ovo.active_ids()) >= 3
# the query side: tokenizer, causal text tower, similarity
res = m.ovo.classify_instances(["wall", "chair", "table"])
assert len(res["classes"]) == len(m.ovo.active_ids())
# the crop embedders: roi crops, B10's plain route, fusion, the merger
from ovo_tpu_torch.factory import build_embedder
frame = SyntheticWallDataset(n_frames=1)[0][1]
_, maps, ok = CallableMaskSource(synthetic_mask_fn, 16, "cpu").get_masks(
    frame, 0)
for et in ("hovsg", "learned"):
    crop = build_embedder({{"clip": {{"embed_type": et, "model_card": "tiny-test",
                                   "mask_res": 48}}}}, device="cpu")
    if et == "learned":
        from ovo_tpu_torch.models.merger import init_merger
        import torch
        crop.merger.params = init_merger(torch.Generator().manual_seed(0),
                                         d_model=32, depth=1)
    d = crop.embed_masks(frame, maps, ok)
    assert d.shape == (16, 32) and bool(d.isfinite().all())
# the live SAM2 mask source (hiera_test): kernels B1-B4's plain versions
from ovo_tpu_torch.factory import build_mask_source
src = build_mask_source({{"sam": {{"precomputed": False,
                                 "sam_encoder": "hiera_test",
                                 "image_size": 128, "pred_iou_th": 0.0,
                                 "stability_score_th": 0.0,
                                 "nms_score_th": 0.0, "points_per_side": 4}},
                        "capacity": {{"n_masks": 16}}}}, device="cpu")
seg, bmaps, valid = src.get_masks(SyntheticWallDataset(n_frames=1)[0][1], 0)
assert bmaps.shape[0] == 16 and bool(valid.any())
# checkpoints: a SAM1 sam_vit_test.pth, a tiny open_clip checkpoint and a
# merger model.pt, laid out under the official keys and loaded
import tempfile
import torch
import chip_smoke
from ovo_tpu_torch.models.sam.model import SAMModel
ck = Path(tempfile.mkdtemp())
vit = SAMModel.random_init("vit_test", 256, device="cpu")
torch.save({{"model": chip_smoke.official_state_dict("sam1", vit.params)}},
           ck / "sam_vit_test.pth")
src = build_mask_source({{"sam": {{"precomputed": False,
                                 "sam_encoder": "vit_test", "sam_version": "",
                                 "sam_ckpt_path": str(ck), "pred_iou_th": 0.0,
                                 "stability_score_th": 0.0,
                                 "nms_score_th": 0.0, "points_per_side": 4}},
                        "capacity": {{"n_masks": 16}}}}, device="cpu")
assert src.model.cfg.family == "sam1" and src.min_area == 100
seg, bmaps, valid = src.get_masks(frame, 0)
assert bmaps.shape == (16,) + tuple(seg.shape)
tiny = CLIPModel.random_init("tiny-test", device="cpu")
torch.save(chip_smoke.official_state_dict("clip", {{
    **chip_smoke.flat_params(tiny.visual, "visual."),
    **chip_smoke.flat_params(tiny.text, "text.")}}), ck / "clip.bin")
crop = build_embedder({{"clip": {{"embed_type": "vanilla",
                                "model_card": "tiny-test", "mask_res": 48,
                                "ckpt_path": str(ck / "clip.bin")}}}},
                      device="cpu")
assert torch.equal(crop.model.visual.proj, tiny.visual.proj)
assert crop.embed_masks(frame, maps, ok).shape == (16, 32)
from ovo_tpu_torch.models.merger import init_merger, load_merger
torch.save(chip_smoke.official_state_dict("merger", init_merger(
    torch.Generator().manual_seed(1), d_model=32, depth=1)), ck / "model.pt")
assert len(load_merger(str(ck), device="cpu").params.blocks) == 1
# the CLI on a PNG scene (tinyroom3's config: hiera_test, tiny-test)
import os
from replica_png_scene import write_replica_scene
from ovo_tpu_torch import run_eval
os.chdir({cli!r})
write_replica_scene(Path("."), "tinyroom3", 6)
metrics = run_eval.main(run_eval.parse_args(
    "--dataset_name Replica --scenes tinyroom3 --experiment_name iso "
    "--run --segment --eval --device cpu".split()))
assert np.isfinite(metrics["iou"]) and np.isfinite(metrics["acc"])
# the ORB backbone: the native tracker, keyframe-gated mapping, loop
# closures followed by the semantic map
from ovo_tpu_torch.data.masks import RecordedEmbedder
from orb_scene import CurvedWallDataset
from synthetic_scene import class_embeddings, mask_label_fn
orb = dict(cfg, slam={{"slam_module": "orbslam", "kf_trans_th": 0.05,
                      "loop_min_kf_gap": 5, "loop_radius": 0.15,
                      "loop_rot_limit": 1.0, "loop_inlier_th": 0.3}})
orb["semantic"] = dict(cfg["semantic"], clip={{"clip_dim": 16}})
m = OVOSemMap(orb, {out!r} + "_orb", dataset=CurvedWallDataset(40),
              mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
              embedder=RecordedEmbedder(16, mask_label_fn,
                                        class_embeddings(16), device="cpu"),
              device="cpu")
m.run()
assert m.slam_backbone.last_big_change >= 1
assert int(m.slam_backbone.get_map().count) > 1000
# the Gaussian-SLAM tier: its modules import, one render and its gradient
import torch
from ovo_tpu_torch.slam import get_slam_backbone
from ovo_tpu_torch.slam.gaussian import losses, mapper, odometer, tracker
from ovo_tpu_torch.ops import knn, splat
gs = get_slam_backbone({{"slam": {{"slam_module": "gaussian_slam"}},
                        "mapping": {{"n_gaussians_capacity": 64}},
                        "tracking": {{"gt_camera": True}}}}, None,
                       np.array([[40.0, 0, 16], [0, 40.0, 12], [0, 0, 1]],
                                np.float32), "cpu")
xyz = torch.rand(64, 3) + torch.tensor([-0.5, -0.5, 2.0])
xyz.requires_grad_(True)
out = splat.render_gaussians(xyz, torch.full((64, 3), 0.05),
                             gs.state.quats, torch.full((64,), 0.5),
                             torch.rand(64, 3), torch.ones(64, dtype=bool),
                             torch.eye(4), gs.K, img_hw=(24, 32))
out.color.sum().backward()
assert bool(xyz.grad.isfinite().all()) and float(out.alpha.max()) > 0
assert not any(m.split(".")[0] in ("jax", "jaxlib", "yaml", "cv2")
               for m in sys.modules)
print("ISOLATED-RUN-OK")
"""


def test_runs_with_jax_yaml_cv2_blocked(tmp_path):
    (tmp_path / "cli").mkdir()
    code = _BLOCKED_RUN.format(root=str(ROOT), tests=str(ROOT / "tests"),
                               out=str(tmp_path / "out"),
                               cli=str(tmp_path / "cli"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-RUN-OK" in proc.stdout
    assert (tmp_path / "out" / "ovo_map.ckpt").exists()
    exp = tmp_path / "cli/data/output/Replica/iso"
    assert (exp / "tinyroom3" / "ovo_map.ckpt").exists()
    assert (exp / "replica" / "tinyroom3.txt").exists()
    assert (exp / "replica" / "statistics.txt").exists()


def test_entry_points_refuse_silent_cpu_fallback(tmp_path, monkeypatch):
    from ovo_tpu_torch import resolve_device
    from ovo_tpu_torch.data.masks import CallableMaskSource
    from ovo_tpu_torch.mapping.pipeline import OVOSemMap
    from ovo_tpu_torch.models.clip import CLIPModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OVOSemMap({"mapping": {}, "semantic": {}}, tmp_path, dataset=[])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CLIPModel.random_init("tiny-pe")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CallableMaskSource(lambda i, f: None)
    from ovo_tpu_torch.models.sam import build_sam_mask_source
    from ovo_tpu_torch.models.sam.model import SAMModel

    with pytest.raises(RuntimeError, match="no CUDA device"):
        SAMModel.random_init("hiera_test", 128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_sam_mask_source({"sam_encoder": "hiera_test",
                               "image_size": 128})
    from ovo_tpu_torch.factory import build_embedder
    from ovo_tpu_torch.models.merger import load_merger

    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_embedder({"clip": {"embed_type": "hovsg",
                                 "model_card": "tiny-test"}})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_merger(None)
    from ovo_tpu_torch.parallel import dryrun

    # the dry run's defaults are nccl on the cards: gloo only when asked
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--world", "1"])
    assert resolve_device("cpu").type == "cpu"


NEW_MODULES = ("ovo_tpu_torch/models/merger.py",
               "ovo_tpu_torch/parallel/__init__.py",
               "ovo_tpu_torch/parallel/mesh.py",
               "ovo_tpu_torch/parallel/shard.py",
               "ovo_tpu_torch/parallel/dryrun.py",
               "ovo_tpu_torch/viz/__init__.py",
               "ovo_tpu_torch/viz/visualizer.py",
               "ovo_tpu_torch/visualize_scene.py")


def test_last_modules_import_no_jax_matplotlib_yaml():
    bad = [(m, name) for m in NEW_MODULES
           for name in _imported_modules(ROOT / m)
           if name.split(".")[0] in FORBIDDEN + ("matplotlib", "yaml")]
    assert not bad, bad


_BLOCKED_LAST = r"""
import sys
import importlib.abc
BLOCKED = ("jax", "jaxlib", "yaml", "cv2", "matplotlib", "ovo_tpu")
class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {{name!r}}")
        return None
for name in [m for m in sys.modules if m.split(".")[0] in BLOCKED]:
    del sys.modules[name]
sys.meta_path.insert(0, _Block())
sys.path[:0] = [{root!r}, {tests!r}]
import os
from pathlib import Path
import numpy as np
import torch
from ovo_tpu_torch.models.merger import init_merger, make_train_step
from ovo_tpu_torch.parallel import dryrun, mesh, shard
from ovo_tpu_torch.viz import visualizer
from ovo_tpu_torch import run_eval, visualize_scene
params = init_merger(torch.Generator().manual_seed(0), d_model=16, depth=1,
                     mlp_hidden=8)
clips = torch.randn(4, 3, 16, generator=torch.Generator().manual_seed(1))
step = make_train_step(params, 1e-3)
losses = [float(step(clips, clips[:, 1])) for _ in range(3)]
assert losses[-1] < losses[0]
assert visualizer.heatmap_colors(np.linspace(0, 1, 5)).shape == (5, 3)
from ovo_tpu_torch.data.masks import CallableMaskSource, RecordedEmbedder
from ovo_tpu_torch.mapping.pipeline import OVOSemMap
from synthetic_scene import (CLASSES, SyntheticWallDataset,
                             class_embeddings, mask_label_fn,
                             synthetic_mask_fn)
embeds = class_embeddings(16)
cfg = {{
    "dataset_name": "synthetic", "use_wandb": False, "debug": False,
    "slam": {{"slam_module": "vanilla"}},
    "mapping": {{"map_every": 2, "k_pooling": 1, "downscale_res": 1,
                "n_points_capacity": 1 << 16}},
    "data": {{"scene_name": "wall0"}}, "vis": {{"stream": True}},
    "cam": {{"fx": 80.0, "fy": 80.0, "cx": 47.5, "cy": 31.5, "H": 64,
            "W": 96}},
    "semantic": {{"segment_every": 2, "track_th": 40, "kf_queue_delay": 1,
                 "capacity": {{"n_instances": 64, "n_masks": 16}},
                 "sam": {{"batch": 2}},
                 "clip": {{"k_top_views": 10000, "fusion": "avg_pooling",
                          "clip_dim": 16}},
                 "parallel": {{"point_shard": True, "shard_query": True,
                              "dp_embed": True}}}},
}}
m = OVOSemMap(cfg, {out!r}, dataset=SyntheticWallDataset(n_frames=6),
              mask_source=CallableMaskSource(synthetic_mask_fn, 16, "cpu"),
              embedder=RecordedEmbedder(16, mask_label_fn, embeds,
                                        {{c: embeds[i] for i, c in
                                          enumerate(CLASSES)}},
                                        device="cpu"),
              device="cpu")
m.run()
assert m.ovo.mesh.shape == (1, 1) and m.ovo.mesh.backend is None
assert m.ovo.query(["chair"]).shape[1] == 1
assert (Path({out!r}) / "stream_out" / "stream_final_instances.ply").exists()
os.chdir({cli!r})
from replica_png_scene import write_replica_scene
write_replica_scene(Path("."), "tinyroom3", 4)
run_eval.main(run_eval.parse_args(
    "--dataset_name Replica --scenes tinyroom3 --experiment_name iso "
    "--run --device cpu".split()))
visualize_scene.main(visualize_scene.parse_args(
    ["data/output/Replica/iso/tinyroom3", "--queries", "wall", "--obb",
     "--device", "cpu"]))
vis = Path("data/output/Replica/iso/tinyroom3/vis_out")
assert (vis / "query_wall_query.ply").exists()
assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
print("ISOLATED-LAST-OK")
"""


def test_last_modules_run_with_jax_matplotlib_yaml_blocked(tmp_path):
    (tmp_path / "cli").mkdir()
    code = _BLOCKED_LAST.format(root=str(ROOT), tests=str(ROOT / "tests"),
                                out=str(tmp_path / "out"),
                                cli=str(tmp_path / "cli"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, env=env, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "ISOLATED-LAST-OK" in proc.stdout
