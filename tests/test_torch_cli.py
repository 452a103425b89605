"""The port's command line and everything around it against the JAX
package: the YAML reader against PyYAML on every config file, the layered
run config, ``imread`` against ``cv2.imread``, the datasets, the label /
instance / RLE files, the metrics and the label transfer, and the CLI end
to end (``ovo_tpu_torch.run_eval.main`` against ``run_eval.main`` on the
``tinyroom3`` config), with checkpoints crossing between the packages in
both directions.

Tolerances: files, labels, integers and metrics equal; descriptors within
cosine 1 +- 1e-6 (TextRegion's limit, PARITY.md); an instance's class is
compared only where its top-2 similarity margin is above 1e-4 (f32 sums in
another order may swap a closer pair). The end-to-end runs use the JAX
random weights in both packages (SAM2 ``hiera_test`` in f32, as the port's
SAM tests, and the ``tiny-test`` CLIP card).
"""
import copy
import json
import shutil
import sys
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import yaml

import ovo_tpu.factory  # noqa: F401  (the module the JAX pipeline builds from)
from ovo_tpu.config import assemble_run_config as jax_assemble
from ovo_tpu.data.datasets import get_dataset as jax_get_dataset
from ovo_tpu.eval import semantics as jsem
from ovo_tpu.eval.transfer import match_labels_to_vtx as jax_match
from ovo_tpu.models.clip import CLIPModel as JaxCLIP
from ovo_tpu.models.sam.model import SAMConfig as JaxSAMConfig
from ovo_tpu.models.sam.model import SAMModel as JaxSAM
from ovo_tpu.utils import io as jio

from ovo_tpu_torch import run_eval as port_cli
from ovo_tpu_torch.config import assemble_run_config
from ovo_tpu_torch.data import images
from ovo_tpu_torch.data.datasets import get_dataset
from ovo_tpu_torch.eval import semantics as tsem
from ovo_tpu_torch.eval.transfer import match_labels_to_vtx
from ovo_tpu_torch.models.clip import CLIPModel
from ovo_tpu_torch.models.sam.model import SAMModel
from ovo_tpu_torch.utils import io as tio
from ovo_tpu_torch.utils import yaml_subset

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "scripts")]
import run_eval as jax_cli  # noqa: E402
from replica_png_scene import write_replica_scene  # noqa: E402

CONFIG_FILES = sorted(str(p.relative_to(ROOT))
                      for p in (ROOT / "configs").rglob("*.yaml"))


# ---------------------------------------------------------------------------
# config files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CONFIG_FILES)
def test_yaml_subset_matches_pyyaml(name):
    path = ROOT / name
    assert yaml_subset.load(path) == yaml.safe_load(path.read_text())


def test_yaml_subset_reads_dumped_configs_and_refuses_the_rest():
    cfg = jax_assemble(ROOT / "configs", "Replica", "tinyroom3")
    cfg["extra"] = {"f": 1e-5, "s": "a: b", "q": "it's", "n": [-3.5, None],
                    "e": "", "t": True, "m": {"k": [1, {"x": 2}]}}
    for text in (yaml.dump(cfg), yaml.safe_dump(cfg, sort_keys=False)):
        assert yaml_subset.loads(text) == yaml.safe_load(text)
    # JSON (the port's config.yaml) reads as JSON: 1e-05 is a float there,
    # where YAML 1.1 would read a string
    text = json.dumps(cfg, indent=2)
    assert yaml_subset.loads(text) == json.loads(text)
    for bad in ("a: &x 1", "a: *x", "a: !!int 1", "a: |\n  x", "a: 1:20",
                "a: 2001-01-01", "a: b\n  c", "---\na: 1"):
        with pytest.raises(ValueError, match=r"t\.yaml:\d+"):
            yaml_subset.loads(bad, "t.yaml")


@pytest.mark.parametrize("dataset,scene,overrides", [
    ("Replica", "room0", None),
    ("ScanNet", "scene0011_00", None),
    ("Replica", "room0", {"slam": {"slam_module": "orbslam"}}),
    ("ScanNet", "scene0011_00", {"slam": {"slam_module": "orbslam"}}),
    ("ScanNet", "scene0050_00", {"slam": {"slam_module": "orbslam"}}),
    ("ScanNet", "scene0011_00", {"slam": {"slam_module": "vanilla"}}),
    ("Replica", "tinyroom3", None),
])
def test_assemble_run_config_matches_jax(dataset, scene, overrides):
    args = (ROOT / "configs", dataset, scene)
    assert assemble_run_config(*args, overrides=copy.deepcopy(overrides)) \
        == jax_assemble(*args, overrides=copy.deepcopy(overrides))


# ---------------------------------------------------------------------------
# images and datasets
# ---------------------------------------------------------------------------

def _image(rng, kind):
    shape, dtype = {"rgb8": ((37, 53, 3), np.uint8),
                    "rgba8": ((11, 13, 4), np.uint8),
                    "gray8": ((9, 10), np.uint8),
                    "gray16": ((29, 41), np.uint16)}[kind]
    img = rng.integers(0, np.iinfo(dtype).max + 1, shape, dtype=dtype)
    img[:, :5] = img[:1, :5]          # a flat band: runs of equal bytes
    return img


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", ["rgb8", "rgba8", "gray8", "gray16"])
def test_imread_matches_cv2(tmp_path, rng, kind, filter_type):
    """Every row filter on 8-bit gray / RGB / RGBA and 16-bit gray: equal
    arrays and dtypes for IMREAD_COLOR and IMREAD_UNCHANGED."""
    path = tmp_path / "x.png"
    images.write_png(path, _image(rng, kind), filter_type)
    for flags in (images.IMREAD_COLOR, images.IMREAD_UNCHANGED):
        got, ref = images.imread(path, flags), cv2.imread(str(path), flags)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_imread_reads_cv2_written_pngs_and_resizes_as_cv2(tmp_path, rng):
    """cv2's own PNGs (adaptive filters, 8-bit BGR and 16-bit depth), a
    JPEG through cv2, and the nearest resize's index rule."""
    for name, img in (("c.png", _image(rng, "rgb8")),
                      ("d.png", _image(rng, "gray16")),
                      ("j.jpg", _image(rng, "rgb8"))):
        cv2.imwrite(str(tmp_path / name), img)
        for flags in (images.IMREAD_COLOR, images.IMREAD_UNCHANGED):
            np.testing.assert_array_equal(
                images.imread(tmp_path / name, flags),
                cv2.imread(str(tmp_path / name), flags))
    x = rng.random((50, 70))
    for size in ((35, 25), (140, 100), (71, 49), (70, 50)):
        np.testing.assert_array_equal(
            images.resize_nearest(x, size),
            cv2.resize(x, size, interpolation=cv2.INTER_NEAREST))


def _frames_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_replica_and_scannet_frames_match_jax(tmp_path, rng):
    write_replica_scene(tmp_path, "s0", 3)
    cam = {"H": 64, "W": 96, "fx": 80.0, "fy": 80.0, "cx": 47.5, "cy": 31.5,
           "depth_scale": 6553.5}
    cfg = {"input_path": str(tmp_path / "data/input/Datasets/Replica/s0"),
           **cam}
    for resize in (1.0, 0.5):      # at the frames' size, then cv2's resize
        c = dict(cfg, resize_ratio=resize)
        ours, ref = get_dataset("replica")(c), jax_get_dataset("replica")(c)
        assert len(ours) == len(ref) == 3
        np.testing.assert_array_equal(ours.intrinsics, ref.intrinsics)
        for i in range(3):
            _frames_equal(ours[i], ref[i])

    sn = tmp_path / "scannet"
    for d in ("color", "depth", "pose"):
        (sn / d).mkdir(parents=True)
    for i in range(2):
        cv2.imwrite(str(sn / "color" / f"{i}.jpg"), _image(rng, "rgb8"))
        images.write_png(sn / "depth" / f"{i}.png",
                         rng.integers(0, 6000, (30, 40), dtype=np.uint16))
        np.savetxt(sn / "pose" / f"{i}.txt", np.eye(4) + i, fmt="%.6f")
    cfg = {"input_path": str(sn), "H": 30, "W": 40, "fx": 30.0, "fy": 30.0,
           "cx": 19.5, "cy": 14.5, "depth_scale": 1000.0, "depth_th": 4.0,
           "crop_edge": 2}
    ours, ref = get_dataset("ScanNet")(cfg), jax_get_dataset("ScanNet")(cfg)
    np.testing.assert_array_equal(ours.intrinsics, ref.intrinsics)
    for i in range(2):
        _frames_equal(ours[i], ref[i])


# ---------------------------------------------------------------------------
# label files, metrics, label transfer
# ---------------------------------------------------------------------------

def test_label_instance_rle_files_match_jax(tmp_path, rng):
    labels = rng.integers(-1, 50, 300)
    masks = (rng.random((12, 80)) > 0.5).astype(np.int32)
    info = {"masks": masks, "classes": rng.integers(0, 5, 12),
            "conf": rng.random(12)}
    for mod, d in ((tio, tmp_path / "t"), (jio, tmp_path / "j")):
        d.mkdir()
        mod.write_labels(d / "l.txt", labels)
        mod.write_instances(d, "sc", info)
    files = sorted(p.relative_to(tmp_path / "j")
                   for p in (tmp_path / "j").rglob("*") if p.is_file())
    assert len(files) == 14
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes()
    np.testing.assert_array_equal(tio.read_labels(tmp_path / "t/l.txt"),
                                  labels)
    for m in masks:
        rle = tio.rle_encode(m)
        assert rle == jio.rle_encode(m)
        np.testing.assert_array_equal(tio.rle_decode(rle), m)


def test_eval_semantics_and_transfer_match_jax(tmp_path, rng):
    info = {"dataset": "toy", "num_classes": 6,
            "class_names_reduced": list("abcdef"),
            "map_to_reduced": {10: 0, 20: 1, 30: 2, 40: 3, 50: 4, 60: 5,
                               70: -1},
            "ignore": [-1], "background_reduced_ids": [0]}
    scenes = ["s1", "s2"]
    for d in ("gt", "pt", "pj"):
        (tmp_path / d).mkdir()
    for s in scenes:
        gt = rng.choice([10, 20, 30, 40, 50, 60, 70, 99], 400)
        pr = rng.integers(0, 6, 400)
        for mod, d in ((jio, "gt"), (jio, "pt"), (jio, "pj")):
            mod.write_labels(tmp_path / d / f"{s}.txt",
                             gt if d == "gt" else pr)
    for ignore_bg in (False, True):
        ours = tsem.eval_semantics(tmp_path / "pt", tmp_path / "gt", scenes,
                                   info, ignore_background=ignore_bg,
                                   return_metrics=True)
        ref = jsem.eval_semantics(tmp_path / "pj", tmp_path / "gt", scenes,
                                  info, ignore_background=ignore_bg,
                                  return_metrics=True)
        assert json.dumps(ours[0]) == json.dumps(ref[0])
        np.testing.assert_array_equal(ours[1], ref[1])
        assert (tmp_path / "pt/statistics.txt").read_bytes() == \
            (tmp_path / "pj/statistics.txt").read_bytes()

    pts = rng.standard_normal((500, 3))
    ids = rng.integers(-1, 7, 500)
    vtx = rng.standard_normal((300, 3))
    for a, b in zip(match_labels_to_vtx(ids, pts, vtx),
                    jax_match(ids, pts, vtx)):
        np.testing.assert_array_equal(a, b)


def test_eval_scannetpp_matches_jax(tmp_path, rng):
    (tmp_path / "classes.txt").write_text("wall\nchair\ntable\nlamp\n")
    (tmp_path / "p").mkdir()
    (tmp_path / "g").mkdir()
    np.savetxt(tmp_path / "p/s.txt", rng.integers(0, 4, (200, 3)), fmt="%d")
    np.savetxt(tmp_path / "g/s.txt",
               rng.choice([0, 1, 2, 3, -100], 200), fmt="%d")
    cfg = {"scene_ids": ["s"], "classes_file": str(tmp_path / "classes.txt"),
           "preds_dir": str(tmp_path / "p"), "gt_dir": str(tmp_path / "g")}
    for k in ([1], [1, 3], [2]):
        assert tsem.eval_scannetpp_semantic(cfg, k, verbose=False) == \
            jsem.eval_scannetpp_semantic(cfg, k, verbose=False)


# ---------------------------------------------------------------------------
# the CLI end to end, and checkpoints across the packages
# ---------------------------------------------------------------------------

def _args(experiment, *phases, device=None):
    argv = ["--dataset_name", "Replica", "--scenes", "tinyroom3",
            "--experiment_name", experiment] + [f"--{p}" for p in phases]
    if device:
        argv += ["--device", device]
    return argv


def _patch_weights(mp):
    """Both packages' factories build their random models from the same
    JAX weights: SAM2 in f32 (the port's SAM tests' setting) and the CLIP
    card JAX's factory draws."""
    jax_sam_init = JaxSAM.random_init.__func__
    jax_clip_init = JaxCLIP.random_init.__func__
    cache = {}

    def jax_sam(enc, image_size=1024, seed=0):
        if ("sam", enc, image_size) not in cache:
            m = jax_sam_init(JaxSAM, enc, image_size=image_size, seed=seed)
            cache[("sam", enc, image_size)] = JaxSAM(
                JaxSAMConfig(enc, image_size, compute_dtype="float32"),
                m.params)
        return cache[("sam", enc, image_size)]

    def jax_clip(name, seed=0):
        if ("clip", name) not in cache:
            cache[("clip", name)] = jax_clip_init(JaxCLIP, name, seed=seed)
        return cache[("clip", name)]

    def np_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    def port_sam(encoder="hiera_l", image_size=1024, seed=0, device="cuda",
                 compute_dtype="bfloat16"):
        return SAMModel.from_jax_params(
            encoder, image_size, np_tree(jax_sam(encoder, image_size).params),
            device=device, compute_dtype="float32")

    def port_clip(name, seed=0, device="cuda"):
        return CLIPModel.from_jax_params(name, np_tree(jax_clip(name).params),
                                         device=device)

    mp.setattr(JaxSAM, "random_init", staticmethod(jax_sam))
    mp.setattr(JaxCLIP, "random_init", staticmethod(jax_clip))
    mp.setattr(SAMModel, "random_init", staticmethod(port_sam))
    mp.setattr(CLIPModel, "random_init", staticmethod(port_clip))


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """JAX and the port, each --run --segment --eval on the 8-frame
    tinyroom3 scene; then each package's --segment --eval on the other's
    --run output."""
    root = tmp_path_factory.mktemp("cli")
    write_replica_scene(root, "tinyroom3", 8)
    out = root / "data/output/Replica"
    metrics = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(root)
        mp.setenv("DISABLE_WANDB", "true")
        _patch_weights(mp)
        import argparse

        def jax_main(argv):
            ns = port_cli.parse_args(argv)
            ns = argparse.Namespace(**{k: v for k, v in vars(ns).items()
                                       if k != "device"})
            jax_cli.main(ns)

        jax_main(_args("jax", "run", "segment", "eval"))
        metrics["port"] = port_cli.main(port_cli.parse_args(
            _args("port", "run", "segment", "eval", device="cpu")))
        for src, dst in (("jax", "jax_by_port"), ("port", "port_by_jax")):
            shutil.copytree(out / src / "tinyroom3", out / dst / "tinyroom3")
        metrics["jax_by_port"] = port_cli.main(port_cli.parse_args(
            _args("jax_by_port", "segment", "eval", device="cpu")))
        jax_main(_args("port_by_jax", "segment", "eval"))
        # the JAX --segment's classification margins decide which instance
        # classes are compared
        info = yaml.safe_load(open(ROOT / "configs/Replica/eval_info.yaml"))
        ovo, _ = jax_cli.load_representation(out / "jax" / "tinyroom3")
        sims = ovo.query(info["class_names_reduced"],
                         ["This is a photo of a {}"])
        top2 = np.sort(sims, axis=1)
        margins = dict(zip(ovo.active_ids().tolist(),
                           (top2[:, -1] - top2[:, -2]).tolist()))
    return out, metrics, margins


def _stats(d: Path):
    return (d / "replica" / "statistics.txt").read_text()


def _labels_equal_where_clear(a: Path, b: Path, obj_ids, margins):
    """Per-vertex label files equal, or differing only on vertices whose
    instance's top-2 margin is at most 1e-4."""
    la = tio.read_labels(a / "replica/tinyroom3.txt")
    lb = tio.read_labels(b / "replica/tinyroom3.txt")
    assert la.shape == lb.shape and len(la) > 100
    clear = np.array([margins.get(int(i), 0.0) > 1e-4 for i in obj_ids])
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(la[clear], lb[clear])
    return bool((la == lb).all())


def _mesh_instances(out: Path, exp: str):
    """Each GT vertex's instance, from the run's checkpoint."""
    ckpt = tio.load_ckpt(out / exp / "tinyroom3" / "ovo_map.ckpt")
    mp = ckpt["map_params"]
    _, pcd_gt = tio.load_scene_data(
        "Replica", "tinyroom3", str(out.parents[1] / "input/Datasets"),
        {"ignore": []})
    mesh_ins, _, _ = match_labels_to_vtx(
        np.asarray(mp["obj_ids"]).reshape(-1), np.asarray(mp["xyz"]), pcd_gt)
    return mesh_ins


def test_cli_run_matches_jax(cli_runs):
    """--run: equal map points and instance ids, the same checkpoint keys
    (the debug layout of configs/ovo.yaml's debug: true included),
    descriptors within cosine 1e-6; the same config.yaml contents."""
    out, _, _ = cli_runs
    j = tio.load_ckpt(out / "jax/tinyroom3/ovo_map.ckpt")
    t = tio.load_ckpt(out / "port/tinyroom3/ovo_map.ckpt")
    jm, tm = j["map_params"], t["map_params"]
    assert len(np.asarray(jm["xyz"])) > 1000
    for key in ("xyz", "obj_ids"):
        np.testing.assert_array_equal(np.asarray(tm[key]),
                                      np.asarray(jm[key]))
    jo, to = j["ovo_map_params"], t["ovo_map_params"]
    assert sorted(to) == sorted(jo)
    ids = np.asarray(jo["ins_3d_ids"])
    np.testing.assert_array_equal(np.asarray(to["ins_3d_ids"]), ids)
    assert len(ids) >= 1
    n = 0
    for i in ids:
        a, b = to[f"ins3d_{i}_clip_feature"], jo[f"ins3d_{i}_clip_feature"]
        assert (a is None) == (b is None)
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
            assert abs(cos - 1.0) <= 1e-6
            n += 1
        np.testing.assert_array_equal(to[f"ins3d_{i}_keyframes_ids"],
                                      jo[f"ins3d_{i}_keyframes_ids"])
    assert n >= 1
    np.testing.assert_array_equal(to["ins_map"], jo["ins_map"])
    assert yaml.safe_load(open(out / "port/tinyroom3/config.yaml")) == \
        yaml.safe_load(open(out / "jax/tinyroom3/config.yaml"))


def test_cli_segment_eval_match_jax(cli_runs):
    """--segment and --eval: equal label files under the margin rule, and
    equal metrics and statistics when the labels are equal."""
    out, metrics, margins = cli_runs
    mesh_ins = _mesh_instances(out, "jax")
    if _labels_equal_where_clear(out / "jax", out / "port", mesh_ins,
                                 margins):
        assert _stats(out / "port") == _stats(out / "jax")
    assert np.isfinite(metrics["port"]["iou"])
    assert (out / "port/instance_pred/tinyroom3.txt").exists()


def test_checkpoints_cross_between_packages(cli_runs):
    """The port's --segment on JAX's --run output, and JAX's --segment on
    the port's, label the mesh as the producing package did."""
    out, metrics, margins = cli_runs
    mesh_ins = _mesh_instances(out, "jax")
    for a, b in (("jax_by_port", "jax"), ("port_by_jax", "port")):
        if _labels_equal_where_clear(out / a, out / b, mesh_ins, margins):
            assert _stats(out / a) == _stats(out / b)
            assert (out / a / "instance_pred/tinyroom3.txt").read_bytes() == \
                (out / b / "instance_pred/tinyroom3.txt").read_bytes()
    assert metrics["jax_by_port"] is not None
