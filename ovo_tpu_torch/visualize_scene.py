"""Offline scene viewer of the port (port of ``visualize_scene.py``): load
a finished run's checkpoint, color the map by instance / RGB, render
free-text query heatmaps, and color a GT mesh by prediction correctness.

    python -m ovo_tpu_torch.visualize_scene <scene_out_dir> \
        --queries "a chair" [--obb] [--device cpu]

With open3d installed this opens an interactive window; headless (every
machine the port runs on) it exports colored PLY snapshots under
``<scene>/vis_out``. Configs are read with ``utils/yaml_subset.py``, the
checkpoint through the port's ``run_eval.load_representation``; queries
run on ``--device`` (the card by default).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from .config import REPO_ROOT
from .run_eval import load_representation
from .utils import yaml_subset
from .viz.visualizer import Visualizer, write_ply


def _color_gt_vs_pred(vtx: np.ndarray, gt: np.ndarray, pred: np.ndarray,
                      out_dir: Path) -> None:
    """Core of the gt-vs-pred view: color GT mesh vertices by prediction
    correctness (reference visualizer.py:401-599 ``visualize_gt_vs_pred``):
    green = match, red = mismatch, grey = ignored (-100/-1 GT)."""
    if not len(vtx) == len(gt) == len(pred):
        raise ValueError(f"vertex/label count mismatch: {len(vtx)}/"
                         f"{len(gt)}/{len(pred)}")
    colors = np.full((len(vtx), 3), 60, np.uint8)
    valid = gt >= 0
    colors[valid & (gt == pred)] = (40, 200, 40)
    colors[valid & (gt != pred)] = (220, 40, 40)
    out_dir.mkdir(parents=True, exist_ok=True)
    write_ply(out_dir / "gt_vs_pred.ply", vtx, colors)
    acc = float((gt[valid] == pred[valid]).mean()) if valid.any() else 0.0
    print(f"gt-vs-pred: {valid.sum()} labelled vertices, point acc "
          f"{acc:.3f}; wrote {out_dir / 'gt_vs_pred.ply'}")


def gt_vs_pred(mesh_ply: str, gt_txt: str, pred_txt: str, out_dir: Path,
               dataset_info: str | None = None) -> None:
    """Explicit-paths gt-vs-pred: load label txt files and a mesh ply
    directly. ``dataset_info`` (an eval_info.yaml) remaps raw GT ids to the
    reduced label space the --segment predictions use."""
    from .utils import io as io_utils

    vtx = io_utils._read_ply_vertices(Path(mesh_ply))
    gt = io_utils.read_labels(Path(gt_txt))
    pred = io_utils.read_labels(Path(pred_txt))
    if dataset_info:
        info = yaml_subset.load(dataset_info)
        remap = info.get("map_to_reduced")
        if remap is not None:
            gt = np.vectorize(lambda v: remap.get(int(v), -1))(gt)
        for ig in info.get("ignore", []):
            gt[gt == ig] = -100
    _color_gt_vs_pred(vtx, gt, pred, out_dir)


def _dataset_config_dir(dataset_name: str) -> str:
    """Reference's capitalize_first + scannet special case
    (visualize_scene.py:11-24)."""
    name = dataset_name[0].upper() + dataset_name[1:]
    return "ScanNet" if name.lower() == "scannet" else name


def gt_vs_pred_from_run(run_path: Path, working_dir: Path,
                        dataset_info_file: str) -> None:
    """Reference-style derived gt-vs-pred (visualize_scene.py:14-67): read
    the run's config.yaml, load the GT scene via the dataset conventions,
    and pick up the --segment prediction txt next to the run dir."""
    from .utils import io as io_utils

    config = yaml_subset.load(run_path / "config.yaml")
    dataset_name = config["dataset_name"]
    scene_name = config["data"]["scene_name"]
    # reference layout first (working_dir/data/working/configs/<Dataset>/),
    # then this repo's configs/ tree
    candidates = [
        working_dir / "data/working/configs"
        / _dataset_config_dir(dataset_name) / dataset_info_file,
        REPO_ROOT / "configs" / _dataset_config_dir(dataset_name)
        / dataset_info_file,
    ]
    info_path = next((p for p in candidates if p.exists()), candidates[-1])
    dataset_info = yaml_subset.load(info_path)
    data_path = working_dir / "data/input/Datasets/"

    gt, vtx = io_utils.load_scene_data(dataset_name, scene_name,
                                       str(data_path), dataset_info, False)
    pred = io_utils.read_labels(
        run_path.parent / dataset_info["dataset"] / f"{scene_name}.txt")
    _color_gt_vs_pred(np.asarray(vtx), np.asarray(gt),
                      np.asarray(pred), run_path / "vis_out")


def main(args) -> None:
    scene_path = Path(args.working_dir) / args.scene_path
    if args.visualize_gt_vs_pre:
        gt_vs_pred_from_run(scene_path, Path(args.working_dir),
                            args.dataset_info_file)
        if not (args.queries or args.visualize_obj
                or args.visualize_interactive_query):
            return
    if args.gt_labels:
        gt_vs_pred(args.mesh, args.gt_labels, args.pred_labels,
                   scene_path / "vis_out", dataset_info=args.dataset_info)
        if not args.queries:
            return
    ovo, map_params = load_representation(scene_path, eval=True,
                                          device=args.device)
    points = np.asarray(map_params["xyz"])
    obj_ids = np.asarray(map_params["obj_ids"]).reshape(-1)
    colors = np.asarray(map_params.get("color")) \
        if map_params.get("color") is not None else None

    viz = Visualizer(ovo, output_dir=scene_path / "vis_out")
    viz.visualize_and_query(
        points, obj_ids, colors, queries=args.queries,
        show_obbs=args.obb or args.visualize_obj,
        interactive=args.visualize_interactive_query)


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("scene_path",
                        help="run output dir containing ovo_map.ckpt "
                             "(reference's run_path)")
    parser.add_argument("--working_dir", default="",
                        help="prefix for scene_path and dataset paths "
                             "(reference visualize_scene.py flag)")
    parser.add_argument("--visualize_obj", action="store_true",
                        help="instance-color + OBB view (reference flag; "
                             "same as --obb)")
    parser.add_argument("--visualize_interactive_query", action="store_true",
                        help="open the interactive text-query window "
                             "(reference flag)")
    parser.add_argument("--visualize_gt_vs_pre", action="store_true",
                        help="derived gt-vs-pred view from the run config "
                             "(reference flag)")
    parser.add_argument("--dataset_info_file", default="eval_info.yaml",
                        help="eval info yaml under configs/<Dataset>/ "
                             "(reference flag)")
    parser.add_argument("--queries", nargs="*", default=[],
                        help="free-text queries to render as heatmaps")
    parser.add_argument("--gt_labels", default=None,
                        help="GT per-vertex label txt (enables gt-vs-pred)")
    parser.add_argument("--pred_labels", default=None,
                        help="predicted per-vertex label txt (--segment "
                             "output)")
    parser.add_argument("--mesh", default=None,
                        help="GT mesh ply matching the label files")
    parser.add_argument("--dataset_info", default=None,
                        help="eval_info.yaml for raw->reduced GT remap")
    parser.add_argument("--obb", action="store_true",
                        help="also export per-instance oriented bounding "
                             "boxes (visualizer.py:401-599 OBB view)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where queries run (default: the CUDA card)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
