"""The three-phase evaluation CLI of the port (port of ``run_eval.py``):

  --run      per-scene online mapping -> data/output/<Dataset>/<exp>/<scene>/
             ovo_map.ckpt (and config.yaml, stats, estimated_c2w.npy)
  --segment  label the GT point cloud of each scene from its checkpoint ->
             <exp>/<dataset>/<scene>.txt and <exp>/instance_pred/
  --eval     confusion-matrix metrics over the labelled scenes ->
             statistics.txt and the plots

    python -m ovo_tpu_torch.run_eval --dataset_name Replica --scenes room0 \\
        --experiment_name e1 --run --segment --eval [--device cpu]

The same flags, config layering, output tree and files as ``run_eval.py``,
plus ``--device`` (``cuda`` by default; without a card it raises, it never
falls back to the CPU on its own). ``--parallel_scenes N`` runs N scenes at
a time, each in a spawned process pinned through ``CUDA_VISIBLE_DEVICES``
to card ``slot % device_count`` (with ``--device cpu``, on the CPU); a
worker that exits non-zero raises. Paths are relative to the working
directory, as in the JAX CLI; ``main(args, config_root=...)`` reads the
configs from another tree than the repository's ``configs/``.
"""
from __future__ import annotations

import argparse
import gc
import os
import shutil
import time
from datetime import datetime
from pathlib import Path
from typing import Optional

import numpy as np

from . import resolve_device
from .config import REPO_ROOT, assemble_run_config
from .eval.semantics import eval_semantics
from .eval.transfer import match_labels_to_vtx
from .mapping.pipeline import OVOSemMap
from .mapping.semantic import SemanticMapper
from .utils import io as io_utils
from .utils import yaml_subset
from .utils.seeding import setup_seed

CONFIG_ROOT = REPO_ROOT / "configs"


def load_representation(scene_path: Path, eval: bool = False,
                        debug_info: bool = False, device="cuda"):
    """An eval-only SemanticMapper restored from a scene's checkpoint, and
    the checkpoint's map."""
    from .factory import build_embedder

    config = yaml_subset.load(scene_path / "config.yaml")
    ckpt = io_utils.load_ckpt(scene_path / "ovo_map.ckpt")
    map_params = ckpt.get("map_params") or ckpt["gaussian_params"]
    embedder = build_embedder(config["semantic"], device=device)
    ovo = SemanticMapper(config["semantic"], eval=True, embedder=embedder,
                         device=device)
    ovo.restore_dict(ckpt["ovo_map_params"], debug_info=debug_info)
    return ovo, map_params


def compute_scene_labels(scene_path: Path, dataset_name: str, scene_name: str,
                         data_path: str, dataset_info: dict,
                         device="cuda") -> None:
    ovo, map_params = load_representation(scene_path, eval=True,
                                          device=device)
    pcd_pred = np.asarray(map_params["xyz"])
    points_obj_ids = np.asarray(map_params["obj_ids"]).reshape(-1)

    _, pcd_gt = io_utils.load_scene_data(dataset_name, scene_name, data_path,
                                         dataset_info, False)
    classes = (dataset_info["class_names"]
               if dataset_info.get("map_to_reduced") is None
               else dataset_info["class_names_reduced"])
    pred_path = scene_path.parent / dataset_info["dataset"]
    os.makedirs(pred_path, exist_ok=True)

    print("Computing predicted instances labels ...")
    instances_info = ovo.classify_instances(classes)

    print("Matching instances to ground truth mesh ...")
    mesh_ins, mesh_masks, matched_ids = match_labels_to_vtx(
        points_obj_ids, pcd_pred, pcd_gt)
    id_to_idx = {int(i): k for k, i in enumerate(instances_info["ids"])}
    mesh_labels = instances_info["classes"][
        np.vectorize(lambda v: id_to_idx[int(v)])(mesh_ins)]
    instances_info["masks"] = mesh_masks.astype(np.int32)

    out_file = pred_path / f"{scene_name}.txt"
    print(f"Writing prediction to {out_file}!")
    io_utils.write_labels(out_file, mesh_labels)
    io_utils.write_instances(scene_path.parent, scene_name, instances_info)


def run_scene(scene: str, dataset: str, experiment_name: str,
              tmp_run: bool = False, depth_filter=None,
              config_root=CONFIG_ROOT, device="cuda") -> None:
    config = assemble_run_config(config_root, dataset, scene)
    config["data"]["input_path"] = f"data/input/Datasets/{dataset}/{scene}"

    output_path = Path(f"data/output/{dataset}/")
    if tmp_run:
        output_path = output_path / "tmp"
    output_path = output_path / experiment_name / scene

    if depth_filter is not None:
        config["semantic"]["depth_filter"] = depth_filter
    if os.getenv("DISABLE_WANDB") == "true":
        config["use_wandb"] = False
    elif config.get("use_wandb"):
        # one run per scene with the config, grouped by scene when an
        # experiment name is given
        import uuid

        try:
            import wandb
        except ImportError:
            print("[run_eval] use_wandb set but wandb is not installed; "
                  "disabling")
            config["use_wandb"] = False
            wandb = None
        if wandb is not None:
            wandb.init(
                project=config.get("project_name", "ovo-tpu"),
                config=config,
                dir="data/working/output/wandb",
                group=(config["data"]["scene_name"] if experiment_name != ""
                       else experiment_name),
                name=(f'{config["data"]["scene_name"]}_'
                      f'{time.strftime("%Y%m%d_%H%M%S", time.localtime())}_'
                      f"{str(uuid.uuid4())[:5]}"),
            )

    setup_seed(config.get("seed", 0))
    sem_map = OVOSemMap(config, output_path=output_path, device=device)
    sem_map.run()

    if tmp_run:
        final_path = Path(f"data/output/{dataset}/") / experiment_name / scene
        final_path.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(output_path), str(final_path))

    if config.get("use_wandb"):
        import wandb

        wandb.finish()
    print("Finished run.✨")


def _scene_worker(scene: str, dataset: str, experiment_name: str,
                  tmp_run: bool, card: Optional[int], config_root: Path,
                  device: str) -> None:
    """One scene in its own process, pinned to one card (``card``; None on
    the CPU) before anything touches CUDA."""
    if card is not None:
        os.environ["CUDA_VISIBLE_DEVICES"] = str(card)
    t0 = time.time()
    run_scene(scene, dataset, experiment_name, tmp_run=tmp_run,
              config_root=config_root, device=device)
    print(f"Scene {scene} took: {time.time() - t0:.2f}")


def _run_scenes_parallel(scenes, dataset, experiment_name, tmp_run,
                         n_workers: int, config_root: Path,
                         device: str) -> None:
    """Scenes ``n_workers`` at a time in spawned processes, worker ``slot``
    on card ``slot % device_count``; raises if a worker exits non-zero."""
    import multiprocessing as mp

    import torch

    n_cards = (torch.cuda.device_count()
               if resolve_device(device).type == "cuda" else 0)
    ctx = mp.get_context("spawn")
    pending = list(scenes)
    running = []
    slot = 0
    try:
        while pending or running:
            while pending and len(running) < n_workers:
                scene = pending.pop(0)
                p = ctx.Process(target=_scene_worker, args=(
                    scene, dataset, experiment_name, tmp_run,
                    slot % n_cards if n_cards else None, config_root,
                    device))
                p.start()
                running.append((scene, p))
                slot += 1
            for scene, p in list(running):
                p.join(timeout=1)
                if not p.is_alive():
                    running.remove((scene, p))
                    if p.exitcode != 0:
                        raise RuntimeError(
                            f"scene {scene} failed (exit {p.exitcode})")
    finally:
        for _, p in running:
            p.terminate()
            p.join()


def main(args, config_root=None) -> Optional[dict]:
    """Runs the phases ``args`` asks for; returns the ``--eval`` metrics
    (mIoU ``iou``, mAcc ``acc``, ...) or None."""
    config_root = Path(config_root) if config_root is not None \
        else CONFIG_ROOT
    if args.experiment_name is None:
        experiment_name = datetime.now().strftime("%Y%m%d_%H%M")
        tmp_run = True
    else:
        if not args.experiment_name:
            raise ValueError("Experiment name cannot be ''")
        experiment_name = args.experiment_name
        tmp_run = False

    experiment_path = Path("data/output") / args.dataset_name / experiment_name

    if args.scenes_list is not None:
        scenes = Path(args.scenes_list).read_text().splitlines()
    else:
        scenes = args.scenes

    dataset_info = None
    if len(scenes) == 0 or args.segment or args.eval:
        info_path = config_root / args.dataset_name / args.dataset_info_file
        dataset_info = yaml_subset.load(info_path)
        if len(scenes) == 0:
            scenes = dataset_info["scenes"]

    input_path = ""
    if args.run and args.parallel_scenes > 1:
        _run_scenes_parallel(scenes, args.dataset_name, experiment_name,
                             tmp_run, args.parallel_scenes, config_root,
                             args.device)
        input_path = (f"./data/input/Datasets/{args.dataset_name}/"
                      f"{scenes[-1]}" if scenes else "")
    else:
        for scene in scenes:
            input_path = f"./data/input/Datasets/{args.dataset_name}/{scene}"
            if args.run:
                t0 = time.time()
                run_scene(scene, args.dataset_name, experiment_name,
                          tmp_run=tmp_run, config_root=config_root,
                          device=args.device)
                print(f"Scene {scene} took: {time.time() - t0:.2f}")
            gc.collect()

    if args.segment:
        for scene in scenes:
            compute_scene_labels(experiment_path / scene, args.dataset_name,
                                 scene, "data/input/Datasets/", dataset_info,
                                 device=args.device)

    if args.eval:
        if dataset_info["dataset"] == "scannet200":
            gt_path = Path(input_path).parent / "scannet200_gt"
        else:
            gt_path = Path(input_path).parent / "semantic_gt"
        metrics, _ = eval_semantics(
            experiment_path / dataset_info["dataset"], gt_path, scenes,
            dataset_info, ignore_background=args.ignore_background,
            return_metrics=True)
        return metrics
    return None


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(
        description="Arguments to run and evaluate over a dataset")
    parser.add_argument("--dataset_name",
                        help="Dataset used. Choose either `Replica`, `ScanNet`")
    parser.add_argument("--scenes", nargs="+", type=str, default=[],
                        help="List of scenes from the dataset to run.")
    parser.add_argument("--scenes_list", type=str, default=None,
                        help="Path to a txt with one scene name per line.")
    parser.add_argument("--dataset_info_file", type=str,
                        default="eval_info.yaml")
    parser.add_argument("--experiment_name", default=None, type=str)
    parser.add_argument("--run", action="store_true")
    parser.add_argument("--segment", action="store_true")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--ignore_background", action="store_true")
    parser.add_argument("--parallel_scenes", type=int, default=1,
                        help="run N scenes concurrently, one process each "
                             "(worker slot s on card s mod device_count)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where the port runs (default: the CUDA card)")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
