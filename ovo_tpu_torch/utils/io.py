"""Checkpoints, config files, RLE masks, label files and the scenes'
ground truth (port of ``ovo_tpu/utils/io.py``).

Checkpoints are ``torch.save`` files of CPU tensors in the reference's key
layout, so the JAX package's ``load_ckpt`` and the reference's tooling read
maps written here. The run config is written as JSON with indent 2: JSON is
valid YAML, so YAML readers load ``config.yaml`` unchanged, and nothing here
needs PyYAML. Label, instance and RLE files are written byte for byte as
the JAX package writes them.
"""
from __future__ import annotations

import json
import math
import os
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import numpy as np
import torch


def _to_torch(obj):
    if isinstance(obj, dict):
        return {k: _to_torch(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_torch(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(obj))
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    return obj


def to_numpy_tree(obj):
    """Recursively convert torch tensors to numpy."""
    if isinstance(obj, dict):
        return {k: to_numpy_tree(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy_tree(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return obj


def save_dict_to_ckpt(dictionary: Dict[str, Any], file_name: str, *,
                      directory: Union[str, Path]) -> None:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(_to_torch(dictionary), directory / file_name)


def load_ckpt(path: Union[str, Path]) -> Dict[str, Any]:
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return to_numpy_tree(ckpt)


def _jsonable(obj):
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.generic,)):
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


def save_dict_to_yaml(dictionary: Dict[str, Any], file_name: str, *,
                      directory: Union[str, Path]) -> None:
    """Write ``dictionary`` as JSON (valid YAML) to directory/file_name."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / file_name, "w") as f:
        json.dump(_jsonable(dictionary), f, indent=2)


# ---------------------------------------------------------------------------
# RLE masks (ScanNet benchmark format)
# ---------------------------------------------------------------------------

def rle_encode(mask: np.ndarray) -> Dict[str, Any]:
    """Run-length-encode a 1D binary mask into the ScanNet benchmark dict."""
    length = int(mask.shape[0])
    padded = np.concatenate([[0], mask.astype(np.int64), [0]])
    edges = np.where(padded[1:] != padded[:-1])[0] + 1
    runs = edges.copy()
    runs[1::2] -= runs[::2]
    counts = " ".join(str(int(x)) for x in runs)
    return dict(length=length, counts=counts)


def rle_decode(rle: Dict[str, Any]) -> np.ndarray:
    length = int(rle["length"])
    tokens = rle["counts"].split()
    starts = np.asarray(tokens[0::2], dtype=np.int32) - 1
    nums = np.asarray(tokens[1::2], dtype=np.int32)
    mask = np.zeros(length, dtype=np.uint8)
    for lo, num in zip(starts, nums):
        mask[lo:lo + num] = 1
    return mask


def write_instances(experiment_path: Union[str, Path], scene_name: str,
                    instances_info: Dict[str, Any]) -> None:
    save_path = os.path.join(str(experiment_path), "instance_pred")
    rel_path = "./predicted_masks/"
    os.makedirs(os.path.join(save_path, rel_path), exist_ok=True)
    n_instances = len(instances_info["masks"])
    n_digits = math.trunc(math.log(max(n_instances, 2), 10)) + 1
    lines = []
    for i in range(n_instances):
        mask_file = os.path.join(rel_path, f"{scene_name}_{str(i).zfill(n_digits)}.json")
        with open(os.path.join(save_path, mask_file), "w") as f:
            json.dump(rle_encode(np.asarray(instances_info["masks"][i])), f)
        label = int(instances_info["classes"][i])
        conf = float(instances_info["conf"][i])
        lines.append(f"{mask_file} {label} {conf:.4f}")
    with open(os.path.join(save_path, f"{scene_name}.txt"), "w") as f:
        f.write("\n".join(lines))


# ---------------------------------------------------------------------------
# Label txt files
# ---------------------------------------------------------------------------

def write_labels(output_file: Union[str, Path], pcd_labels: np.ndarray) -> None:
    labels = np.asarray(pcd_labels).reshape(-1).astype(np.int64)
    with open(output_file, "w") as f:
        f.write("\n".join(str(int(v)) for v in labels))


def read_labels(path: Union[str, Path]) -> np.ndarray:
    with open(path, "r") as f:
        return np.array(f.read().splitlines()).astype(np.int64)


# ---------------------------------------------------------------------------
# GT scene loaders (eval-time; host-side)
# ---------------------------------------------------------------------------

def _read_ply_vertices(path: Union[str, Path]) -> np.ndarray:
    """Minimal PLY vertex reader (ascii, binary little- and big-endian):
    x, y, z per vertex, f64."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header_lines if l.startswith("format"))
        counts = {}
        props: Dict[str, List[Tuple[str, str]]] = {}
        current = None
        for line in header_lines:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                current = parts[1]
                counts[current] = int(parts[2])
                props[current] = []
            elif parts[0] == "property" and current is not None:
                if parts[1] == "list":
                    props[current].append(("list", parts[-1]))
                else:
                    props[current].append((parts[1], parts[2]))
        n_vtx = counts["vertex"]
        type_map = {
            "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
            "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
            "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
            "uint": "u4", "uint32": "u4",
        }
        if fmt == "ascii":
            rows = []
            names = [n for _, n in props["vertex"]]
            for _ in range(n_vtx):
                vals = f.readline().split()
                rows.append([float(v) for v in vals[:len(names)]])
            arr = np.asarray(rows)
            idx = [names.index(k) for k in ("x", "y", "z")]
            return arr[:, idx].astype(np.float64)
        endian = "<" if "little" in fmt else ">"
        dtype = np.dtype([(name, endian + type_map[t]) for t, name in props["vertex"]])
        data = np.frombuffer(f.read(dtype.itemsize * n_vtx), dtype=dtype, count=n_vtx)
        return np.stack([data["x"], data["y"], data["z"]], axis=1).astype(np.float64)


def load_scene_data(dataset_name: str, scene_name: str, data_path: str,
                    dataset_info: Dict[str, Any],
                    ignore_background: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (gt_labels, gt_vertex_coords) for a scene, with the reference's
    per-dataset conventions (io_utils.py:64-125)."""
    name = dataset_name.lower()
    if name == "replica":
        return _load_replica_scene(scene_name, data_path, dataset_info, ignore_background)
    if name == "scannet":
        return _load_scannet_scene(scene_name, data_path,
                                   dataset_info.get("dataset", "scannet"))
    if name == "scannetpp":
        return _load_scannetpp_scene(scene_name, data_path)
    raise NotImplementedError(f"{dataset_name} dataset not implemented")


def _load_replica_scene(scene_name, data_path, dataset_info, ignore_background):
    data_folder = Path(data_path) / "Replica"
    gt_labels = read_labels(data_folder / "semantic_gt" / f"{scene_name}.txt")
    map_to_reduced = dataset_info.get("map_to_reduced")
    if map_to_reduced is not None:
        gt_labels = np.vectorize(lambda v: map_to_reduced.get(int(v), -1))(gt_labels)
    ignore = list(dataset_info.get("ignore", []))
    if ignore_background:
        ignore.extend(dataset_info["background_reduced_ids"])
    for ig in ignore:
        gt_labels[gt_labels == ig] = -100
    pcd = _read_ply_vertices(data_folder / f"{scene_name}_mesh.ply")
    return gt_labels, pcd


def _load_scannet_scene(scene_name, data_path, version):
    sub = "scannet200_gt" if version == "scannet200" else "semantic_gt"
    gt_labels = read_labels(Path(data_path) / "ScanNet" / sub / f"{scene_name}.txt")
    mesh = Path(data_path) / "ScanNet" / scene_name / f"{scene_name}_vh_clean_2.labels.ply"
    return gt_labels, _read_ply_vertices(mesh)


def _load_scannetpp_scene(scene_name, data_path):
    folder = Path(data_path) / "ScanNetpp"
    gt_labels = read_labels(folder / "semantic/eval_labels" / f"{scene_name}.txt")
    mesh = torch.load(folder / "semantic/eval_meshes" / f"{scene_name}.pth")
    vtx = np.asarray(mesh["vtx_coords"], dtype=np.float32)
    # rotate z axis -90 degrees, same axis convention fix as the reference
    P = np.array([[0, 1, 0], [-1, 0, 0], [0, 0, 1]], dtype=np.float32)
    return gt_labels, vtx @ P.T
