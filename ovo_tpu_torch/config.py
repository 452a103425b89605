"""Config files: a YAML tree with ``inherit_from`` chains and a deep merge
(port of ``ovo_tpu/config.py``).

A config file may name a parent with ``inherit_from``; the parent loads
first and the child deep-merges on top (dicts merge, any other value
overwrites). Files are read with the port's own YAML reader
(``utils/yaml_subset.py``), which also reads the JSON the port writes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

from .utils import yaml_subset

REPO_ROOT = Path(__file__).resolve().parents[1]


def update_recursive(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    """Deep-merge ``src`` into ``dst`` in place (dicts merge, leaves
    overwrite)."""
    for key, value in src.items():
        if isinstance(value, dict):
            node = dst.get(key)
            if not isinstance(node, dict):
                node = {}
                dst[key] = node
            update_recursive(node, value)
        else:
            dst[key] = value


def load_config(path, default_path=None, inherit: bool = True
                ) -> Dict[str, Any]:
    """Load a config, resolving ``inherit_from`` chains (child wins). A
    relative parent path is taken from the working directory, else from the
    child's directory, else from the repository root."""
    path = Path(path)
    cfg_special = yaml_subset.load(path) or {}
    cfg: Dict[str, Any] = {}
    inherit_from = cfg_special.get("inherit_from")
    if inherit_from is not None and inherit:
        parent = Path(inherit_from)
        if not parent.is_absolute() and not parent.exists():
            for base in (path.parent, REPO_ROOT):
                candidate = base / parent
                if candidate.exists():
                    parent = candidate
                    break
        cfg = load_config(parent, default_path)
    elif default_path is not None:
        cfg = yaml_subset.load(default_path) or {}
    update_recursive(cfg, cfg_special)
    return cfg


def save_config(cfg: Dict[str, Any], path) -> None:
    """Write ``cfg`` as JSON, which YAML readers load unchanged."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg, f, indent=2)


def assemble_run_config(config_root, dataset: str, scene: str,
                        overrides: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """The run's layered config: ``ovo.yaml`` <- ``slam/<module>/
    <dataset>.yaml`` (the orbslam tiers: the vanilla layer, then
    ``slam/orbslam/<dataset>.yaml`` and ``slam/orbslam/<dataset>/
    <scene>.yaml``) <- ``<Dataset>/<dataset>.yaml`` <- optional
    ``<Dataset>/<scene>.yaml`` <- ``overrides``."""
    root = Path(config_root)
    cfg = load_config(root / "ovo.yaml")

    map_module = cfg["slam"]["slam_module"]
    if overrides:  # an overridden module selects its slam layer too
        map_module = overrides.get("slam", {}).get("slam_module", map_module)
    is_orb = map_module.startswith("orbslam")
    if is_orb:
        map_module = "vanilla"  # orbslam reuses the vanilla mapping params
    slam_cfg_path = root / "slam" / map_module / f"{dataset.lower()}.yaml"
    if slam_cfg_path.exists():
        update_recursive(cfg, load_config(slam_cfg_path))
    if is_orb:
        orb_ds = root / "slam" / "orbslam" / f"{dataset.lower()}.yaml"
        if orb_ds.exists():
            update_recursive(cfg, load_config(orb_ds))
        orb_scene = root / "slam" / "orbslam" / dataset.lower() / \
            f"{scene}.yaml"
        if orb_scene.exists():
            update_recursive(cfg, load_config(orb_scene))

    ds_cfg_path = root / dataset / f"{dataset.lower()}.yaml"
    if ds_cfg_path.exists():
        update_recursive(cfg, load_config(ds_cfg_path))

    scene_cfg_path = root / dataset / f"{scene}.yaml"
    if scene_cfg_path.exists():
        update_recursive(cfg, load_config(scene_cfg_path))

    cfg.setdefault("data", {})
    cfg["data"]["scene_name"] = scene
    if overrides:
        update_recursive(cfg, overrides)
    return cfg
