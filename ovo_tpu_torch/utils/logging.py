"""Run logger with the reference's stat names and file layout (port of
``ovo_tpu/utils/logging.py``).

Stats: frame_id, t_sam, t_obj, n_obj, n_matches, t_up, t_seg, t_clip,
avg_fps, ram, vram, spf -- one ``<key>.log`` text file each under
``<output>/logger/``. ``vram`` is ``torch.cuda.memory_allocated`` of the
run's device in GB (0 on the CPU). Under ``semantic.log`` the mapper
logs ``t_sam``, ``t_obj``, ``t_clip`` and ``t_up`` from its program spans
(``utils/trace.py``): the keyframe's ``mask_source`` over the keyframes it
segmented, ``association``, ``embedder`` less its ``embedder.update``, and
``embedder.update``, in seconds.
"""
from __future__ import annotations

import pprint
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

STAT_KEYS = ["frame_id", "t_sam", "t_obj", "n_obj", "n_matches", "t_up",
             "t_seg", "t_clip", "avg_fps", "ram", "vram", "spf"]


def _rss_bytes() -> float:
    try:
        import psutil
    except ImportError:
        return 0.0
    return float(psutil.Process().memory_info().rss)


class Logger:
    def __init__(self, output_path, device: Optional[torch.device] = None,
                 use_wandb: bool = False) -> None:
        if use_wandb:
            raise NotImplementedError("wandb logging is not ported")
        self.output_path = Path(output_path)
        (self.output_path / "logger").mkdir(exist_ok=True, parents=True)
        self.stats: Dict[str, list] = {key: [] for key in STAT_KEYS}
        self.device = device

    def log_ovo_stats(self, stats: Dict[str, Any],
                      print_output: bool = False) -> None:
        for key, item in stats.items():
            self.stats.setdefault(key, []).append(item)
        if print_output:
            pprint.pprint(stats, width=160, compact=True)

    def log_fps(self, avg_fps: float) -> None:
        self.stats["avg_fps"].append(avg_fps)

    def log_spf(self, spf) -> None:
        self.stats["spf"].append(spf)

    def log_memory_usage(self, frame_id: int) -> None:
        vram = 0.0
        if self.device is not None and self.device.type == "cuda":
            vram = torch.cuda.memory_allocated(self.device) / 1000 ** 3
        self.stats["vram"].append(vram)
        self.stats["ram"].append(_rss_bytes() / 1000 ** 3)

    def log_max_memory_usage(self) -> None:
        self.stats["max_vram"] = [max(self.stats["vram"], default=0.0)]
        self.stats["max_ram"] = [max(self.stats["ram"], default=0.0)]

    def write_stats(self) -> None:
        for key, stat in self.stats.items():
            if key == "n_obj":
                continue
            with open(self.output_path / "logger" / f"{key}.log", "w") as f:
                f.write("\n".join(str(i) for i in stat))

    def print_final_stats(self) -> None:
        summary = {}
        for key, stat in self.stats.items():
            if key in ("frame_id", "max_vram", "max_ram") or not stat:
                continue
            try:
                summary[f"Avg {key}"] = float(
                    np.mean(np.asarray(stat, dtype=float)).round(3))
            except (TypeError, ValueError):
                continue
        if self.stats.get("max_ram"):
            summary["Max RAM"] = round(self.stats["max_ram"][0], 2)
            summary["Max vRAM"] = round(self.stats["max_vram"][0], 2)
        print("Final statistics:")
        pprint.pprint(summary, compact=True)
