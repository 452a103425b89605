"""Finding a cell's files by the names in ``BENCHMARK.json``."""
from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def load_cell(name: str, root: Path = ROOT):
    """(cell, configuration, traffic, limits) of workload ``name``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; cells: {sorted(cells)}")
    cell = cells[name]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    traffic = json.loads(
        (HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    return bench, cell, cfg, traffic, limits


def merged(a, b):
    """``b`` laid over ``a``, dicts merged key by key."""
    if not (isinstance(a, dict) and isinstance(b, dict)):
        return b
    out = dict(a)
    for k, v in b.items():
        out[k] = merged(a[k], v) if k in a else v
    return out
