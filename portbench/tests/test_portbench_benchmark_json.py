"""``BENCHMARK.json`` keeps to its format, and every cell, configuration,
traffic mix, limit and per-layer metric is found by name in a file of its
own under ``portbench/``."""
import json
import re

import pytest

from portbench.spec import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "cell": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(BENCH) == KEYS["top"]
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in
                                                BENCH["command"])
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"]
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["cell"] and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_names_and_units():
    names = [c["name"] for c in BENCH["configs"]] + \
        [w["name"] for w in BENCH["workloads"]] + \
        [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]] + \
        [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")] + \
        [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names
                                               if not NAME.match(n)]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [x["name"] for x in BENCH[kind]]
        assert len(got) == len(set(got)), kind
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for x in BENCH["configs"] + BENCH["workloads"]:
        assert _line(x["why"])
    for c in BENCH["configs"]:
        assert _line(c["source"])
    for m in BENCH["per_layer"]:
        assert _line(m["layer"])


def test_every_piece_has_its_file():
    assert any(e["name"] == "setup_s" for e in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        assert (HERE / "flops" / f"{c['name']}.py").is_file()
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
    for m in BENCH["per_layer"] + BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        # every cell that reports it reports the metric it moves
        moved = e2e[m["moves"]]
        assert set(m.get("workloads", cells)) <= set(
            moved.get("workloads", cells))
    for w in cells:
        got = [m for m in BENCH["end_to_end"]
               if w in m.get("workloads", cells)]
        assert len(got) >= 2
        assert any(w in m.get("workloads", cells) for m in BENCH["per_layer"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_cover_the_numbers_judged(cell):
    limits = json.loads((HERE / "limits" / f"{cell}.json").read_text())
    # every stage is judged: the masks by one of the two mask numbers, and
    # their selection the other way round by the shortfall
    assert {"mask_shortfall", "seg_mismatch", "desc_cos_gap",
            "assoc_mismatch", "insert_mismatch"} <= set(limits)
    assert {"mask_logit_gap", "mask_logit_max"} & set(limits)
    assert set(limits) <= {"mask_logit_gap", "mask_logit_max",
                           "mask_shortfall", "seg_mismatch", "desc_cos_gap",
                           "assoc_mismatch", "insert_mismatch"}
