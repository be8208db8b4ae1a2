"""BENCHMARK.json: keys, names, units and the files each entry needs."""

import json
import re
from pathlib import Path

import pytest

from stevi_bench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert BENCH["command"] == ["python3", "stevi_bench/run.py"]
    assert BENCH["paths"] == ["stevi_bench"]
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a regression check of 24 cells at this length fits in 12 hours
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    assert 1 <= len(BENCH["configs"]) <= 24
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"].startswith("stevi_bench/") and c["file"] not in files
        files.add(c["file"])
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert "assumed" in data
        harness.resolve(data["program"])
        assert (ROOT / "stevi_bench" / "reference"
                / f"{data['reference']}.py").exists()
        assert set(data["check"]["limits"]) == {"mismatch_share",
                                                "subpixel_gap_px"}


def test_workloads():
    assert 1 <= len(CELLS) <= 24 and len(set(CELLS)) == len(CELLS)
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(CELLS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert (ROOT / "stevi_bench" / "traffic"
                / f"{w['traffic']}.json").exists()


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH[kind]:
        keys = {"name", "unit", "better", "source"}
        keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
        assert keys <= set(m) <= keys | {"workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert all(w in CELLS for w in m.get("workloads", CELLS))
        harness.metric_reader(ROOT, m["name"])
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert _text(m["layer"]) and m["moves"] in E2E
            moved = E2E[m["moves"]].get("workloads", CELLS)
            assert set(m["workloads"]) <= set(moved)
            if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
                assert m["unit"] == "%"


def test_every_cell_reports_enough():
    assert E2E["setup_s"]["bound"] <= 0.25
    for cell in CELLS:
        e2e = [m for m in BENCH["end_to_end"]
               if cell in m.get("workloads", CELLS)]
        layer = [m for m in BENCH["per_layer"]
                 if cell in m.get("workloads", CELLS)]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        assert layer


def test_layers_are_named_alike():
    by_file = {}
    for m in BENCH["per_layer"]:
        by_file.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_file.values())


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "stevi_bench").rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
