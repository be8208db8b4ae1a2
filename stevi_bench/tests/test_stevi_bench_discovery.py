"""A configuration, a traffic mix and a metric added as files, found by
name with no other file edited."""

import json
import shutil
from pathlib import Path

import torch

from stevi_bench import harness

ROOT = Path(__file__).resolve().parents[2]


def test_new_files_are_found(tmp_path, small_cell):
    src = ROOT / "stevi_bench"
    for sub in ("configs", "traffic", "metrics"):
        shutil.copytree(src / sub, tmp_path / "stevi_bench" / sub)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "stevi_bench").rglob("*")
              if p.is_file()}

    config = json.loads((src / "configs"
                         / "libstevi_vga_zncc_sgm8_d120.json").read_text())
    config.update(name="tiny_vga", height=40, width=160)
    (tmp_path / "stevi_bench" / "configs" / "tiny_vga.json").write_text(
        json.dumps(config))
    (tmp_path / "stevi_bench" / "traffic" / "pairs2.json").write_text(
        json.dumps({"in_flight": 2,
                    "scene": {"pool": 2, "planes": 4, "noise": 0.01},
                    "trace_seconds": 0.2}))
    (tmp_path / "stevi_bench" / "metrics" / "latency_ms_max.py").write_text(
        "def read(run):\n"
        "    return 1e3 * max(run.window.latencies)\n")
    bench["configs"].append({"name": "tiny_vga", "source": "test",
                             "file": "stevi_bench/configs/tiny_vga.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.pairs2", "config": "tiny_vga",
                               "traffic": "pairs2", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "latency_ms_max", "unit": "ms",
                                "better": "lower", "bound": 0.25,
                                "source": "host_clock",
                                "workloads": ["tiny.pairs2"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = harness.load_cell(tmp_path, "tiny.pairs2")
    assert cell.config["height"] == 40 and cell.traffic["in_flight"] == 2
    line = harness.run(cell, 2 ** 31 + 9, 0.6, False, torch.device("cpu"))
    # the new metric, and setup_s, which every cell reports (peak memory
    # has no reading on the CPU)
    assert set(line["metrics"]) == {"latency_ms_max", "setup_s"}
    assert line["attempted"] >= 1 and line["correct"]
    assert list(line)[-1] == "checks"
    assert line["device"]["host_cpus"] >= 1
    assert set(line["setup_parts_s"]) == {"start", "pool", "warmup"}
    for p, data in before.items():
        assert p.read_bytes() == data, p
