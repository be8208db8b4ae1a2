"""The KITTI 2015 census configuration (`entry.KITTI_CENSUS`,
`entry.kitti_census_forward`) against the benchmark's plain reference
(`stevi_bench/reference/census_sgm.py`) at small sizes on the CPU, within
the limits of `stevi_bench/configs/kitti2015_census_sgm8_d192.json`; the
float8 e4m3 control outside them; the census stage's span and counters."""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.ops import dense_sgm_stereo
from libstevi_tpu_torch.utils.profiling import counters, reset_counters
from stevi_bench import check, harness, scenes
from stevi_bench.reference import census_sgm

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "stevi_bench" / "configs"
                     / "kitti2015_census_sgm8_d192.json").read_text())
WORKLOAD = "kitti2015_d192.stream"


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()


def _pool(H, W, D, seed, n=2):
    """``n`` pairs of the benchmark's scenes (12 planes, noise 0.01)."""
    return scenes.make_pool(H, W, D, seed, n, 12, 0.01, torch.device("cpu"))


def _held(program, reference):
    numbers = check.compare(program, reference)
    return check.judge(numbers, CONFIG["check"]["limits"])


def test_entry_is_the_configuration():
    assert (entry.KITTI_HEIGHT, entry.KITTI_WIDTH) == (CONFIG["height"],
                                                       CONFIG["width"])
    k = entry.KITTI_CENSUS
    assert k["disp_width"] == CONFIG["disp_width"]
    assert (k["h_radius"], k["v_radius"]) == (CONFIG["h_radius"],
                                              CONFIG["v_radius"])
    assert (k["P1"], k["P2"], k["n_directions"], k["cost_vol_radius"]) == (
        CONFIG["P1"], CONFIG["P2"], CONFIG["n_directions"],
        CONFIG["cost_vol_radius"])
    assert k["cv_dtype"] == getattr(torch, CONFIG["volume_dtype"])
    assert dense_sgm_stereo.__kwdefaults__["Pout"] == CONFIG["Pout"]
    assert harness.resolve(CONFIG["program"]) is entry.kitti_census_forward


@pytest.mark.parametrize("H,W,D,seed,route", [
    (48, 96, 24, 2 ** 31 + 11, "scan"),     # K2 / K3's plain versions
    (10, 352, 336, 2 ** 32 + 5, "lane"),    # past D = 320: K4b's
])
def test_configuration_holds_to_the_reference(H, W, D, seed, route):
    cfg = dict(CONFIG, height=H, width=W, disp_width=D)
    pool = _pool(H, W, D, seed)
    left = torch.stack([p[0] for p in pool])
    right = torch.stack([p[1] for p in pool])
    ref = census_sgm.disparity(left, right, cfg)
    got = [dense_sgm_stereo(MatchingFunction.CENSUS, L, R,
                            **dict(entry.KITTI_CENSUS, disp_width=D))[0]
           for L, R in pool]
    assert counters()["route." + route] == len(pool)
    correct, checks = _held(got, list(ref))
    assert correct, checks


def test_entry_holds_to_the_reference_at_its_range():
    """`kitti_census_forward` itself (D = 192) on a narrow strip."""
    H, W = 12, 240
    cfg = dict(CONFIG, height=H, width=W)
    pool = _pool(H, W, CONFIG["disp_width"], 7, n=1)
    L, R = pool[0]
    got = entry.kitti_census_forward(L, R)
    assert got.shape == (H, W) and got.dtype == torch.float32
    ref = census_sgm.disparity(L[None], R[None], cfg)[0]
    correct, checks = _held([got], [ref])
    assert correct, checks


def test_float8_control_fails_the_limits():
    """The reference with its volume in float8 e4m3 (every cost above 16
    rounded), in the program's place, fails the cell's check at a size the
    CPU holds (the cell's D, 24 x 256 pixels, a pool of 4)."""
    cell = harness.load_cell(ROOT, WORKLOAD)
    cell.config.update(height=24, width=256)
    cell.traffic["scene"]["pool"] = 4
    cell.config["check"]["pairs"] = 4
    seed = 2 ** 31 + 5
    pool = harness.make_pool(cell, seed, torch.device("cpu"))
    pairs = harness.checked_pairs(cell, seed)
    exp = harness.reference_answers(cell, pool, pairs, torch.device("cpu"))
    low = harness.reference_answers(cell, pool, pairs, torch.device("cpu"),
                                    cell.config["check"]["control_dtype"])
    numbers = check.compare([low[p] for p in pairs], [exp[p] for p in pairs])
    correct, _ = check.judge(numbers, cell.config["check"]["limits"])
    assert not correct, numbers


def test_reference_is_plain():
    """The reference imports nothing of the program, nor JAX."""
    text = (ROOT / "stevi_bench" / "reference" / "census_sgm.py").read_text()
    for name in ("libstevi_tpu", "jax"):
        assert f"import {name}" not in text and f"from {name}" not in text


def _spans(prof):
    ev = sorted((e for e in prof.events() if e.name.startswith("stevi.")),
                key=lambda e: e.time_range.start)
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in ev]


def test_census_stage_draws_its_span_and_counts():
    L, R = _pool(16, 64, 16, 3, n=1)[0]
    cfg = dict(entry.KITTI_CENSUS, disp_width=16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        dense_sgm_stereo(MatchingFunction.CENSUS, L, R, **cfg)
    spans = _spans(prof)
    assert spans[0] == ("stevi.dense_sgm_stereo", None)
    assert spans[1:] == [(n, "stevi.dense_sgm_stereo") for n in
                         ("stevi.census", "stevi.route", "stevi.k2",
                          "stevi.k3", "stevi.bands")]
    c = counters()
    assert c["spans.stevi.census"] == 1 and c["span_ns.stevi.census"] > 0
    assert c["route.scan"] == 1 and c["form.k2_accumulate"] == 1
    # the CPU runs the plain versions: no launch is counted
    assert not [k for k in c if k.startswith("launches.")]
