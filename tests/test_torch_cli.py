"""The port's `stereo_match` CLI (`python -m libstevi_tpu_torch.cli.stereo_match`)
with ``--device cpu`` against the JAX package's `cli/stereo_match.py` on the
96x128 parity fixtures: the written disparity files and the JSON report."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libstevi_tpu_torch.cli import stereo_match
from libstevi_tpu_torch.io import read_image

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data" / "parity"
KEYS = ["matcher", "match_func", "disp_width", "time_s", "output",
        "prop_good_2.0", "inlier_mae"]

CASES = {
    "sgm8": ["--matcher", "sgm", "--refine", "parabola"],
    "sgm16": ["--matcher", "sgm", "--sgm-dirs", "16", "--refine",
              "parabola"],
    "sgm_census": ["--matcher", "sgm", "-m", "census", "--sgm-p1", "1",
                   "--sgm-p2", "4"],
    "wta": ["--matcher", "wta", "--refine", "parabola"],
    "patchmatch": ["--matcher", "patchmatch", "-m", "ncc"],
    "hierarchical": ["--matcher", "hierarchical"],
    "hierarchical_parabola": ["--matcher", "hierarchical", "--refine",
                              "parabola"],
}


def _jax_main():
    spec = importlib.util.spec_from_file_location(
        "jax_stereo_match", REPO / "cli" / "stereo_match.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _run(main, argv, out, capsys):
    assert main([str(DATA / "left_small.stevimg"),
                 str(DATA / "right_small.stevimg"), "-o", str(out), "-d",
                 "24", "--gt", str(DATA / "gt_small.stevimg"), *argv]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return report, read_image(str(out))


@pytest.mark.parametrize("case", CASES)
def test_cli_matches_jax(case, tmp_path, capsys):
    argv = CASES[case]
    rj, dj = _run(_jax_main(), argv, tmp_path / "j.stevimg", capsys)
    rt, dt = _run(stereo_match.main, argv + ["--device", "cpu"],
                  tmp_path / "t.stevimg", capsys)
    assert list(rt) == list(rj) == KEYS
    for k in ("matcher", "match_func", "disp_width"):
        assert rt[k] == rj[k]
    assert dt.shape == dj.shape == (96, 128) and dt.dtype == np.float32
    if case == "patchmatch":
        # torch's candidate stream is not jax.random's: the fields agree
        # where the search has converged, and the accuracy is close
        assert (dt == dj).mean() > 0.9
        assert abs(rt["prop_good_2.0"] - rj["prop_good_2.0"]) < 0.02
        return
    # the volumes and SGM sums agree to ~1e-5 (another summation order);
    # the parabola divides such band differences by curvatures down to
    # ~1e-2 on these smooth images, so refined disparities agree to 1e-2 px
    close = np.isclose(dt, dj, rtol=0.0, atol=1e-2, equal_nan=True)
    assert close.mean() > 0.99, close.mean()
    assert abs(rt["prop_good_2.0"] - rj["prop_good_2.0"]) <= 2e-3
    assert abs(rt["inlier_mae"] - rj["inlier_mae"]) <= 5e-3


def test_cli_refuses_a_missing_gpu_and_the_hierarchical_matcher(tmp_path):
    """Without a GPU the default ``--device cuda`` is refused for every
    matcher, the hierarchical one too (never a silent CPU run); on the CPU
    the hierarchical matcher runs (it raised before it was ported)."""
    args = [str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg"),
            "-o", str(tmp_path / "d.stevimg"), "-d", "8"]
    if not torch.cuda.is_available():
        for extra in ([], ["--matcher", "hierarchical"]):
            with pytest.raises(SystemExit) as e:
                stereo_match.main(args + extra)  # --device cuda by default
            assert e.value.code == 2
            assert not (tmp_path / "d.stevimg").exists()
    assert stereo_match.main(args + ["--matcher", "hierarchical", "--device",
                                     "cpu"]) == 0
    assert read_image(str(tmp_path / "d.stevimg")).shape == (96, 128)


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "d.stevimg"
    res = subprocess.run(
        [sys.executable, "-m", "libstevi_tpu_torch.cli.stereo_match",
         str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg"),
         "-o", str(out), "-d", "12", "--matcher", "wta", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["output"] == str(out) and out.exists()
