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


# -- the refinement CLIs (`cli/stereo_refine.py`, `cli/optical_flow_refine.py`)

def _root_main(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [[], ["-m", "sad", "--methods",
                                       "barycentric-symmetric"]],
                         ids=["zncc", "sad"])
def test_stereo_refine_cli_matches_jax(argv, tmp_path, capsys):
    """`stereo_refine --device cpu` against the root tool on the 96x128
    fixtures (D = 24, r = 2): the same report keys, each method's mean and
    prop_good_1.0 within 1e-3 and inlier_mae within 1e-3, and the written
    disparities within 1e-3 on >= 0.99 of the pixels, every pixel within
    1 px (a tied WTA neighbour or another accepted candidate)."""
    from libstevi_tpu_torch.cli import stereo_refine
    args = [str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg"),
            "-d", "24", "-r", "2", "--gt", str(DATA / "gt_small.stevimg"),
            *argv]
    assert _root_main("stereo_refine")(
        args + ["-o", str(tmp_path / "j.stevimg")]) == 0
    rj = _report(capsys)
    assert stereo_refine.main(args + ["-o", str(tmp_path / "t.stevimg"),
                                      "--device", "cpu"]) == 0
    rt = _report(capsys)
    assert list(rt) == list(rj)
    for m in rj:
        assert list(rt[m]) == list(rj[m]) == ["mean", "inlier_mae",
                                              "prop_good_1.0"]
        for k in rj[m]:
            assert abs(rt[m][k] - rj[m][k]) <= 1e-3, (m, k, rt[m], rj[m])
    dt = read_image(str(tmp_path / "t.stevimg"))
    dj = read_image(str(tmp_path / "j.stevimg"))
    assert dt.shape == dj.shape == (96, 128)
    assert np.isclose(dt, dj, rtol=0, atol=1e-3).mean() >= 0.99
    assert (np.abs(dt - dj) <= 1 + 1e-3).all()


def test_optical_flow_refine_cli_matches_jax(tmp_path, capsys):
    """`optical_flow_refine --device cpu` against the root tool on the
    96x128 fixtures over (-2..2)^2, with a .flo ground truth (the root
    tool's own flow, rounded): the report within 1e-3
    and the written flow within 0.1 px on >= 0.99 of its values, every
    one within 2 px.  The 9-column solves of the QUEEN neighbourhood on
    these smooth images have condition numbers up to ~1e4, where JAX's
    float32 SVD is itself off by ~eps * cond (the port solves in float64):
    ~4% of the values differ by 1e-3 to 1e-1 px."""
    from libstevi_tpu.io import write_flo as j_write_flo
    from libstevi_tpu_torch.cli import optical_flow_refine
    from libstevi_tpu_torch.io import read_flo
    args = [str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg"),
            "-s", "2"]
    jmain = _root_main("optical_flow_refine")
    assert jmain(args + ["-o", str(tmp_path / "g.flo")]) == 0
    capsys.readouterr()
    j_write_flo(str(tmp_path / "gt.flo"),
                np.round(read_flo(str(tmp_path / "g.flo"))))
    args += ["--gt", str(tmp_path / "gt.flo")]
    assert jmain(args + ["-o", str(tmp_path / "j.flo")]) == 0
    rj = _report(capsys)
    assert optical_flow_refine.main(args + ["-o", str(tmp_path / "t.flo"),
                                            "--device", "cpu"]) == 0
    rt = _report(capsys)
    assert list(rt) == list(rj) == ["shape", "mean_flow", "epe_mean",
                                    "inlier_epe", "prop_inlier"]
    assert rt["shape"] == rj["shape"] == [96, 128, 2]
    np.testing.assert_allclose(rt["mean_flow"], rj["mean_flow"], atol=1e-3)
    for k in ("epe_mean", "inlier_epe", "prop_inlier"):
        assert abs(rt[k] - rj[k]) <= 1e-3, (k, rt[k], rj[k])
    ft, fj = (read_flo(str(tmp_path / f)) for f in ("t.flo", "j.flo"))
    assert np.isclose(ft, fj, rtol=0, atol=0.1).mean() >= 0.99
    assert (np.abs(ft - fj) <= 2 + 1e-3).all()


def test_refine_clis_refuse_a_missing_gpu(tmp_path):
    """Without a GPU the default ``--device cuda`` is refused with exit 2,
    nothing written; ``python -m`` runs them."""
    from libstevi_tpu_torch.cli import optical_flow_refine, stereo_refine
    pair = [str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg")]
    if not torch.cuda.is_available():
        for main, out in ((stereo_refine.main, "d.stevimg"),
                          (optical_flow_refine.main, "f.flo")):
            with pytest.raises(SystemExit) as e:
                main(pair + ["-o", str(tmp_path / out)])
            assert e.value.code == 2
            assert not (tmp_path / out).exists()
    res = subprocess.run(
        [sys.executable, "-m", "libstevi_tpu_torch.cli.stereo_refine", *pair,
         "-d", "8", "--methods", "cost-symmetric", "-o",
         str(tmp_path / "r.stevimg"), "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert list(json.loads(res.stdout.strip().splitlines()[-1])) == \
        ["cost-symmetric"]
    assert read_image(str(tmp_path / "r.stevimg")).shape == (96, 128)


@pytest.mark.parametrize("solver", ["gauss-newton", "relaxed"])
def test_ray_alignment_eval_cli_matches_jax(solver, capsys):
    """`ray_alignment_eval --device cpu` against the root tool at the same
    seed (4 trials of 60 rays, noise 0.002, 10% outliers): the same
    report keys and each median and p90 within 1e-4 relative (the same
    numpy data and the same float32 solver).  The robust solver draws
    from torch, not JAX's keys, so it is compared on the card at the
    JAX tool's order of error (`chip_smoke.py`)."""
    from libstevi_tpu_torch.cli import ray_alignment_eval
    argv = ["-n", "4", "--rays", "60", "--noise", "0.002", "--outliers",
            "0.1", "--solvers", solver, "--seed", "3"]
    assert _root_main("ray_alignment_eval")(argv) == 0
    rj = _report(capsys)
    assert ray_alignment_eval.main(argv + ["--device", "cpu"]) == 0
    rt = _report(capsys)
    assert list(rt) == list(rj) == [solver]
    assert list(rt[solver]) == list(rj[solver]) == [
        "rot_deg_median", "trans_median", "rot_deg_p90"]
    for k, v in rj[solver].items():
        assert rt[solver][k] == pytest.approx(v, rel=1e-4, abs=1e-6), k


def test_ray_alignment_eval_cli_refuses_a_missing_gpu():
    """Without a GPU the default ``--device cuda`` is refused with exit 2;
    ``python -m`` runs the robust solver on the CPU."""
    from libstevi_tpu_torch.cli import ray_alignment_eval
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as e:
            ray_alignment_eval.main(["-n", "1"])
        assert e.value.code == 2
    res = subprocess.run(
        [sys.executable, "-m", "libstevi_tpu_torch.cli.ray_alignment_eval",
         "-n", "1", "--rays", "30", "--solvers", "robust", "--device", "cpu"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["robust"]["rot_deg_median"] < 1.0


# -- the sparse and calibration CLIs (`cli/tie_points.py`,
# `cli/detect_checkerboard.py`)

def _json_out(capsys):
    """The JSON object a tool printed last (``tie_points`` indents it)."""
    lines = capsys.readouterr().out.strip().splitlines()
    start = max(i for i, line in enumerate(lines) if line.startswith("{"))
    return json.loads("\n".join(lines[start:]))


@pytest.mark.parametrize("argv", [
    ["-n", "96"], ["-n", "96", "--descriptor", "oriented"],
    ["-n", "96", "--f", "120"], ["-n", "96", "--f", "120", "--detector",
                                 "fast"]], ids=["whitened", "oriented",
                                                "pose", "fast_empty"])
def test_tie_points_cli_matches_jax(argv, tmp_path, capsys):
    """`tie_points --device cpu` against the root tool on the 96x128
    parity pair: the counts and the match pairs equal (FAST finds no left
    corner: 0 / 9 / 0, no pose).  With ``--f`` the port's RANSAC draws
    come from torch (seed 3), not JAX's keys, so the pose keys are
    compared, and the inliers against the JAX draws in
    `tests/test_torch_sparse.py`."""
    from libstevi_tpu_torch.cli import tie_points
    pair = [str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg")]
    assert _root_main("tie_points")(pair + argv + [
        "-o", str(tmp_path / "j.json")]) == 0
    rj = _json_out(capsys)
    assert tie_points.main(pair + argv + ["-o", str(tmp_path / "t.json"),
                                          "--device", "cpu"]) == 0
    rt = _json_out(capsys)
    assert list(rt) == list(rj)
    for k in ("n_left", "n_right", "n_matches"):
        assert rt[k] == rj[k], k
    mj, mt = (json.loads((tmp_path / f).read_text())["matches"]
              for f in ("j.json", "t.json"))
    np.testing.assert_array_equal(np.asarray(mt, np.float32),
                                  np.asarray(mj, np.float32))
    if "n_inliers" in rj:
        assert rt["n_inliers"] >= 8 and np.asarray(rt["rotation"]).shape \
            == (3, 3)


def test_detect_checkerboard_cli_matches_jax(tmp_path, capsys):
    """`detect_checkerboard --device cpu` against the root tool on
    TestCheckerboard's rotated board written as a .stevimg: the report
    equal, the corners within 1e-3 px."""
    import test_imageproc_pipelines as pipelines
    from libstevi_tpu_torch.cli import detect_checkerboard
    from libstevi_tpu_torch.io import write_image
    img, _ = pipelines.TestCheckerboard._render(theta=0.3,
                                                persp=(0.01, 0.005))
    path = str(tmp_path / "board.stevimg")
    write_image(path, img)
    assert _root_main("detect_checkerboard")(
        [path, "-o", str(tmp_path / "j.json")]) == 0
    rj = _json_out(capsys)
    assert detect_checkerboard.main(
        [path, "-o", str(tmp_path / "t.json"), "--device", "cpu"]) == 0
    rt = _json_out(capsys)
    assert rt == rj and rt["found"] and rt["n_points"] >= 35
    cj, ct = (np.asarray(json.loads((tmp_path / f).read_text())["corners"],
                         np.float64) for f in ("j.json", "t.json"))
    np.testing.assert_allclose(ct, cj, rtol=0, atol=1e-3, equal_nan=True)


def test_sparse_clis_refuse_a_missing_gpu(tmp_path):
    """Without a GPU the default ``--device cuda`` is refused with exit 2;
    ``python -m`` runs them on the CPU."""
    import test_imageproc_pipelines as pipelines
    from libstevi_tpu_torch.cli import detect_checkerboard, tie_points
    from libstevi_tpu_torch.io import write_image
    pair = [str(DATA / "left_small.stevimg"), str(DATA / "right_small.stevimg")]
    if not torch.cuda.is_available():
        for main, argv in ((tie_points.main, pair),
                           (detect_checkerboard.main, pair[:1])):
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
    board = str(tmp_path / "board.stevimg")
    write_image(board, pipelines.TestCheckerboard._render()[0])
    reports = []
    for argv in (["tie_points", *pair, "-n", "32"],
                 ["detect_checkerboard", board]):
        res = subprocess.run(
            [sys.executable, "-m", f"libstevi_tpu_torch.cli.{argv[0]}",
             *argv[1:], "--device", "cpu"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr
        reports.append(json.loads(res.stdout[res.stdout.index("{"):]))
    assert 0 < reports[0]["n_matches"] <= 32
    assert reports[1] == {"found": True, "rows": 7, "cols": 9,
                          "n_points": 63}
