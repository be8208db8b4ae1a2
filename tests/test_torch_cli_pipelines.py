"""The port's pipeline CLIs (`python -m libstevi_tpu_torch.cli.bg_fg_stereo`,
`.intrinsic_decomposition`, `.normal_map_estimation`) with ``--device cpu``
against the JAX package's root tools (`cli/*.py`) on `tests/test_cli.py`'s
scenes: the JSON reports and the written images."""

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libstevi_tpu_torch.cli import (bg_fg_stereo, intrinsic_decomposition,
                                    normal_map_estimation)
from libstevi_tpu_torch.io import read_image, write_image, write_stevimg

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]


def _root_main(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _report(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _bg_fg_files(tmp_path, seed=42):
    """`TestBgFgStereoCli`'s scene: 48x72, background at disparity 3, a
    textured 16x16 square at 9."""
    rng = np.random.default_rng(seed)
    H, W, d_bg, d_fg = 48, 72, 3, 9
    bg_r = rng.uniform(0.1, 1.0, (H, W)).astype(np.float32)
    bg_l = np.roll(bg_r, d_bg, axis=1)
    live_r = bg_r.copy()
    sq = rng.uniform(0.1, 1.0, (16, 16)).astype(np.float32)
    live_r[16:32, 24:40] = sq
    live_l = np.roll(live_r, d_bg, axis=1)
    live_l[16:32, 24 + d_fg:40 + d_fg] = sq
    paths = []
    for nm, img in (("bl", bg_l), ("br", bg_r), ("ll", live_l),
                    ("lr", live_r)):
        paths.append(str(tmp_path / f"{nm}.stevimg"))
        write_image(paths[-1], img)
    return paths


@pytest.mark.parametrize("argv", [[], ["-m", "zsad", "--radius", "2"]],
                         ids=["zncc", "zsad"])
def test_bg_fg_stereo_cli_matches_jax(argv, tmp_path, capsys):
    """The disparity and mask files equal (`array_equal`), the report's
    fg_fraction equal to its 4 decimals."""
    paths = _bg_fg_files(tmp_path)
    outs = {}
    for tag, main, extra in (("j", _root_main("bg_fg_stereo"), []),
                             ("t", bg_fg_stereo.main, ["--device", "cpu"])):
        files = [str(tmp_path / f"{tag}_disp.stevimg"),
                 str(tmp_path / f"{tag}_mask.stevimg")]
        assert main(paths + ["-d", "16", "-o", files[0], "--mask-out",
                             files[1]] + argv + extra) == 0
        outs[tag] = (_report(capsys), [read_image(f) for f in files])
    (rj, (dj, mj)), (rt, (dt, mt)) = outs["j"], outs["t"]
    assert list(rt) == list(rj) == ["output", "fg_fraction"]
    assert rt["fg_fraction"] == rj["fg_fraction"]
    assert 0.0 < rt["fg_fraction"] < 0.5
    assert dt.dtype == dj.dtype == np.float32
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_array_equal(mt, mj)


def _dome_file(tmp_path, H=40, W=40):
    """`TestNormalMapCli`'s dome (40x40, light (0.3, 0.1, 0.95))."""
    ii, jj = np.mgrid[0:H, 0:W].astype(np.float64)
    R = H * 1.2
    z = np.sqrt(np.maximum(R * R - (ii - H / 2) ** 2 - (jj - W / 2) ** 2,
                           1e-6))
    n = np.stack([(jj - W / 2) / R, (ii - H / 2) / R, z / R], -1)
    light = np.asarray([0.3, 0.1, 0.95])
    light /= np.linalg.norm(light)
    img = np.clip(n @ light / light[2], 0, 1).astype(np.float32)
    p = str(tmp_path / "dome.stevimg")
    write_stevimg(p, img)
    return p, light


@pytest.mark.parametrize("case", ["known_light", "estimated_light"])
def test_normal_map_estimation_cli_matches_jax(case, tmp_path, capsys):
    """At the tool's default 30 Gauss-Newton steps: the normals within
    1e-3, the flattened height within 1e-2 of its range; the report's
    light within 1e-5 and its mean_up and height_range at those bars.
    (The JAX test's 10 steps do not serve: where the dome's shading is
    clipped to 1 the FFT retinex leaves gradients of rounding noise, so
    the initial estimate picks its roots from that noise, differently in
    the two packages, and 10 steps leave up to 6e-3 of it.)"""
    p, light = _dome_file(tmp_path)
    argv = ["--n-iter", "30"]
    if case == "known_light":
        argv += ["--light", *(str(v) for v in light)]
    outs = {}
    for tag, main, extra in (("j", _root_main("normal_map_estimation"), []),
                             ("t", normal_map_estimation.main,
                              ["--device", "cpu"])):
        files = [str(tmp_path / f"{tag}_n.stevimg"),
                 str(tmp_path / f"{tag}_h.stevimg")]
        assert main([p, "-o", files[0], "--height", files[1]] + argv
                    + extra) == 0
        outs[tag] = (_report(capsys), [read_image(f) for f in files])
    (rj, (nj, hj)), (rt, (nt, ht)) = outs["j"], outs["t"]
    assert list(rt) == list(rj) and rt["shape"] == rj["shape"] == [40, 40, 3]
    np.testing.assert_allclose(rt["light"], rj["light"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(nt, nj, rtol=0, atol=1e-3)
    span = np.ptp(hj)
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-2 * span)
    assert abs(rt["mean_up"] - rj["mean_up"]) <= 1e-3
    assert abs(rt["height_range"] - rj["height_range"]) <= 1e-2 * span
    assert rt["mean_up"] > 0.6


def test_normal_map_chain_recovers_the_dome():
    """`normal_map_chain` on `chip_smoke.render_dome`'s shallow cap (48x80,
    light (0.3, 0.1, 0.95), shading clipped to [0, 1]): the median angle of
    its normals to the true ones, where the shading is below 0.999, is
    under `chip_smoke.NORMAL_TRUTH_BAR` (18 degrees); the initial estimate
    (no Gauss-Newton step) is not, so the bar tells a solve from none."""
    H, W = 48, 80
    ii, jj = np.mgrid[0:H, 0:W].astype(np.float64)
    R = 1.2 * H
    z = np.sqrt(np.maximum(R * R - (ii - H / 2) ** 2 - (jj - W / 2) ** 2,
                           1e-6))
    n_true = np.stack([(jj - W / 2) / R, (ii - H / 2) / R, z / R], -1)
    lhat = np.asarray([0.3, 0.1, 0.95]) / np.linalg.norm([0.3, 0.1, 0.95])
    dome = np.clip(n_true @ lhat, 0, 1).astype(np.float32)
    keep = dome < 0.999

    def median_angle(n_iter):
        n = normal_map_estimation.normal_map_chain(
            torch.from_numpy(dome), n_iter=n_iter)[0].double().numpy()
        cos = (n * n_true).sum(-1) / np.linalg.norm(n, axis=-1)
        return float(np.median(np.degrees(np.arccos(
            np.clip(cos, -1, 1)))[keep]))

    assert median_angle(30) <= 18.0 < median_angle(0)


@pytest.mark.parametrize("case", ["rgb", "gray"])
def test_intrinsic_decomposition_cli_matches_jax(case, tmp_path, capsys):
    """`TestIntrinsicCli`'s 20x20 RGB blocks under a ramp through the
    non-local retinex (shading within rtol 1e-3, R * S = the image within
    1e-4), and its gray mean through the FFT retinex (the L0 bar)."""
    rng = np.random.default_rng(42)
    refl = np.kron(rng.uniform(0.3, 1.0, (3, 3, 3)),
                   np.ones((8, 8, 1)))[:20, :20]
    sh = np.linspace(0.4, 1.0, 20, dtype=np.float32)[None, :, None]
    img = (refl * sh).astype(np.float32)
    if case == "gray":
        img = img.mean(-1)
    p = str(tmp_path / "img.stevimg")
    write_stevimg(p, img)
    outs = {}
    for tag, main, extra in (("j", _root_main("intrinsic_decomposition"), []),
                             ("t", intrinsic_decomposition.main,
                              ["--device", "cpu"])):
        files = [str(tmp_path / f"{tag}_r.stevimg"),
                 str(tmp_path / f"{tag}_s.stevimg")]
        assert main([p, "--reflectance", files[0], "--shading", files[1]]
                    + extra) == 0
        outs[tag] = (_report(capsys), [read_image(f) for f in files])
    (rj, (Rj, Sj)), (rt, (Rt, St)) = outs["j"], outs["t"]
    assert list(rt) == list(rj)
    assert rt["shading_shape"] == rj["shading_shape"]
    assert rt["reflectance_shape"] == rj["reflectance_shape"]
    if case == "rgb":
        np.testing.assert_allclose(St, Sj, rtol=1e-3)
        np.testing.assert_allclose(Rt * St, img, atol=1e-4)
        np.testing.assert_allclose(rt["shading_range"], rj["shading_range"],
                                   rtol=1e-3)
    else:
        for g, w in ((St, Sj), (Rt, Rj)):
            assert np.isclose(g, w, rtol=0, atol=1e-3).mean() >= 0.99


def test_pipeline_clis_refuse_a_missing_gpu_and_run_on_the_cpu(tmp_path,
                                                               capsys):
    """Without a GPU the default ``--device cuda`` is refused with exit 2;
    with ``--device cpu`` each runs (the RGB tool with ``--auto``), and
    ``python -m libstevi_tpu_torch.cli.bg_fg_stereo`` as a module."""
    paths = _bg_fg_files(tmp_path)
    dome, _ = _dome_file(tmp_path, 24, 24)
    rgb = str(tmp_path / "rgb.stevimg")
    write_stevimg(rgb, np.random.default_rng(1).uniform(
        0.2, 1, (12, 12, 3)).astype(np.float32))
    runs = ((bg_fg_stereo.main, paths + ["-d", "12", "-o",
                                         str(tmp_path / "d.stevimg")]),
            (normal_map_estimation.main, [dome, "--n-iter", "3"]),
            (intrinsic_decomposition.main, [rgb, "--auto"]))
    if not torch.cuda.is_available():
        for main, argv in runs:
            with pytest.raises(SystemExit) as e:
                main(argv)
            assert e.value.code == 2
    reports = []
    for main, argv in runs:
        assert main(argv + ["--device", "cpu"]) == 0
        reports.append(_report(capsys))
    assert 0 < reports[0]["fg_fraction"] < 0.5
    assert reports[1]["shape"] == [24, 24, 3]
    assert reports[2]["shading_shape"] == [12, 12, 3]
    res = subprocess.run(
        [sys.executable, "-m", "libstevi_tpu_torch.cli.bg_fg_stereo",
         *runs[0][1], "--device", "cpu"], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == reports[0]
