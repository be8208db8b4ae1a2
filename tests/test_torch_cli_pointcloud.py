"""The port's point-cloud and viewer CLIs (`python -m
libstevi_tpu_torch.cli.io_pointcloud`, `.split_pt_cloud`,
`.points_cloud2depth_map`, `.detrend_terrain`, `.stevimg_viewer`) with
``--device cpu`` where they take one, against the JAX package's root tools
(`cli/*.py`) on `tests/test_cli.py`'s scenes: the JSON reports equal and
the written files equal byte for byte, or within the tolerance stated.
Also the projection's float -> int32 cast: a far off-axis point and a NaN
never land in the image."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from libstevi_tpu_torch.cli import (detrend_terrain, io_pointcloud,
                                    points_cloud2depth_map, split_pt_cloud,
                                    stevimg_viewer)
from libstevi_tpu_torch.io import (PointCloud, open_point_cloud, read_image,
                                   save_point_cloud, write_stevimg)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]


def _root_main(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", REPO / "cli" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _report(capsys):
    lines = capsys.readouterr().out.strip().splitlines()
    start = max(i for i, l in enumerate(lines) if l.startswith("{"))
    return json.loads("\n".join(lines[start:]))


def _both(name, port_main, argv_of, capsys, port_extra=()):
    """Run the root tool and the port's with ``argv_of(tag)``; returns
    the two reports."""
    reports = {}
    for tag, main, extra in (("j", _root_main(name), []),
                             ("t", port_main, list(port_extra))):
        assert main(argv_of(tag) + extra) in (0, None)
        reports[tag] = _report(capsys)
    return reports["j"], reports["t"]


def _same_bytes(a, b):
    assert Path(a).read_bytes() == Path(b).read_bytes(), (a, b)


def _cloud(rng, n=200):
    return PointCloud(rng.uniform(-10, 10, (n, 3)),
                      {"intensity": rng.integers(0, 100, n).astype(np.uint16),
                       "gps_time": rng.uniform(0, 1, n)})


# -- io_pointcloud -----------------------------------------------------------

@pytest.mark.parametrize("dst", ["b.pcd", "b.las", "b.sdc", "b.metacloud"])
def test_io_pointcloud_info_and_convert(dst, rng, tmp_path, capsys):
    """`info` of the LAS source and `convert --drop --rename` into each
    codec: equal reports, equal files."""
    src = str(tmp_path / "a.las")
    save_point_cloud(src, _cloud(rng))
    rj, rt = _both("io_pointcloud", io_pointcloud.main,
                   lambda tag: ["info", src, "--chunk", "64"], capsys)
    assert rt == rj and rt["n_points"] == 200
    assert rt["format"].startswith("LAS")
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    rj, rt = _both("io_pointcloud", io_pointcloud.main,
                   lambda tag: ["convert", src, str(tmp_path / tag / dst),
                                "--drop", "gps_time",
                                "--rename", "intensity=amp"], capsys)
    assert rt == {**rj, "written": str(tmp_path / "t" / dst)}
    assert "amp" in rt["attributes"] and "gps_time" not in rt["attributes"]
    for f in (tmp_path / "j").iterdir():
        _same_bytes(f, tmp_path / "t" / f.name)
    back = open_point_cloud(str(tmp_path / "t" / dst))
    np.testing.assert_allclose(back.positions,
                               open_point_cloud(src).positions, atol=1e-3)


def test_io_pointcloud_las_pcd_compressed_las(rng, tmp_path, capsys):
    """LAS -> PCD binary_compressed (LZF) -> LAS keeps the cloud: the
    compressed file and the LAS written back equal the JAX tool's."""
    from libstevi_tpu_torch.io import write_pcd
    src = str(tmp_path / "a.las")
    cloud = _cloud(rng, 500)
    save_point_cloud(src, cloud)
    write_pcd(str(tmp_path / "c.pcd"), open_point_cloud(src),
              compressed=True)
    rj, rt = _both("io_pointcloud", io_pointcloud.main,
                   lambda tag: ["convert", str(tmp_path / "c.pcd"),
                                str(tmp_path / f"{tag}.las")], capsys)
    assert rt["n_points"] == rj["n_points"] == 500
    _same_bytes(tmp_path / "j.las", tmp_path / "t.las")
    back = open_point_cloud(str(tmp_path / "t.las"))
    np.testing.assert_array_equal(back.attributes["intensity"],
                                  cloud.attributes["intensity"])
    np.testing.assert_allclose(back.positions, cloud.positions, atol=1e-3)


@pytest.mark.parametrize("only_keep", [False, True])
def test_io_pointcloud_map(only_keep, rng, tmp_path, capsys):
    n = 50
    pos = rng.uniform(-10, 10, (n, 3))
    src = str(tmp_path / "a.las")
    save_point_cloud(src, PointCloud(pos, {
        "intensity": rng.integers(0, 100, n).astype(np.uint16),
        "user_data": rng.integers(0, 9, n).astype(np.uint8)}))
    rj, rt = _both("io_pointcloud", io_pointcloud.main,
                   lambda tag: ["map", src, str(tmp_path / f"{tag}.las"),
                                "--map", "x=y", "y=x", "z=newZ",
                                "intensity=amp"]
                   + (["--only-keep"] if only_keep else []), capsys)
    assert rt == {**rj, "written": str(tmp_path / "t.las")}
    assert ("user_data" in rt["attributes"]) != only_keep
    _same_bytes(tmp_path / "j.las", tmp_path / "t.las")
    g0 = rt["first_point_before"]["geometry"]
    g1 = rt["first_point_after"]["geometry"]
    assert abs(g1[0] - g0[1]) < 1e-3 and g1[2] == 0.0
    back = open_point_cloud(str(tmp_path / "t.las"))
    np.testing.assert_allclose(back.attributes["newZ"], pos[:, 2],
                               atol=1e-3)


# -- split_pt_cloud ----------------------------------------------------------

@pytest.mark.parametrize("grid,context,fmt", [
    (("2", "2"), "10", None), (("3", "1"), "0", "pcd")])
def test_split_pt_cloud(grid, context, fmt, rng, tmp_path, capsys):
    """Equal reports (up to the prefix) and tiles; the tiles' own points
    partition the cloud."""
    pos = rng.uniform(0, 100, (400, 3))
    p = str(tmp_path / "cloud.las")
    save_point_cloud(p, PointCloud(pos, {"intensity": rng.uniform(
        0, 1, 400).astype(np.float32)}))
    rj, rt = _both("split_pt_cloud", split_pt_cloud.main,
                   lambda tag: [p, "-o", str(tmp_path / tag), "-n", *grid,
                                "-c", context]
                   + (["--format", fmt] if fmt else []), capsys)
    assert json.dumps(rt).replace(str(tmp_path / "t"), "P") \
        == json.dumps(rj).replace(str(tmp_path / "j"), "P")
    assert sum(t["n_own"] for t in rt["tiles"]) == 400
    own = []
    for tj, tt in zip(rj["tiles"], rt["tiles"]):
        _same_bytes(tj["path"], tt["path"])
        tile = open_point_cloud(tt["path"])
        assert tile.n_points == tt["n_own"] + tt["n_context"]
        own.append(tile.attributes["intensity"][
            tile.attributes["is_context"] == 0])
    np.testing.assert_array_equal(
        np.sort(np.concatenate(own)),
        np.sort(open_point_cloud(p).attributes["intensity"]))


# -- points_cloud2depth_map --------------------------------------------------

def _plane(tmp_path, rng, tilt=0.0):
    """`TestDepthMapCli`'s fronto-parallel plane at z = 5 (80 x 60
    points), optionally with a random height jitter."""
    g = np.stack(np.meshgrid(np.linspace(-2, 2, 80),
                             np.linspace(-1.5, 1.5, 60), indexing="xy"),
                 -1).reshape(-1, 2)
    z = 5.0 + tilt * rng.uniform(size=(len(g), 1))
    src = str(tmp_path / "plane.las")
    save_point_cloud(src, PointCloud(np.concatenate([g, z], -1), {}))
    return src


@pytest.mark.parametrize("inpaint", [False, True])
def test_depth_map_equals_jax_tool(inpaint, rng, tmp_path, capsys):
    """The plane seen head on: the report and the depth map equal the JAX
    tool's bit for bit (no rotation, so the transform is exact in both)."""
    src = _plane(tmp_path, rng)
    rj, rt = _both("points_cloud2depth_map", points_cloud2depth_map.main,
                   lambda tag: [src, str(tmp_path / f"{tag}.stevimg"),
                                "--size", "48", "64", "--f", "60"]
                   + (["--inpaint"] if inpaint else []), capsys, CPU)
    assert rt == {**rj, "written": str(tmp_path / "t.stevimg")}
    assert rt["coverage"] > 0.5
    _same_bytes(tmp_path / "j.stevimg", tmp_path / "t.stevimg")
    depth = read_image(str(tmp_path / "t.stevimg"))
    if inpaint:
        np.testing.assert_allclose(depth[20:28, 28:36], 5.0, atol=0.05)


def test_depth_map_rotated_within_tolerance(rng, tmp_path, capsys):
    """A rotated, translated view of a jittered plane: the coverage equals
    the JAX tool's and the inpainted maps agree within 1e-5 m on >= 0.99
    of the pixels (the two rotation matrices differ by ulps, so a point
    on a pixel's edge can land one pixel over)."""
    src = _plane(tmp_path, rng, tilt=0.3)
    rj, rt = _both("points_cloud2depth_map", points_cloud2depth_map.main,
                   lambda tag: [src, str(tmp_path / f"{tag}.stevimg"),
                                "--size", "48", "64", "--f", "60",
                                "--pp", "30", "25", "--rvec", "0.1", "0.2",
                                "0.05", "--t", "0.2", "-0.1", "0.5",
                                "--inpaint"], capsys, CPU)
    assert rt["coverage"] == rj["coverage"]
    dj = read_image(str(tmp_path / "j.stevimg"))
    dt = read_image(str(tmp_path / "t.stevimg"))
    assert (np.abs(dt - dj) <= 1e-5).mean() >= 0.99


def test_projection_cast_never_wraps():
    """Points just in front of the camera and far off-axis (u ~ 3e9, past
    int32) and NaN points land nowhere; in-range points land where the
    JAX tool's arithmetic puts them."""
    H, W, f = 6, 8, 1e3
    pts = torch.tensor([[0.0, 0.0, 2.0],            # the centre pixel
                        [-1.0, 0.5, 3.0],           # off-centre, inside
                        [3e3, 0.0, 1e-3],           # u ~ 3e9
                        [-3e3, -3e3, 1e-3],         # u, v ~ -3e9
                        [1e30, 1e30, 1.0],          # u, v ~ 1e33
                        [float("nan"), 0.0, 1.0],   # NaN
                        [0.0, float("nan"), 1.0],
                        [0.0, 0.0, float("nan")],
                        [0.0, 0.0, -1.0]])          # behind the camera
    depth, cov = points_cloud2depth_map.project_depth(
        pts, (H, W), 1.0, rvec=(0.0, 0.0, 0.0))
    assert torch.isfinite(depth).sum().item() == 1
    assert depth[H // 2, W // 2].item() == 2.0
    assert cov.item() == np.float32(1 / (H * W))
    depth, _ = points_cloud2depth_map.project_depth(
        pts, (H, W), f, pp=(4.0, 3.0))
    assert torch.isfinite(depth).sum().item() == 1
    # -1 / 3 * 1000 + 4 is off the image: only the centre point lands
    assert depth[3, 4].item() == 2.0


def test_projection_rounds_half_to_even():
    """u = 2.5 and 3.5 round to 2 and 4 (as `jnp.round`)."""
    pts = torch.tensor([[0.5, 0.0, 1.0], [1.5, 0.0, 1.0]])
    depth, _ = points_cloud2depth_map.project_depth(pts, (1, 8), 1.0,
                                                    pp=(2.0, 0.0))
    assert torch.isfinite(depth[0]).nonzero().flatten().tolist() == [2, 4]


# -- detrend_terrain ---------------------------------------------------------

def _terrain_cloud(tmp_path, rng, n=600, dense=False):
    """`TestDetrendCli`'s sloped terrain with 30% raised points; ``dense``
    fills every tile (the no-empty-tile branch)."""
    if dense:
        xy = np.stack(np.meshgrid(np.arange(0.5, 50, 1.0),
                                  np.arange(0.5, 50, 1.0)), -1).reshape(-1, 2)
        n = len(xy)
    else:
        xy = rng.uniform(0, 50, (n, 2))
    ground = 0.5 * xy[:, 0] + 0.2 * xy[:, 1]
    height = rng.uniform(0, 3, n) * (rng.random(n) < 0.3)
    p = str(tmp_path / "c.las")
    save_point_cloud(p, PointCloud(
        np.column_stack([xy, ground + height]),
        {"intensity": np.arange(n, dtype=np.uint16)}))
    return p


@pytest.mark.parametrize("dense", [False, True])
def test_detrend_unsmoothed_equals_jax_tool(dense, rng, tmp_path, capsys):
    """``--smooth 0``: the min-z raster, the nearest fill and the
    subtraction are exact, so the report and the file equal the JAX
    tool's."""
    p = _terrain_cloud(tmp_path, rng, dense=dense)
    rj, rt = _both("detrend_terrain", detrend_terrain.main,
                   lambda tag: [p, "-o", str(tmp_path / f"{tag}.las"),
                                "--tile", "5", "--smooth", "0"], capsys, CPU)
    assert rt == rj
    _same_bytes(tmp_path / "j.las", tmp_path / "t.las")
    z = open_point_cloud(str(tmp_path / "t.las")).positions[:, 2]
    assert z.max() < 8.0 and np.median(np.abs(z)) < 3.0


def test_detrend_smoothed_within_tolerance(rng, tmp_path, capsys):
    """``--smooth 1``: the two packages' blurs differ by rounding; the
    report within 1e-4 and the heights within 1e-4 (a LAS unit)."""
    p = _terrain_cloud(tmp_path, rng)
    rj, rt = _both("detrend_terrain", detrend_terrain.main,
                   lambda tag: [p, "-o", str(tmp_path / f"{tag}.las"),
                                "--tile", "4", "--smooth", "1"], capsys, CPU)
    assert rt["n_points"] == rj["n_points"] and rt["raster"] == rj["raster"]
    np.testing.assert_allclose(rt["terrain_range"], rj["terrain_range"],
                               atol=1e-4)
    np.testing.assert_allclose(rt["z_after"], rj["z_after"], atol=1e-4)
    a = open_point_cloud(str(tmp_path / "j.las"))
    b = open_point_cloud(str(tmp_path / "t.las"))
    np.testing.assert_allclose(b.positions, a.positions, atol=1.5e-4)
    np.testing.assert_array_equal(b.attributes["intensity"],
                                  a.attributes["intensity"])


def test_detrend_raster_dtypes(rng):
    """The raster is float64 and `np.minimum.at`'s bit for bit, the
    terrain float32, the detrended z float64."""
    pos = np.column_stack([rng.uniform(0, 30, (500, 2)),
                           rng.normal(size=500)])
    z, zmap, terrain = detrend_terrain.detrend(torch.from_numpy(pos), 5.0,
                                               1.0)
    assert zmap.dtype == z.dtype == torch.float64
    assert terrain.dtype == torch.float32
    gi = np.floor((pos[:, 0] - pos[:, 0].min()) / 5.0).astype(np.int64)
    gj = np.floor((pos[:, 1] - pos[:, 1].min()) / 5.0).astype(np.int64)
    want = np.full((gi.max() + 1, gj.max() + 1), np.inf)
    np.minimum.at(want, (gi, gj), pos[:, 2])
    np.testing.assert_array_equal(zmap.numpy(), want)
    np.testing.assert_array_equal(
        z.numpy(), pos[:, 2] - terrain.numpy()[gi, gj])


# -- stevimg_viewer ----------------------------------------------------------

@pytest.mark.parametrize("case", ["gray", "black_white", "rgb", "channel",
                                  "nan", "viridis"])
def test_stevimg_viewer(case, rng, tmp_path, capsys):
    """The report and the ``-o`` render equal the JAX tool's."""
    img = rng.uniform(0, 2, (16, 20)).astype(np.float32)
    argv = ["--colormap", "gray"]
    if case == "black_white":
        argv += ["--black", "0.5", "--white", "1.5"]
    elif case in ("rgb", "channel"):
        img = rng.uniform(0, 2, (16, 20, 3)).astype(np.float32)
        argv += ["--channel", "1"] if case == "channel" else []
    elif case == "nan":
        img[3, 4] = np.nan
    elif case == "viridis":
        argv = ["--colormap", "viridis"]
    p = str(tmp_path / "a.stevimg")
    write_stevimg(p, img)
    rj, rt = _both("stevimg_viewer", stevimg_viewer.main,
                   lambda tag: [p, "-o", str(tmp_path / f"{tag}.stevimg")]
                   + argv, capsys)
    assert rt == rj
    assert rt["shape"] == list(img.shape)
    assert rt["n_nonfinite"] == (1 if case == "nan" else 0)
    _same_bytes(tmp_path / "j.stevimg", tmp_path / "t.stevimg")
    view = read_image(str(tmp_path / "t.stevimg"))
    assert view.shape == (16, 20, 3) and view.dtype == np.uint8


def test_stevimg_viewer_interactive(rng, tmp_path, capsys, monkeypatch):
    """``--interactive`` opens the viewer (Agg: `show` returns at once)."""
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt
    from libstevi_tpu_torch.gui import viewer
    shown = []
    monkeypatch.setattr(viewer.InteractiveViewer, "show",
                        lambda self: shown.append(self.rgb().shape))
    p = str(tmp_path / "a.stevimg")
    write_stevimg(p, rng.uniform(0, 2, (8, 10)).astype(np.float32))
    assert stevimg_viewer.main([p, "--interactive", "--colormap",
                                "gray"]) == 0
    assert _report(capsys)["shape"] == [8, 10]
    assert shown == [(8, 10, 3)]
    plt.close("all")


_NO_JAX_RUN = """
import sys, tempfile
sys.modules["jax"] = None
sys.modules["libstevi_tpu"] = None
import numpy as np, torch
from libstevi_tpu_torch.cli import (detrend_terrain, io_pointcloud,
    points_cloud2depth_map, split_pt_cloud, stevimg_viewer)
from libstevi_tpu_torch.gui import GrayscaleArrayDisplayAdapter
from libstevi_tpu_torch.io import PointCloud, open_point_cloud, write_pcd
from libstevi_tpu_torch.io.las_stream import LasReader, write_las_v2
from libstevi_tpu_torch.io.sdc_io import write_sdc
from libstevi_tpu_torch.io.metacloud_io import write_metacloud
from libstevi_tpu_torch.utils import (cost_analysis, resumable_iterate,
                                      save_checkpoint, load_checkpoint)
rng = np.random.default_rng(0)
pos = rng.uniform(0, 20, (300, 3))
d = tempfile.mkdtemp()
write_las_v2(d + "/a.las", pos, {"gps_time": rng.uniform(0, 1, 300)})
cloud = open_point_cloud(d + "/a.las")
write_pcd(d + "/a.pcd", cloud, compressed=True)
assert open_point_cloud(d + "/a.pcd").n_points == 300
write_sdc(d + "/a.sdc", cloud)
write_metacloud(d + "/a.metacloud", cloud)
depth, cov = points_cloud2depth_map.project_depth(
    torch.from_numpy(pos.astype(np.float32)), (8, 8), 1.0,
    t=(-10.0, -10.0, 30.0))
z, zmap, terrain = detrend_terrain.detrend(torch.from_numpy(pos), 5.0, 1.0)
assert GrayscaleArrayDisplayAdapter(depth).to_rgb().shape == (8, 8, 3)
assert cost_analysis(lambda a: a @ a, torch.ones(4, 4))["flops"] == 128
p = save_checkpoint(d, 1, {"b": torch.ones(2), "a": None})
assert load_checkpoint(p, like={"b": torch.zeros(2), "a": None})["a"] is None
print("ran without jax")
"""


def test_point_cloud_modules_run_without_jax():
    """With jax and libstevi_tpu unimportable, the new modules import and
    run: the codecs, the five CLIs' modules, the projection, the detrend,
    an adapter, the cost analysis and a checkpoint (the card has no JAX)."""
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ran without jax" in res.stdout
