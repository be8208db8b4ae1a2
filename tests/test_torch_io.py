"""The port's image IO (`libstevi_tpu_torch/io`) against the JAX package's
readers and writers (`libstevi_tpu/io/image_io.py`, `exr_io.py`): each
format written by one package and read by the other, both ways, and the
port's CLI reading a ``.pfm`` ground truth."""

import json
import sys

import numpy as np
import pytest

from libstevi_tpu.io import exr_io as j_exr
from libstevi_tpu.io import image_io as j_io
from libstevi_tpu_torch.io import exr_io as t_exr
from libstevi_tpu_torch.io import image_io as t_io

rng = np.random.default_rng(5)

# each format with an array of the kinds it stores
ARRAYS = {
    ".pfm": [rng.uniform(-3, 50, (7, 11)).astype(np.float32),
             rng.uniform(0, 1, (5, 4, 3)).astype(np.float32)],
    ".flo": [rng.normal(0, 4, (6, 9, 2)).astype(np.float32)],
    ".exr": [rng.uniform(-2, 2, (19, 13)).astype(np.float32),
             rng.uniform(0, 1, (17, 5, 3)).astype(np.float32),
             rng.uniform(0, 1, (4, 6, 4)).astype(np.float32)],
    ".stevimg": [rng.integers(0, 255, (5, 8)).astype(np.uint8),
                 rng.uniform(0, 1, (3, 4, 2)).astype(np.float64)],
}
CASES = [(ext, k) for ext, arrs in ARRAYS.items() for k in range(len(arrs))]


@pytest.mark.parametrize("ext,k", CASES)
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_image_and_write_image_cross(tmp_path, ext, k, writer):
    """`write_image` of one package, `read_image` of the other: equal
    arrays (the formats store float32 exactly)."""
    img = ARRAYS[ext][k]
    path = str(tmp_path / f"img{ext}")
    write, read = ((j_io.write_image, t_io.read_image) if writer == "jax"
                   else (t_io.write_image, j_io.read_image))
    assert write(path, img)
    got = read(path)
    assert got.shape == img.shape and got.dtype == img.dtype
    np.testing.assert_array_equal(got, img)


@pytest.mark.parametrize("fmt", ["pfm", "flo"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_format_functions_cross(tmp_path, fmt, writer):
    """`write_pfm`/`read_pfm` (little- and big-endian, with a unit scale)
    and `write_flo`/`read_flo` across the two packages."""
    img = (rng.uniform(0, 9, (6, 5)) if fmt == "pfm"
           else rng.normal(0, 2, (4, 7, 2))).astype(np.float32)
    j = (j_io.write_pfm, j_io.read_pfm) if fmt == "pfm" else (
        j_io.write_flo, j_io.read_flo)
    t = (t_io.write_pfm, t_io.read_pfm) if fmt == "pfm" else (
        t_io.write_flo, t_io.read_flo)
    (write, _), (_, read) = (j, t) if writer == "jax" else (t, j)
    scales = (-1.0, 1.0) if fmt == "pfm" else (None,)
    for scale in scales:
        path = str(tmp_path / f"x.{fmt}")
        if scale is None:
            write(path, img)
        else:
            write(path, img, scale)
        np.testing.assert_array_equal(read(path), img)


@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_exr_channels_cross(tmp_path, compression, writer):
    """`write_exr`/`read_exr` with named channels and each compression,
    across the two packages."""
    planes = {n: rng.uniform(-1, 1, (23, 9)).astype(np.float32)
              for n in ("Z", "R", "depth")}
    path = str(tmp_path / "c.exr")
    write, read = ((j_exr.write_exr, t_exr.read_exr) if writer == "jax"
                   else (t_exr.write_exr, j_exr.read_exr))
    assert write(path, planes, compression)
    got = read(path)
    assert sorted(got) == sorted(planes)
    for n, p in planes.items():
        np.testing.assert_array_equal(got[n], p)


IMAGE_LIBRARY_CASES = ["a.png", "a.jpg", "noext", "a.png without imageio"]


@pytest.mark.parametrize("case", IMAGE_LIBRARY_CASES)
def test_formats_that_need_an_image_library_raise(tmp_path, monkeypatch,
                                                  case):
    """The formats the JAX package hands to imageio, as it does: a PNG
    written by either package reads back through both the same
    (`array_equal`; floats scaled by 255 to uint8), a JPEG reads the same
    through both from one file, and both writers' JPEGs decode equal; a
    path without an extension raises what JAX's call raises, and so does
    any of them where imageio cannot be imported."""
    rng = np.random.default_rng(9)
    images = [rng.uniform(0, 1, (12, 17)).astype(np.float32),
              rng.integers(0, 255, (9, 8, 3)).astype(np.uint8)]
    name = case.split()[0]
    if case.endswith("without imageio"):
        monkeypatch.setitem(sys.modules, "imageio", None)
        monkeypatch.setitem(sys.modules, "imageio.v3", None)
    if name == "noext" or case.endswith("without imageio"):
        for op in ("write", "read"):
            errors = []
            for io in (j_io, t_io):
                with pytest.raises(Exception) as e:
                    if op == "write":
                        io.write_image(str(tmp_path / name), images[0])
                    else:
                        io.read_image(str(tmp_path / name))
                errors.append(e.value)
            assert type(errors[1]) is type(errors[0]), (op, errors)
            assert str(errors[1]) == str(errors[0])
        return
    for k, img in enumerate(images):
        got = {}
        for writer, io in (("jax", j_io), ("port", t_io)):
            path = str(tmp_path / f"{writer}{k}{name[1:]}")
            assert io.write_image(path, img)
            a, b = j_io.read_image(path), t_io.read_image(path)
            np.testing.assert_array_equal(b, a)
            assert b.dtype == a.dtype == np.uint8
            got[writer] = b
        np.testing.assert_array_equal(got["port"], got["jax"])
        if name == "a.png":
            want = img if img.dtype == np.uint8 else np.clip(
                img * 255.0, 0, 255).astype(np.uint8)
            np.testing.assert_array_equal(got["port"], want)
            f32 = t_io.read_image(str(tmp_path / f"port{k}.png"), np.float32)
            np.testing.assert_array_equal(f32, want.astype(np.float32))


def test_io_exports_the_exr_helpers(tmp_path):
    """`read_exr_channel`, `is_exr_file` and `exr_channels` from the
    package, as the JAX package exports them."""
    from libstevi_tpu_torch.io import (exr_channels, is_exr_file,
                                       read_exr_channel, write_exr)
    import libstevi_tpu.io as jio
    planes = {"Z": rng.uniform(0, 1, (5, 6)).astype(np.float32),
              "R": rng.uniform(0, 1, (5, 6)).astype(np.float32)}
    path = str(tmp_path / "p.exr")
    assert write_exr(path, planes)
    assert is_exr_file(path) and jio.is_exr_file(path)
    assert not is_exr_file(str(tmp_path / "missing.exr"))
    assert exr_channels(path) == jio.exr_channels(path)
    np.testing.assert_array_equal(read_exr_channel(path, "Z"), planes["Z"])


def test_cli_takes_a_pfm_ground_truth(tmp_path, capsys):
    """The port's CLI on the 96x128 parity fixtures with the ground truth
    as a ``.pfm`` file (written by the JAX package) reports what it
    reports with the ``.stevimg`` original."""
    from pathlib import Path
    from libstevi_tpu_torch.cli import stereo_match
    data = Path(__file__).resolve().parent / "data" / "parity"
    gt = t_io.read_image(str(data / "gt_small.stevimg"), np.float32)
    j_io.write_pfm(str(tmp_path / "gt.pfm"), gt)
    reports = []
    for gt_path in (str(data / "gt_small.stevimg"), str(tmp_path / "gt.pfm")):
        assert stereo_match.main([
            str(data / "left_small.stevimg"),
            str(data / "right_small.stevimg"), "-o",
            str(tmp_path / "d.pfm"), "-d", "16", "--matcher", "wta",
            "--gt", gt_path, "--device", "cpu"]) == 0
        reports.append(json.loads(
            capsys.readouterr().out.strip().splitlines()[-1]))
        assert j_io.read_pfm(str(tmp_path / "d.pfm")).shape == gt.shape
    for key in ("prop_good_2.0", "inlier_mae"):
        assert reports[0][key] == reports[1][key]
