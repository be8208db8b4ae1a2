"""The PyTorch port's configuration tables, IO and metrics against the JAX
package, and the port's independence from JAX."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from libstevi_tpu.core import types as jtypes
from libstevi_tpu.io.image_io import read_stevimg as j_read, write_stevimg as j_write
from libstevi_tpu.io.image_io import read_image as j_read_image
from libstevi_tpu.ops.refinement import InterpolationKernel as JInterp
from libstevi_tpu.ops.sgm import SgmDirection as JSgmDirection
from libstevi_tpu.ops.unfold import PatchOrientation as JPatchOrientation
from libstevi_tpu.statistics import metrics as jmetrics

from libstevi_tpu_torch.core import types as ttypes
from libstevi_tpu_torch.io import (read_image, read_stevimg, write_image,
                                   write_stevimg)
from libstevi_tpu_torch.reference import PORT_ENUMS, to_port
from libstevi_tpu_torch.statistics import metrics as tmetrics

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data" / "parity"

JAX_ENUMS = [jtypes.MatchingFunction, jtypes.ExtractionStrategy,
             jtypes.DispDirection, jtypes.TruncatedCvDirection, JInterp,
             JSgmDirection, JPatchOrientation]


@pytest.mark.parametrize("jcls", JAX_ENUMS, ids=lambda c: c.__name__)
def test_enum_tables_equal(jcls):
    pcls = PORT_ENUMS[jcls.__name__]
    assert [(m.name, m.value) for m in jcls] == [(m.name, m.value)
                                                 for m in pcls]
    for m in jcls:
        assert to_port(m) is pcls[m.name]


def test_match_traits_table_equal():
    assert to_port(jtypes.MATCH_TRAITS) == ttypes.MATCH_TRAITS


def test_numbers_carry_across_unchanged():
    cfg = {"P1": 0.1, "P2": 0.5, "Pout": 100.0, "h_radius": 3}
    assert to_port(cfg) == cfg


@pytest.mark.parametrize("func", list(jtypes.MatchingFunction),
                         ids=lambda f: f.name)
def test_default_cv_value(func):
    want = float(jtypes.default_cv_value(func))
    assert ttypes.default_cv_value(to_port(func)).item() == want


def test_delta_sign():
    for m in jtypes.DispDirection:
        assert to_port(m).delta_sign == m.delta_sign


@pytest.mark.parametrize("name", ["left", "right", "gt", "left_occ",
                                  "right_occ", "gt_occ", "left_small"])
def test_read_stevimg_matches_jax(name):
    path = str(DATA / f"{name}.stevimg")
    np.testing.assert_array_equal(read_stevimg(path), j_read(path))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8, np.int32,
                                   np.float64])
def test_stevimg_roundtrip_with_jax(tmp_path, dtype):
    img = (np.random.default_rng(0).uniform(0, 100, (5, 7, 3))
           .astype(dtype))
    write_stevimg(str(tmp_path / "a.stevimg"), img)
    np.testing.assert_array_equal(j_read(str(tmp_path / "a.stevimg")), img)
    j_write(str(tmp_path / "b.stevimg"), img)
    np.testing.assert_array_equal(read_stevimg(str(tmp_path / "b.stevimg")),
                                  img)


def test_read_write_image_dispatch_stevimg(tmp_path):
    img = np.random.default_rng(2).uniform(0, 1, (4, 6)).astype(np.float32)
    path = str(tmp_path / "a.stevimg")
    assert write_image(path, img)
    np.testing.assert_array_equal(j_read_image(path), img)
    got = read_image(str(DATA / "left_small.stevimg"), np.float64)
    np.testing.assert_array_equal(
        got, j_read_image(str(DATA / "left_small.stevimg"), np.float64))
    for name in ("a.png", "a.jpg"):      # through imageio, as in JAX
        assert write_image(str(tmp_path / name), img)
        np.testing.assert_array_equal(read_image(str(tmp_path / name)),
                                      j_read_image(str(tmp_path / name)))
        missing = str(tmp_path / ("missing" + name[1:]))
        with pytest.raises(Exception) as e_jax:
            j_read_image(missing)
        with pytest.raises(type(e_jax.value)):
            read_image(missing)
    flow = np.stack([img, -img], -1)     # .flo is numpy, as in JAX
    assert write_image(str(tmp_path / "a.flo"), flow)
    np.testing.assert_array_equal(j_read_image(str(tmp_path / "a.flo")), flow)


@pytest.mark.parametrize("threshold", [0.5, 1.0, 2.0])
def test_metrics_match_jax(threshold):
    rng = np.random.default_rng(1)
    gt = rng.uniform(0, 20, (30, 40))
    gt[rng.uniform(size=gt.shape) < 0.1] = np.nan
    disp = gt + rng.normal(0, 1.5, gt.shape)
    disp[rng.uniform(size=gt.shape) < 0.05] = np.nan
    for name in ("prop_good", "bad_n", "inlier_mae"):
        assert getattr(tmetrics, name)(disp, gt, threshold) == \
            getattr(jmetrics, name)(disp, gt, threshold)


_NO_JAX_RUN = """
import sys
sys.modules["jax"] = None
sys.modules["libstevi_tpu"] = None
import numpy as np, torch
import libstevi_tpu_torch
from libstevi_tpu_torch import entry, reference
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.ops import dense_sgm_stereo, InterpolationKernel
torch.set_num_threads(1)
rng = np.random.default_rng(0)
L = torch.from_numpy(rng.uniform(0, 1, (12, 16)).astype(np.float32))
R = torch.from_numpy(rng.uniform(0, 1, (12, 16)).astype(np.float32))
disp, idx, tcv = dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 2, 2, 5,
                                  0.1, 0.5, refine_kernel=InterpolationKernel.PARABOLA,
                                  cv_dtype=torch.bfloat16)
assert disp.shape == (12, 16) and tcv.shape == (12, 16, 3)
pm = entry.patchmatch_forward(L, R, torch.Generator().manual_seed(0))
assert pm.shape == (12, 16) and pm.dtype == torch.int32
idx = entry.wta_forward(MatchingFunction.ZSAD, L, R)
assert idx.shape == (12, 16) and idx.dtype == torch.int32
d16 = entry.sgm16_forward(L, R)
assert d16.shape == (12, 16) and d16.dtype == torch.float32
dc = entry.census_sgm_forward(L, R)
assert dc.shape == (12, 16)
from libstevi_tpu_torch.cli import stereo_match, stereo_refine, optical_flow_refine
from libstevi_tpu_torch import optim
for m in ("barycentric", "barycentric-symmetric", "cost-symmetric"):
    assert entry.stereo_refine_forward(L, R, m).shape == (12, 16)
from libstevi_tpu_torch import parallel
from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
mesh = make_stereo_mesh(MeshSpec(batch=2, tile=2, dsh=2), ["cpu"] * 8)
dd = entry.distributed_forward(torch.stack([L, R]), torch.stack([R, L]), mesh)
assert dd.shape == (2, 12, 16) and dd.dtype == torch.int32
x = parallel.distributed_multiview_alignment(
    lambda p, d: p[0] * d - 2.0 * d, torch.zeros(1), torch.arange(8.0), mesh,
    "batch", iters=3)
assert abs(float(x[0]) - 2.0) < 1e-4
from libstevi_tpu_torch import geometry, statistics
from libstevi_tpu_torch.geometry import bsp, posesmath, sensorframes
from libstevi_tpu_torch.geometry import pointcloudalignment, raysalignment
from libstevi_tpu_torch.geometry.stereorigrectifier import StereoRigRectifier
from libstevi_tpu_torch.cli import ray_alignment_eval
rig = StereoRigRectifier([0.0, 0.02, 0.01], [1.0, 0.02, 0.01], 75.0,
                         [48.0, 32.0], (96, 64), k1=[-0.05, 0.01, 0.0],
                         device="cpu")
assert rig.compute("minimal") and rig.backward_cam1.shape == (64, 96, 2)
from libstevi_tpu_torch.interpolation import resample_image
rect = resample_image(L, rig.backward_cam1[:12, :16])
cov = statistics.compute_covering_proportion(d16, d16)
assert rect.shape == (12, 16) and 0 <= float(cov) <= 1
assert bsp.GenericBSP(np.random.default_rng(1).uniform(size=(40, 3))).nearest(
    np.zeros(3)) >= 0
assert sensorframes.get_sensor_frame_conversion(sensorframes.NED,
                                                sensorframes.ENU).shape == (3, 3)
assert ray_alignment_eval.main(["-n", "1", "--rays", "20", "--solvers",
                                "gauss-newton", "relaxed", "--device",
                                "cpu"]) == 0
from libstevi_tpu_torch import graphs
from libstevi_tpu_torch.cli import (bg_fg_stereo, intrinsic_decomposition,
                                    normal_map_estimation)
from libstevi_tpu_torch.imageproc import (foreground_segmentation,
                                          mean_shift_clustering, retinex_fft)
(bl, br, ll, lr), rect = entry.bg_fg_scene(24, 40, 2, 5, 0)
est = entry.bg_fg_background(torch.from_numpy(bl), torch.from_numpy(br),
                             disp_width=8)
res = entry.bg_fg_forward(torch.from_numpy(ll), torch.from_numpy(lr), est)
assert res.fg_mask.shape == (24, 40) and res.disp.dtype == torch.int32
cut = graphs.max_flow_min_cut(4, [(0, 1), (1, 3), (0, 2), (2, 3)],
                              [3.0, 2.0, 2.0, 3.0], 0, 3)
assert cut.max_flow == 4.0
cost = np.stack([rect * 1.0, 1.0 - rect], -1)
assert (foreground_segmentation.get_global_refined_mask(cost, 0.1)
        == rect).all()
assert retinex_fft(L + 0.1).shading.shape == (12, 16)
assert mean_shift_clustering(L.reshape(-1, 2), 0.5)[1].shape == (96,)
assert not [m for m, v in sys.modules.items()
            if v is not None and (m == "jax" or m.startswith("jax."))]
print("ran without jax")
"""


def test_port_imports_and_runs_without_jax():
    """With jax and libstevi_tpu made unimportable, the port imports and
    runs the dense SGM (8 and 16 directions, ZNCC and census), PatchMatch,
    WTA, the image-level refinement, the distributed paths and the
    distributed Gauss-Newton end to end on the CPU, imports its CLIs,
    `optim`, `geometry` (the numpy copies `bsp` and `sensorframes` too)
    and `statistics`, rectifies and resamples through the rig rectifier,
    takes a covering share, runs the ray-alignment CLI, the bg/fg entry
    points, the native max-flow and a graph cut, the FFT retinex and mean
    shift, and imports the pipeline CLIs (the card has no JAX)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ran without jax" in res.stdout


_IMPORT_JAX = re.compile(r"^\s*(import|from)\s+(jax|libstevi_tpu)\b", re.M)
_PORT_FILES = sorted(p.relative_to(REPO).as_posix() for p in
                     (REPO / "libstevi_tpu_torch").rglob("*.py")) \
    + ["chip_smoke.py"]


@pytest.mark.parametrize("rel", _PORT_FILES)
def test_no_port_file_imports_jax(rel):
    text = (REPO / rel).read_text()
    assert not _IMPORT_JAX.search(text), rel


# -- core.utils (`libstevi_tpu/core/utils.py`) --------------------------------

from libstevi_tpu.core import utils as jutils  # noqa: E402
from libstevi_tpu_torch.core import utils as tutils  # noqa: E402


@pytest.mark.parametrize("name", ["QUEEN", "ROOK", "BISHOP"])
def test_contiguity_matches_jax(name):
    """Names, values and neighbour offsets equal; `to_port` maps it."""
    j = jutils.Contiguity[name]
    assert to_port(j) is tutils.Contiguity[name]
    assert to_port(j).value == j.value and to_port(j).offsets == j.offsets


def test_propagation_direction_and_index_pair_map_match_jax():
    assert [(m.name, m.increments) for m in jutils.PropagationDirection] \
        == [(m.name, m.increments) for m in tutils.PropagationDirection]
    jm, tm = jutils.IndexPairMap(), tutils.IndexPairMap()
    for m in (jm, tm):
        m[(3, 1)] = "a"
        m[(2, 5)] = "b"
    assert dict(jm) == dict(tm) == {(1, 3): "a", (2, 5): "b"}
    assert tm[(1, 3)] == "a" and (5, 2) in tm and (4, 4) not in tm


@pytest.mark.parametrize("name", ["uint8", "int8", "uint16", "int16",
                                  "uint32", "int32", "float32"])
def test_dtype_helpers_match_jax(name):
    """`accumulation_extended_dtype` names the JAX package's type (float32
    for a float), `equivalent_one_for_normalizing` its value."""
    import jax.numpy as jnp
    got = tutils.accumulation_extended_dtype(getattr(torch, name))
    want = np.dtype(jutils.accumulation_extended_dtype(getattr(jnp, name)))
    assert str(got).split(".")[-1] == want.name
    if name != "float32":
        assert tutils.equivalent_one_for_normalizing(getattr(torch, name)) \
            == jutils.equivalent_one_for_normalizing(getattr(jnp, name))


def test_numbers_cache_is_deterministic():
    """The same seed gives the same sequence (torch's draws, not
    threefry's); `seed` moves the read position as the JAX class does."""
    a, b = tutils.NumbersCache(64, 0, 10, seed=3), tutils.NumbersCache(
        64, 0, 10, seed=3)
    seq = [a() for _ in range(70)]
    assert seq == [b() for _ in range(70)]
    assert all(0 <= v < 10 for v in seq) and len(set(seq)) > 1
    a.seed(66)
    assert a() == seq[2]
