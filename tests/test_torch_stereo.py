"""`dense_sgm_stereo` end to end: the port on the CPU (each kernel wrapper
running its plain version) against the JAX package on the CPU."""

from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.ops import dense_sgm_stereo as j_dense
from libstevi_tpu.ops import sgm_cost_volume as j_sgm
from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
from libstevi_tpu.ops.refinement import InterpolationKernel as JInterp

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.io import read_stevimg
from libstevi_tpu_torch.ops import dense_sgm_stereo
from libstevi_tpu_torch.reference import to_port
from libstevi_tpu_torch.statistics import prop_good, inlier_mae

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
DATA = Path(__file__).resolve().parent / "data" / "parity"


def _run_both(L, R, func, h, v, D, P1, P2, jdt, tdt, **kw):
    jkw = dict(kw)
    tkw = {k: to_port(x) for k, x in kw.items()}
    j = j_dense(func, jnp.asarray(L), jnp.asarray(R), h, v, D, P1, P2,
                cv_dtype=jdt, **jkw)
    t = dense_sgm_stereo(to_port(func), torch.from_numpy(L),
                         torch.from_numpy(R), h, v, D, P1, P2, cv_dtype=tdt,
                         **tkw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _clear_gap(L, R, func, h, v, D, P1, P2, n_dirs, gap=1e-4):
    """Pixels where the f32 SGM's best and second-best differ by > gap."""
    cv = j_box(func, jnp.asarray(L), jnp.asarray(R), h, v, D)
    sgm = np.asarray(j_sgm(-cv, P1, P2, n_directions=n_dirs, backend="xla"))
    s = np.sort(sgm, -1)
    return (s[..., 1] - s[..., 0]) > gap


@pytest.mark.parametrize("refine", [None, JInterp.PARABOLA,
                                    JInterp.EQUIANGULAR],
                         ids=["none", "parabola", "equiangular"])
@pytest.mark.parametrize("n_dirs", [4, 8])
def test_dense_sgm_stereo_f32_matches_jax(n_dirs, refine):
    rng = np.random.default_rng(10)
    L = rng.uniform(0, 1, (24, 36)).astype(np.float32)
    R = rng.uniform(0, 1, (24, 36)).astype(np.float32)
    args = (JMF.ZNCC, 3, 2, 10, 0.1, 0.5)
    (dj, ij, tj), (dt, it, tt) = _run_both(
        L, R, *args, jnp.float32, torch.float32, n_directions=n_dirs,
        refine_kernel=refine)
    clear = _clear_gap(L, R, *args, n_dirs)
    np.testing.assert_array_equal(it[clear], ij[clear])
    same = it == ij
    assert same.mean() > 0.99
    np.testing.assert_array_equal(np.isnan(tt[same]), np.isnan(tj[same]))
    np.testing.assert_allclose(tt[same], tj[same], **TOL)
    np.testing.assert_array_equal(np.isnan(dt[same]), np.isnan(dj[same]))
    f = np.isfinite(dj) & same
    np.testing.assert_allclose(dt[f], dj[f], **TOL)


@pytest.mark.parametrize("func", ["NCC", "ZNCC", "CC"])
def test_dense_sgm_stereo_bf16_matches_jax(func):
    """bf16 volume, f32 DP, against the JAX XLA path with a bf16 volume:
    the bars of `tests/test_sgm.py:240-259`."""
    rng = np.random.default_rng(11)
    L = rng.uniform(0, 1, (24, 36)).astype(np.float32)
    R = np.roll(L, -3, axis=1) + rng.normal(0, 0.02, L.shape).astype(np.float32)
    (dj, ij, tj), (dt, it, tt) = _run_both(
        L, R, JMF[func], 2, 2, 9, 0.1, 0.5, jnp.bfloat16, torch.bfloat16,
        refine_kernel=JInterp.PARABOLA)
    same = it == ij
    assert same.mean() > 0.99, same.mean()
    ok = np.isfinite(tt[same]) & np.isfinite(tj[same])
    np.testing.assert_allclose(tt[same][ok], tj[same][ok], atol=0.1,
                               rtol=0.02)


@pytest.mark.parametrize("case", ["p2_below_p1", "multichannel"])
def test_dense_sgm_stereo_composed_chain_matches_jax(case):
    """Configurations the kernels do not take run the composed plain chain
    on the CPU, as the JAX package's XLA path does."""
    rng = np.random.default_rng(12)
    shape = (16, 22, 3) if case == "multichannel" else (16, 22)
    L = rng.uniform(0, 1, shape).astype(np.float32)
    R = rng.uniform(0, 1, shape).astype(np.float32)
    P1, P2 = (0.5, 0.2) if case == "p2_below_p1" else (0.1, 0.5)
    (dj, ij, tj), (dt, it, tt) = _run_both(
        L, R, JMF.ZNCC, 2, 2, 6, P1, P2, jnp.float32, torch.float32,
        n_directions=4)
    same = it == ij
    assert same.mean() > 0.99
    np.testing.assert_allclose(tt[same], tj[same], **TOL)


def test_dense_sgm_stereo_on_small_parity_fixture():
    """The committed 96x128 warp fixture through both packages at the
    flagship settings (bf16 volume): the same accuracy against the GT."""
    L = read_stevimg(str(DATA / "left_small.stevimg"))
    R = read_stevimg(str(DATA / "right_small.stevimg"))
    gt = read_stevimg(str(DATA / "gt_small.stevimg"))
    (dj, ij, _), (dt, it, _) = _run_both(
        L, R, JMF.ZNCC, 3, 3, 24, 0.1, 0.5, jnp.bfloat16, torch.bfloat16,
        refine_kernel=JInterp.PARABOLA)
    assert (it == ij).mean() > 0.99
    assert abs(prop_good(dt, gt) - prop_good(dj, gt)) < 2e-3
    assert abs(inlier_mae(dt, gt) - inlier_mae(dj, gt)) < 5e-3


@pytest.mark.parametrize("func,P1,P2", [("CENSUS", 1.0, 4.0),
                                        ("SAD", 0.1, 0.5)])
def test_non_dot_route_matches_jax_on_small_fixture(func, P1, P2):
    """Non-dot costs take the general route (unfold_based_cost_volume ->
    sgm_wta_truncated -> refinement), as in the JAX package, on the 96x128
    warp fixture."""
    L = read_stevimg(str(DATA / "left_small.stevimg"))
    R = read_stevimg(str(DATA / "right_small.stevimg"))
    gt = read_stevimg(str(DATA / "gt_small.stevimg"))
    (dj, ij, tj), (dt, it, tt) = _run_both(
        L, R, JMF[func], 3, 3, 24, P1, P2, jnp.float32, torch.float32,
        refine_kernel=JInterp.PARABOLA)
    same = it == ij
    assert same.mean() > 0.99, same.mean()
    np.testing.assert_array_equal(np.isnan(tt[same]), np.isnan(tj[same]))
    np.testing.assert_allclose(tt[same], tj[same], **TOL)
    f = same & np.isfinite(dj)
    np.testing.assert_allclose(dt[f], dj[f], **TOL)
    assert abs(prop_good(dt, gt) - prop_good(dj, gt)) < 2e-3


def test_census_entry_is_the_parity_configuration():
    """`entry.census_sgm_forward` runs the PARITY_r05 `census_sgm8` chain
    (`scripts/run_parity_r05.py:67-74`) through `dense_sgm_stereo`."""
    cfg = entry.CENSUS_SGM8
    assert (cfg["P1"], cfg["P2"], cfg["n_directions"]) == (1.0, 4.0, 8)
    assert (cfg["h_radius"], cfg["v_radius"], cfg["disp_width"]) == (3, 3, 120)
    assert entry.HD_BF16["disp_width"] == 320
    assert entry.HD_BF16["cv_dtype"] == torch.bfloat16
    assert (entry.HD_HEIGHT, entry.HD_WIDTH) == (720, 1280)
    rng = np.random.default_rng(13)
    L = rng.uniform(0, 1, (16, 30)).astype(np.float32)
    R = rng.uniform(0, 1, (16, 30)).astype(np.float32)
    got = entry.census_sgm_forward(torch.from_numpy(L), torch.from_numpy(R))
    assert got.shape == (16, 30) and got.dtype == torch.float32


def test_entry_gives_the_flagship_geometry():
    fn, (L, R) = entry.entry("cpu")
    assert fn is entry.flagship_forward
    assert L.shape == R.shape == (480, 640) and L.dtype == torch.float32
    assert entry.FLAGSHIP["disp_width"] == 120
    assert entry.FLAGSHIP["cv_dtype"] == torch.bfloat16
