"""The port's `statistics` additions and the stereo rig rectifier against the
JAX package's on the CPU: the covering mask and share (both directions,
scaling and offset, NaN and out-of-range disparities), the covariance
kernels, `end_point_error`, `StereoRigRectifier` (each ROI mode, with and
without lens distortion, the zero-baseline refusal, the epipolar rows), and
the whole chain — rectify, resample, the flagship's dense SGM, covering —
at 64x96 against the same chain in JAX.  Tolerances are stated in each
test."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu import statistics as JS
from libstevi_tpu.core import DispDirection as JDir
from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.geometry.rotations import rodrigues_formula as j_rod
from libstevi_tpu.geometry.stereorigrectifier import StereoRigRectifier as JRig
from libstevi_tpu.interpolation import resample_image as j_resample
from libstevi_tpu.ops import dense_sgm_stereo as j_dense
from libstevi_tpu.ops.refinement import InterpolationKernel as JInterp

from libstevi_tpu_torch import statistics as TS
from libstevi_tpu_torch.core import DispDirection as TDir
from libstevi_tpu_torch.core import MatchingFunction as TMF
from libstevi_tpu_torch.geometry.stereorigrectifier import (
    StereoRigRectifier as TRig)
from libstevi_tpu_torch.interpolation import resample_image as t_resample
from libstevi_tpu_torch.ops import InterpolationKernel as TInterp
from libstevi_tpu_torch.ops import dense_sgm_stereo as t_dense

torch.set_num_threads(2)


def _disparities(seed, shape=(12, 40)):
    """Fractional and integer disparities, some NaN, one far past the
    int32 range, some negative."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-3, 20, shape).astype(np.float32)
    d[:, ::5] = np.round(d[:, ::5])
    d[rng.random(shape) < 0.1] = np.nan
    d[0, 0] = 1e12
    return d


@pytest.mark.parametrize("direction", ["RIGHT_TO_LEFT", "LEFT_TO_RIGHT"])
@pytest.mark.parametrize("scaling,offset", [(1.0, 0.0), (1.3, 0.5)])
def test_covering_matches_jax(direction, scaling, offset):
    """The covering mask within 1e-6 with JAX's NaN pattern (a NaN
    disparity votes NaN into column 0, as XLA's float-to-int cast sends
    NaN to 0), and the share at each threshold within 1e-5."""
    dl, dr = _disparities(1), _disparities(2)
    args = (scaling, offset)
    want = np.asarray(JS.compute_covering(jnp.asarray(dl), jnp.asarray(dr),
                                          JDir[direction], *args))
    got = TS.compute_covering(torch.from_numpy(dl), torch.from_numpy(dr),
                              TDir[direction], *args).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    f = np.isfinite(want)
    np.testing.assert_allclose(got[f], want[f], rtol=0, atol=1e-6)
    for thr in (0.25, 0.5, 1.0):
        a = float(JS.compute_covering_proportion(
            jnp.asarray(dl), jnp.asarray(dr), thr, JDir[direction], *args))
        b = float(TS.compute_covering_proportion(
            torch.from_numpy(dl), torch.from_numpy(dr), thr, TDir[direction],
            *args))
        assert abs(a - b) <= 1e-5, (thr, a, b)


def test_covering_integer_disparity():
    """`test_rig_and_stats.py`'s case: integer disparity d covers the
    first W - d source columns once."""
    H, W, d = 8, 32, 3
    disp = torch.full((H, W), float(d))
    cov = TS.compute_covering(disp, disp).numpy()
    assert (cov[:, :W - d] == 1.0).all() and (cov[:, W - d:] == 0.0).all()
    assert float(TS.compute_covering_proportion(disp, disp)) == \
        pytest.approx((W - d) / W)


@pytest.mark.parametrize("kernel,kw", [
    ("matern_kernel", dict(nu=0.5)), ("matern_kernel", dict(nu=1.5)),
    ("matern_kernel", dict(nu=2.5)), ("matern_kernel", dict(nu=np.inf)),
    ("exponential_kernel", {}), ("gaussian_kernel", {})])
def test_covariance_kernels_match_jax(kernel, kw):
    """Each kernel at two length scales and variances within 1e-6."""
    d = np.linspace(-4, 4, 41).astype(np.float32)
    for ls, var in ((1.0, 1.0), (0.7, 2.5)):
        want = getattr(JS, kernel)(jnp.asarray(d), length_scale=ls,
                                   variance=var, **kw)
        got = getattr(TS, kernel)(torch.from_numpy(d), length_scale=ls,
                                  variance=var, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
    with pytest.raises(ValueError, match="nu"):
        TS.matern_kernel(torch.from_numpy(d), nu=1.0)


def test_end_point_error_matches_jax():
    """Equal to JAX's float on a flow with NaN ground truth, NaN estimates
    (loud NaN) and no valid pixel (NaN)."""
    rng = np.random.default_rng(3)
    gt = rng.normal(0, 3, (9, 11, 2))
    flow = gt + rng.normal(0, 0.5, gt.shape)
    gt[rng.random(gt.shape[:2]) < 0.2] = np.nan
    assert TS.end_point_error(flow, gt) == JS.end_point_error(flow, gt)
    flow[4, 4] = np.nan
    gt[4, 4] = 0.0
    assert np.isnan(TS.end_point_error(flow, gt))
    assert np.isnan(TS.end_point_error(flow, np.full_like(gt, np.nan)))
    assert TS.__all__ == JS.__all__


# -- the stereo rig rectifier -------------------------------------------------------

DIST = dict(k1=[-0.08, 0.02, 0.0], t1=[0.0005, -0.0003],
            k2=[-0.06, 0.015, 0.0], t2=[-0.0004, 0.0002])


def _rig_args(scale=1.0, distortion=False, size=None):
    """`test_rig_and_stats.py`'s rig (640x480), its focal lengths,
    principal points and size scaled by ``scale`` (or the size given)."""
    size = size or (int(640 * scale), int(480 * scale))
    kw = dict(r_cam2_to_cam1=np.asarray([0.0, 0.02, 0.01], np.float32),
              t_cam2_to_cam1=np.asarray([1.0, 0.02, 0.01], np.float32),
              f1=500.0 * scale, pp1=np.array([320.0, 240.0]) * scale,
              size1=size, f2=505.0 * scale,
              pp2=np.array([318.0, 242.0]) * scale, size2=size)
    if distortion:
        kw.update({k: np.asarray(v, np.float32) for k, v in DIST.items()})
    return kw


@pytest.mark.parametrize("roi", ["minimal", "same", "maximal"])
@pytest.mark.parametrize("distortion", [False, True], ids=["pinhole", "brown"])
def test_rig_rectifier_matches_jax(roi, distortion):
    """`compute` on the 640x480 rig: the same outcome, the derotations
    within 1e-5, the new focal, principal points, baseline and disparity
    offset within 1e-4 relative, the 480x640x2 backward maps within 1e-3
    px."""
    jr, tr = JRig(**_rig_args(1.0, distortion)), TRig(
        **_rig_args(1.0, distortion), device="cpu")
    assert jr.compute(roi) and tr.compute(roi)
    for a, b in ((tr.corr_r_cam1, jr.corr_r_cam1),
                 (tr.corr_r_cam2, jr.corr_r_cam2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    for k in ("reprojection_flen", "normalized_baseline", "disp_delta"):
        assert getattr(tr, k) == pytest.approx(getattr(jr, k), rel=1e-4,
                                               abs=1e-4), k
    for k in ("new_pp_cam1", "new_pp_cam2"):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=1e-4)
    assert tr.nsize_cam1 == jr.nsize_cam1 == (640, 480)
    for a, b in ((tr.backward_cam1, jr.backward_cam1),
                 (tr.backward_cam2, jr.backward_cam2)):
        assert a.shape == b.shape == (480, 640, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-3)


def test_rig_rectifier_rows_are_epipolar_and_zero_baseline_refused():
    """`test_rig_and_stats.py`'s checks on the port: a 3-D point projects
    to the same row in both rectified cameras (within 0.2 px), and a zero
    baseline is refused."""
    rig = TRig(**_rig_args(), device="cpu")
    assert rig.compute("minimal")
    RC2 = j_rod(jnp.asarray(rig.r.numpy()))
    t = rig.t.numpy()
    rng = np.random.default_rng(0)
    pts_c1 = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
    pts_c1[:, 2] += 6.0
    pts_c2 = (pts_c1 - t) @ np.asarray(RC2)

    def rect_project(pts, R, npp):
        q = pts @ R.numpy()
        return rig.reprojection_flen * q[:, :2] / q[:, 2:3] + npp.numpy()

    p1 = rect_project(pts_c1, rig.corr_r_cam1, rig.new_pp_cam1)
    p2 = rect_project(pts_c2, rig.corr_r_cam2, rig.new_pp_cam2)
    assert np.abs(p1[:, 1] - p2[:, 1]).max() < 0.2
    zero = TRig(np.zeros(3, np.float32), np.zeros(3, np.float32), 500.0,
                np.array([320.0, 240.0]), (640, 480), device="cpu")
    assert not zero.compute("minimal")


@pytest.mark.parametrize("cv", ["f32", "bf16"])
def test_rectified_chain_matches_jax(cv):
    """The rig scaled by 0.15 and cut to 96x64, with Brown distortion: `compute('minimal')`,
    `resample_image` of a random pair through both maps, the flagship's
    dense SGM (ZNCC 7x7, SGM-8, parabola; D = 16 on this width) and the
    covering share, in both packages.  Maps within 1e-3 px, rectified
    images within 1e-4; the WTA indices agree on >= 0.99 of the pixels
    (`test_torch_stereo.py`'s rule; where the f32 SGM's best two costs
    are more than 1e-4 apart, equal), the refined disparities within
    1e-4 where they agree (f32); the covering of one disparity within
    1e-5 in both packages, and the two chains' shares within 4 / (H W)
    a disagreeing pixel + 1e-5."""
    kw = _rig_args(0.15, True, (96, 64))
    jr, tr = JRig(**kw), TRig(**kw, device="cpu")
    assert jr.compute("minimal") and tr.compute("minimal")
    for a, b in ((tr.backward_cam1, jr.backward_cam1),
                 (tr.backward_cam2, jr.backward_cam2)):
        assert a.shape == b.shape == (64, 96, 2)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)
    rng = np.random.default_rng(21)
    L, R = (rng.uniform(0, 1, (64, 96)).astype(np.float32) for _ in range(2))
    jl = j_resample(jnp.asarray(L), jr.backward_cam1)
    jrr = j_resample(jnp.asarray(R), jr.backward_cam2)
    tl = t_resample(torch.from_numpy(L), tr.backward_cam1)
    trr = t_resample(torch.from_numpy(R), tr.backward_cam2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(trr.numpy(), np.asarray(jrr), atol=1e-4)
    jdt, tdt = ((jnp.float32, torch.float32) if cv == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    dj, ij, _ = (np.asarray(x) for x in j_dense(
        JMF.ZNCC, jl, jrr, 3, 3, 16, 0.1, 0.5, n_directions=8,
        cost_vol_radius=1, refine_kernel=JInterp.PARABOLA, cv_dtype=jdt))
    dt, it, _ = (x.numpy() for x in t_dense(
        TMF.ZNCC, tl, trr, 3, 3, 16, 0.1, 0.5, n_directions=8,
        cost_vol_radius=1, refine_kernel=TInterp.PARABOLA, cv_dtype=tdt))
    same = it == ij
    assert same.mean() >= 0.99, same.mean()
    if cv == "f32":
        from libstevi_tpu.ops import sgm_cost_volume as j_sgm
        from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
        vol = np.asarray(j_sgm(-j_box(JMF.ZNCC, jl, jrr, 3, 3, 16), 0.1, 0.5,
                               n_directions=8, backend="xla"))
        s = np.sort(vol, -1)
        clear = (s[..., 1] - s[..., 0]) > 1e-4
        np.testing.assert_array_equal(it[clear], ij[clear])
        f = np.isfinite(dj) & same
        np.testing.assert_array_equal(np.isnan(dt[same]), np.isnan(dj[same]))
        np.testing.assert_allclose(dt[f], dj[f], rtol=1e-4, atol=1e-4)
    one = float(TS.compute_covering_proportion(torch.from_numpy(dt),
                                               torch.from_numpy(dt)))
    assert abs(one - float(JS.compute_covering_proportion(
        jnp.asarray(dt), jnp.asarray(dt)))) <= 1e-5
    share_j = float(JS.compute_covering_proportion(jnp.asarray(dj),
                                                   jnp.asarray(dj)))
    assert abs(one - share_j) <= 4 * (1 - same.mean()) + 1e-5
