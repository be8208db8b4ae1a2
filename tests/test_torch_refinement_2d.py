"""The port's 2-D subpixel refinement against the JAX package on the CPU:
the isotropic and anisotropic line fits and the 9-point patch fit, with
the three peak kernels, on bowls with noise (COST and SCORE volumes), and
the large-delta guard (`tests/test_refinement.py`'s cases)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.ops.refinement import (
    InterpolationKernel as JKernel, IsotropyHypothesis as JIso,
    refine_disp_2d_cost_interpolation as j_refine2d,
    refine_disp_2d_cost_patch_interpolation as j_patch)

from libstevi_tpu_torch.ops.refinement import (
    InterpolationKernel, IsotropyHypothesis, _PATCH_PINV,
    refine_disp_2d_cost_interpolation, refine_disp_2d_cost_patch_interpolation)
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _bowls(seed, r0, r1, score, H=9, W=12):
    """(H, W, 2r0+1, 2r1+1) bowls around per-pixel sub-slot optima (some
    anisotropic, some with a cross term), plus noise; a positive COST
    volume, or its negation as a SCORE volume; and int32 raw indices."""
    rng = np.random.default_rng(seed)
    a0 = np.arange(-r0, r0 + 1)[:, None]
    a1 = np.arange(-r1, r1 + 1)[None, :]
    c0, c1 = (rng.uniform(-0.45, 0.45, (H, W, 1, 1)) for _ in range(2))
    k0, k1 = (rng.uniform(0.5, 2.0, (H, W, 1, 1)) for _ in range(2))
    x = rng.uniform(-0.3, 0.3, (H, W, 1, 1))
    q = (k0 * (a0 - c0) ** 2 + k1 * (a1 - c1) ** 2
         + x * (a0 - c0) * (a1 - c1) + 0.5)
    q = q + rng.normal(0, 0.01, q.shape)
    tcv = (-q if score else q).astype(np.float32)
    raw = rng.integers(0, 30, (H, W, 2)).astype(np.int32)
    return tcv, raw


@pytest.mark.parametrize("score", [False, True], ids=["cost", "score"])
@pytest.mark.parametrize("radii", [(1, 1), (2, 1), (2, 2)],
                         ids=["r1", "r2x1", "r2"])
@pytest.mark.parametrize("iso", ["ISOTROPIC", "ANISOTROPIC"])
@pytest.mark.parametrize("kernel", ["PARABOLA", "EQUIANGULAR", "GAUSSIAN"])
def test_refine_2d_matches_jax(kernel, iso, radii, score):
    """(H, W, 2) refined disparities within 1e-5 of JAX (the anisotropic
    fit's tie-last argopt and line fits included; NaN from a Gaussian's
    log of a SCORE volume trips the guard in both)."""
    tcv, raw = _bowls(sum(radii) + 7 * score, *radii, score)
    want = np.asarray(j_refine2d(JKernel[kernel], jnp.asarray(tcv),
                                 jnp.asarray(raw), JIso[iso]))
    got = refine_disp_2d_cost_interpolation(
        InterpolationKernel[kernel], _t(tcv), _t(raw),
        IsotropyHypothesis[iso]).numpy()
    assert got.shape == want.shape == tcv.shape[:2] + (2,)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("score", [False, True], ids=["cost", "score"])
@pytest.mark.parametrize("radii", [(1, 1), (2, 2)], ids=["r1", "r2"])
@pytest.mark.parametrize("kernel", ["PARABOLA", "GAUSSIAN"])
def test_patch_refinement_matches_jax(kernel, radii, score):
    """The 9-point quadratic patch fit within 1e-5 of JAX; its constant
    pseudo-inverse equals JAX's."""
    from libstevi_tpu.ops.refinement import _PATCH_PINV as J_PINV
    np.testing.assert_array_equal(_PATCH_PINV, J_PINV)
    tcv, raw = _bowls(3 + sum(radii) + score, *radii, score)
    want = np.asarray(j_patch(JKernel[kernel], jnp.asarray(tcv),
                              jnp.asarray(raw)))
    got = refine_disp_2d_cost_patch_interpolation(
        InterpolationKernel[kernel], _t(tcv), _t(raw)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_patch_refinement_refuses_equiangular():
    tcv = torch.ones(1, 1, 3, 3)
    with pytest.raises(ValueError):
        refine_disp_2d_cost_patch_interpolation(
            InterpolationKernel.EQUIANGULAR, tcv, torch.zeros(1, 1, 2))


@pytest.mark.parametrize("fit", ["isotropic", "anisotropic", "patch"])
def test_large_delta_guard_zeroes_both(fit):
    """A planar patch has no peak: the fitted deltas leave (-1, 1) or are
    NaN, so both are zeroed and the raw disparity comes back, as in JAX
    (`tests/test_refinement.py`)."""
    patch = np.linspace(0, 1, 9).reshape(1, 1, 3, 3).astype(np.float32)
    raw = np.full((1, 1, 2), 4, np.int32)
    k = JKernel.PARABOLA
    if fit == "patch":
        want = j_patch(k, jnp.asarray(patch), jnp.asarray(raw))
        got = refine_disp_2d_cost_patch_interpolation(
            to_port(k), _t(patch), _t(raw))
    else:
        iso = JIso[fit.upper()]
        want = j_refine2d(k, jnp.asarray(patch), jnp.asarray(raw), iso)
        got = refine_disp_2d_cost_interpolation(to_port(k), _t(patch),
                                                _t(raw), to_port(iso))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), 4.0)


@pytest.mark.parametrize("iso", ["ISOTROPIC", "ANISOTROPIC"])
def test_separable_quadratic_is_recovered(iso):
    """The port alone: a separable quadratic's optimum (0.2, -0.3)."""
    a = np.arange(-2, 3)
    q = (a[:, None] - 0.2) ** 2 + (a[None, :] + 0.3) ** 2 + 0.1
    got = refine_disp_2d_cost_interpolation(
        InterpolationKernel.PARABOLA, _t(q[None, None].astype(np.float32)),
        torch.zeros(1, 1, 2, dtype=torch.int32), IsotropyHypothesis[iso])
    np.testing.assert_allclose(got[0, 0].numpy(), [0.2, -0.3], atol=1e-4)


def test_even_or_flat_windows_are_refused():
    raw = torch.zeros(1, 1, 2)
    for shape in ((1, 1, 4, 3), (1, 1, 1, 3)):
        with pytest.raises(ValueError):
            refine_disp_2d_cost_interpolation(InterpolationKernel.PARABOLA,
                                              torch.ones(shape), raw)
