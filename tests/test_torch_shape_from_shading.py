"""The port's shape from shading against the JAX package's on the CPU, on
`TestShapeFromShadingReference`'s rendered dome (48x48) and the legacy
surface's: the light direction within 1e-5, normal maps within 1e-3, the
height maps within 1e-2 of their range, the edge masks exactly; each
hand-written stencil adjoint (`jax.linear_transpose` in the JAX package)
checked for adjointness."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_imageproc_pipelines as pipelines

# the modules' names are shadowed by the functions `shape_from_shading`
J = importlib.import_module("libstevi_tpu.imageproc.shape_from_shading")
T = importlib.import_module("libstevi_tpu_torch.imageproc.shape_from_shading")

torch.set_num_threads(2)

NORMAL_TOL = dict(rtol=0, atol=1e-3)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x)


def _dome(light=(0.35, 0.15, 0.92)):
    return pipelines.TestShapeFromShadingReference._dome(light=light)


@pytest.mark.parametrize("case", ["dome", "dome_left", "ramp", "ramp_flip"])
def test_light_direction_matches_jax(case):
    """The 2x2 eigenvector's sign is arbitrary in either library; the
    centroid test fixes it.  Each case's intensity centroid lies >= 0.5 px
    from the image centre along the estimated direction (the ramps' ~4
    px), so the test's dot product is far from 0 against the packages'
    rounding: atol 1e-5, and a mirrored image flips the direction."""
    if case.startswith("dome"):
        s = _dome((-0.35, 0.15, 0.92) if case == "dome_left" else
                  (0.35, 0.15, 0.92))[0]
    else:
        jj = np.mgrid[0:48, 0:48][1].astype(np.float32)
        s = 0.2 + 0.6 * jj / 48
        if case == "ramp_flip":
            s = s[:, ::-1]
    want = _np(J.estimate_light_direction_from_shading(jnp.asarray(s)))
    got = T.estimate_light_direction_from_shading(_t(s)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    H, W = s.shape
    ii, jj = np.mgrid[0:H, 0:W]
    c = np.array([(ii * s).sum(), (jj * s).sum()]) / s.sum() - [H / 2, W / 2]
    assert abs(c @ np.array([got[1], -got[0]])) >= 0.5
    if case == "ramp":
        np.testing.assert_allclose(got, [-1.0, 0.0, 1.0], atol=1e-3)
    if case == "ramp_flip":
        np.testing.assert_allclose(got, [1.0, 0.0, 1.0], atol=1e-3)


def test_initial_estimate_matches_jax():
    """The row loop (JAX's `lax.scan`): the same root at every pixel, the
    normals within 1e-3, z >= 0 and unit norm."""
    s, _, lhat, _ = _dome()
    want = _np(J.initial_normal_map_estimate(jnp.asarray(s),
                                             jnp.asarray(lhat)))
    got = T.initial_normal_map_estimate(_t(s), _t(lhat)).numpy()
    np.testing.assert_allclose(got, want, **NORMAL_TOL)
    assert (got[..., 2] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-4)


def test_single_shading_solver_matches_jax():
    s, n_true, lhat, _ = _dome()
    want = _np(J.normal_map_from_single_shading_image(
        jnp.asarray(s), jnp.asarray(lhat), n_iter=30))
    got = T.normal_map_from_single_shading_image(_t(s), _t(lhat),
                                                 n_iter=30).numpy()
    np.testing.assert_allclose(got, want, **NORMAL_TOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_intrinsic_decomposition_solver_matches_jax():
    """The edge-guided solver (30 Gauss-Newton steps of up to 80 CG
    steps, each loop stopping on its float32 test as JAX's `while_loop`
    does) from the initial estimate."""
    s, _, lhat, _ = _dome()
    guide = np.stack([s] * 3, -1)
    want = _np(J.normal_map_from_intrinsic_decomposition(
        jnp.asarray(s), jnp.asarray(guide), jnp.asarray(lhat), n_iter=30))
    got = T.normal_map_from_intrinsic_decomposition(
        _t(s), _t(guide), _t(lhat), n_iter=30).numpy()
    np.testing.assert_allclose(got, want, **NORMAL_TOL)


@pytest.mark.parametrize("case", ["step", "dome_rgb", "flat"])
def test_gradient_based_edges_match_jax(case):
    """The sign-aligned channel gradients and the linear-interpolated
    quantile threshold: mask equal, gradients within 1e-5 (a flat image:
    quantile 0, no edge)."""
    if case == "step":
        g = np.zeros((40, 40, 3), np.float32)
        g[:, 20:] = 1.0
    elif case == "dome_rgb":
        s = _dome()[0]
        g = np.stack([s, s[::-1], s.T], -1) + np.random.default_rng(2) \
            .normal(0, 0.01, (48, 48, 3)).astype(np.float32)
    else:
        g = np.full((24, 24, 3), 0.3, np.float32)
    for prop in (0.05, 0.1):
        jm, jg = J.gradient_based_edges(jnp.asarray(g), prop)
        tm, tg = T.gradient_based_edges(_t(g), prop)
        np.testing.assert_array_equal(tm.numpy(), _np(jm))
        np.testing.assert_allclose(tg.numpy(), _np(jg), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("q", [0.0, 0.37, 0.95, 1.0])
def test_linear_quantile_matches_jnp(q):
    x = np.random.default_rng(3).normal(size=(17, 23)).astype(np.float32)
    assert T._linear_quantile(_t(x), q).item() == float(
        jnp.quantile(jnp.asarray(x).ravel(), q))
    x[3, 4] = np.nan
    assert np.isnan(T._linear_quantile(_t(x), q).item())


def test_post_processing_matches_jax():
    """Rectification (the mean normal made vertical), the least-squares
    height (CG until 1e-8 or 4 (H + W) steps) within 1e-2 of its range,
    and the plane flattening, with and without the convexity vote."""
    _, n_true, _, _ = _dome()
    tilted = np.broadcast_to(np.asarray([0.3, 0.2, 0.93], np.float32),
                             (32, 32, 3))
    mask = np.ones((32, 32), bool)
    np.testing.assert_allclose(
        T.rectify_normal_map(_t(tilted), _t(mask)).numpy(),
        _np(J.rectify_normal_map(jnp.asarray(tilted), jnp.asarray(mask))),
        rtol=0, atol=1e-5)
    want_h = _np(J.height_from_normal_map(jnp.asarray(n_true)))
    got_h = T.height_from_normal_map(_t(n_true)).numpy()
    np.testing.assert_allclose(got_h, want_h, rtol=0,
                               atol=1e-2 * np.ptp(want_h))
    assert abs(got_h[0, 0]) < 1e-3
    H = W = 48
    ii, jj = np.mgrid[0:H, 0:W].astype(np.float64)
    r2 = (ii - H / 2) ** 2 + (jj - W / 2) ** 2
    disk = r2 < (H * 0.4) ** 2
    plane = (0.2 * ii + 0.1 * jj + 3 + np.exp(-r2 / 50)).astype(np.float32)
    for h, m in ((plane, disk), (want_h, np.ones((H, W), bool))):
        for convex in (False, True):
            want = _np(J.flatten_height_map_in_area_of_interest(
                jnp.asarray(h), jnp.asarray(m), convex))
            got = T.flatten_height_map_in_area_of_interest(
                _t(h), _t(m), convex).numpy()
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-2 * np.ptp(want))
            assert (got[~m] == 0).all()


def test_legacy_surface_matches_jax():
    """`TestShapeFromShading`'s dome: the known-normals light (JAX's
    minimum-norm lstsq), the linearized initial normals, 150 steps of the
    projected gradient descent (autograd for `jax.grad`) and the
    Frankot-Chellappa integration; `shape_from_shading` chains them."""
    rng = np.random.default_rng(42)
    n = rng.normal(size=(100, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    L = np.array([0.3, -0.2, 0.9], np.float32)
    I = (n @ L).astype(np.float32)
    n = n.astype(np.float32)
    np.testing.assert_allclose(
        T.estimate_light_direction(_t(I), _t(n)).numpy(),
        _np(J.estimate_light_direction(jnp.asarray(I), jnp.asarray(n))),
        rtol=0, atol=1e-5)

    _, nd = pipelines.TestShapeFromShading()._dome()
    nd = nd.astype(np.float32)
    light = np.array([0.3, 0.1, 0.95], np.float32)
    light /= np.linalg.norm(light)
    img = np.clip(nd @ light, 0, 1).astype(np.float32)
    n0j = J.initial_normal_map(jnp.asarray(img), jnp.asarray(light))
    n0t = T.initial_normal_map(_t(img), _t(light))
    np.testing.assert_allclose(n0t.numpy(), _np(n0j), **NORMAL_TOL)
    nrj = J.refine_normals(jnp.asarray(img), n0j, light, iters=150)
    nrt = T.refine_normals(_t(img), n0t, light, iters=150)
    np.testing.assert_allclose(nrt.numpy(), _np(nrj), **NORMAL_TOL)
    hj = _np(J.integrate_normals(jnp.asarray(nd)))
    ht = T.integrate_normals(_t(nd)).numpy()
    np.testing.assert_allclose(ht, hj, rtol=0, atol=1e-2 * np.ptp(hj))
    nt, htt = T.shape_from_shading(_t(img), light, iters=20)
    nj, hjj = J.shape_from_shading(jnp.asarray(img), light, iters=20)
    np.testing.assert_allclose(nt.numpy(), _np(nj), **NORMAL_TOL)
    np.testing.assert_allclose(htt.numpy(), _np(hjj), rtol=0,
                               atol=1e-2 * np.ptp(_np(hjj)))


@pytest.mark.parametrize("op,adj,shape", [
    ("_dr", "_drT", (7, 5, 3)), ("_dr", "_drT", (1, 4, 3)),
    ("_dr", "_drT", (2, 3, 3)), ("_dc", "_dcT", (5, 7, 3)),
    ("_dc", "_dcT", (4, 1, 3)), ("_gx", "_gxT", (6, 9)),
    ("_gy", "_gyT", (9, 6)), ("_gx", "_gxT", (1, 2))])
def test_stencil_adjoints(op, adj, shape):
    """<A x, y> = <x, A^T y> in float64 for each hand-written adjoint,
    and A^T equals `jax.linear_transpose` of the JAX stencil (where the
    JAX package has one of that name)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=shape))
    Ax = getattr(T, op)(x)
    y = torch.from_numpy(rng.normal(size=tuple(Ax.shape)))
    ATy = getattr(T, adj)(y)
    assert ATy.shape == x.shape
    assert abs(float((Ax * y).sum()) - float((x * ATy).sum())) <= 1e-10
    if hasattr(J, op):
        import jax
        jt = jax.linear_transpose(getattr(J, op),
                                  jnp.zeros(shape, jnp.float32))
        y32 = y.numpy().astype(np.float32)
        np.testing.assert_allclose(
            getattr(T, adj)(torch.from_numpy(y32)).numpy(),
            _np(jt(jnp.asarray(y32))[0]), rtol=1e-6, atol=1e-6)
