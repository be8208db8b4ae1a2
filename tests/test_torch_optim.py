"""The port's `optim` solvers against the JAX package's on the CPU, on the
same numpy-seeded inputs: the small-system solver against
`jnp.linalg.lstsq` (full-rank, rank-1 and all-zero batches), the L2,
spherical, L1 (IRLS) and least-median solvers (a singular subset too),
Huber, Gauss-Newton, RANSAC with the JAX draws replayed, BFGS, L0
smoothing, PCA and the assignment helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu import optim as J
from libstevi_tpu.optim import lmeds as jlmeds
from libstevi_tpu.optim.l0 import l0_smoothing as j_l0

from libstevi_tpu_torch import optim as T
from libstevi_tpu_torch.optim import lmeds as tlmeds
from libstevi_tpu_torch.optim.l0 import beta_schedule, l0_smoothing
from libstevi_tpu_torch.optim.lsq import small_lstsq

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _systems(kind, B, m, k, seed):
    """(B, m, k) matrices and (B, m) right-hand sides: full rank, rank 1
    (every column an exact multiple of the first) or all zero."""
    rng = np.random.default_rng(seed)
    b = rng.normal(size=(B, m)).astype(np.float32)
    if kind == "full":
        A = rng.normal(size=(B, m, k))
    elif kind == "rank1":
        v = rng.normal(size=(B, m, 1))
        A = v * np.array([1.0, 2.0, -0.5, 4.0, 0.25, -1.0, 8.0][:k])
    else:
        A = np.zeros((B, m, k))
    return A.astype(np.float32), b


@pytest.mark.parametrize("kind", ["full", "rank1", "zero"])
@pytest.mark.parametrize("m,k", [(49, 1), (49, 2), (49, 3), (25, 6),
                                 (4, 7), (7, 7)])
def test_small_lstsq_matches_jnp_lstsq(kind, m, k):
    """The minimum-norm solution of each system within rtol = atol = 1e-4
    of `jnp.linalg.lstsq` (JAX's float32 SVD with its eps * max(m, k)
    cutoff), rank-deficient and underdetermined systems included: no NaN
    and no garbage where the rank drops."""
    A, b = _systems(kind, 16, m, k, seed=m * 10 + k)
    want = np.stack([_np(jnp.linalg.lstsq(jnp.asarray(a), jnp.asarray(y))[0])
                     for a, y in zip(A, b)])
    got = small_lstsq(_t(A), _t(b))
    assert got.dtype == torch.float32 and got.shape == (16, k)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if kind == "zero":
        assert not got.any()


@pytest.mark.parametrize("n", [3, 4, 7, 9])
def test_jacobi_eigh_matches_numpy(n):
    """`jacobi_eigh` (the Gram route's eigen-solver) against numpy's
    float64 `eigh` on Gram matrices of 49 rows, rank-deficient ones (a
    column twice another, a column the sum of two) included: eigenvalues
    within 1e-12 of the largest, V orthonormal, V diag V^T = G."""
    from libstevi_tpu_torch.optim.lsq import jacobi_eigh
    rng = np.random.default_rng(n)
    A = rng.normal(size=(64, 49, n))
    A[:8, :, 1] = 2 * A[:8, :, 0]
    A[8:16, :, 2] = A[8:16, :, 0] + A[8:16, :, 1]
    G = np.einsum("bmi,bmj->bij", A, A)
    lam, V = jacobi_eigh(torch.from_numpy(G))
    scale = np.abs(G).max((-2, -1))[:, None]
    np.testing.assert_allclose(np.sort(lam.numpy(), -1) / scale,
                               np.linalg.eigvalsh(G) / scale, atol=1e-12)
    np.testing.assert_allclose((V.mT @ V).numpy(),
                               np.broadcast_to(np.eye(n), G.shape),
                               atol=1e-12)
    rec = (V @ torch.diag_embed(lam) @ V.mT).numpy()
    np.testing.assert_allclose(rec / scale[..., None], G / scale[..., None],
                               atol=1e-12)


def test_small_lstsq_keeps_nan_of_b():
    """NaN in b stays NaN (0 * NaN through the SVD in JAX), on every
    route."""
    for k in (1, 2, 3):
        A = torch.zeros(2, 5, k)
        b = torch.full((2, 5), float("nan"))
        assert torch.isnan(small_lstsq(A, b)).all()
        want = jnp.linalg.lstsq(jnp.zeros((5, k)), jnp.full(5, jnp.nan))[0]
        assert np.isnan(_np(want)).all()


@pytest.mark.parametrize("name", ["affine_best_l2_approximation",
                                  "spherical_affine_best_approximation",
                                  "affine_best_l1_approximation"])
@pytest.mark.parametrize("k", [2, 3, 7])
def test_best_approximations_match_jax(name, k):
    """Batched solves against the JAX solver vmapped over the same systems,
    rtol = atol = 1e-4 (the L1 IRLS at 1e-3: 30 reweighted solves compound
    float32 roundings), with a flat-window row (all columns equal) in the
    batch."""
    rng = np.random.default_rng(k)
    A = rng.normal(size=(12, 25, k)).astype(np.float32)
    b = (A @ rng.dirichlet(np.ones(k), 12)[..., None])[..., 0]
    b = (b + rng.normal(0, 0.05, b.shape)).astype(np.float32)
    A[3] = A[3, :, :1]                      # flat: every column the same
    want = _np(jax.vmap(getattr(J, name))(jnp.asarray(A), jnp.asarray(b)))
    got = getattr(T, name)(_t(A), _t(b)).numpy()
    tol = dict(rtol=1e-3, atol=1e-3) if "l1" in name else TOL
    np.testing.assert_allclose(got, want, **tol)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-4)


def test_spherical_zero_mean_flat_window_matches_jax():
    """Zero-mean flat target windows (two zero columns): the affine hull
    holds the origin and a_perp vanishes; JAX's float32 rounding gives g
    ~ 0, and so does the port (no 0 / 0 NaN)."""
    rng = np.random.default_rng(5)
    a = rng.normal(size=(25,)).astype(np.float32)
    A = np.stack([np.zeros(25), np.zeros(25), a], -1).astype(np.float32)
    b = rng.normal(size=(25,)).astype(np.float32)
    want = _np(J.spherical_affine_best_approximation(jnp.asarray(A),
                                                     jnp.asarray(b)))
    got = T.spherical_affine_best_approximation(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_least_squares_and_weighted_median_match_jax():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(30, 4)).astype(np.float32)
    b = rng.normal(size=30).astype(np.float32)
    np.testing.assert_allclose(T.least_squares(_t(A), _t(b)).numpy(),
                               _np(J.least_squares(jnp.asarray(A),
                                                   jnp.asarray(b))), **TOL)
    e = rng.normal(size=(6, 9)).astype(np.float32)
    e[0, :3] = e[0, 3]                                  # ties
    w = rng.uniform(0.1, 2, (6, 9)).astype(np.float32)
    assert np.array_equal(T.weighted_median(_t(e), _t(w)).numpy(),
                          _np(J.weighted_median(jnp.asarray(e),
                                                jnp.asarray(w))))


def test_least_absolute_differences_matches_jax():
    """IRLS with 30 fixed iterations, one gross outlier: 1e-3."""
    rng = np.random.default_rng(4)
    A = rng.normal(size=(40, 3)).astype(np.float32)
    b = (A @ np.array([1.0, -2.0, 0.5], np.float32)).astype(np.float32)
    b[7] += 50.0
    want = _np(J.least_absolute_differences(jnp.asarray(A), jnp.asarray(b)))
    got = T.least_absolute_differences(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_subsets_equal_jax():
    for n, k in ((9, 2), (49, 1), (25, 3), (49, 6)):
        assert np.array_equal(tlmeds._subsets(n, k), jlmeds._subsets(n, k))


@pytest.mark.parametrize("case", ["default", "square", "lstsq", "singular"])
def test_least_absolute_median_matches_jax(case):
    """LMedS over the JAX package's subsets: the default sampled subsets,
    caller-supplied square ones, larger ones (least squares), and square
    blocks that stay singular in float32 (duplicate rows: JAX's solve
    returns inf / NaN there, `solve_ex` the same, and the first NaN
    median wins in both).  1e-4."""
    rng = np.random.default_rng(11)
    n, k = 15, 2
    A = rng.normal(size=(n, k)).astype(np.float32)
    b = (A @ np.array([0.7, -1.1], np.float32)
         + rng.normal(0, 0.01, n)).astype(np.float32)
    b[:4] += 5.0
    sub = None
    if case == "square":
        sub = np.asarray([[0, 5], [3, 9], [6, 12], [2, 14]], np.int32)
    elif case == "lstsq":
        sub = np.asarray([[0, 5, 8], [4, 9, 11], [6, 12, 13]], np.int32)
    elif case == "singular":
        A[1] = A[0]
        b[1] = b[0]
        sub = np.asarray([[6, 12], [0, 1], [4, 9]], np.int32)
    want = _np(J.least_absolute_median(jnp.asarray(A), jnp.asarray(b), sub))
    got = T.least_absolute_median(_t(A), _t(b), sub).numpy()
    np.testing.assert_allclose(got, want, equal_nan=True, **TOL)
    # batched: the same systems stacked, each solved alike
    got_b = T.least_absolute_median(_t(np.stack([A, A])), _t(np.stack([b, b])),
                                    sub).numpy()
    np.testing.assert_allclose(got_b, np.stack([want, want]), equal_nan=True,
                               **TOL)


def test_affine_least_median_matches_jax():
    rng = np.random.default_rng(12)
    A = rng.normal(size=(6, 16, 3)).astype(np.float32)
    b = (A @ np.array([0.2, 0.3, 0.5], np.float32)).astype(np.float32)
    b[:, :3] += 4.0
    want = _np(jax.vmap(J.affine_best_least_median_approximation)(
        jnp.asarray(A), jnp.asarray(b)))
    got = T.affine_best_least_median_approximation(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_huber_family_matches_jax():
    r = np.linspace(-3, 3, 41).astype(np.float32)
    for name in ("huber_loss", "pseudo_huber_loss", "sqrt_huber_loss"):
        np.testing.assert_allclose(getattr(T, name)(_t(r), 0.7).numpy(),
                                   _np(getattr(J, name)(jnp.asarray(r), 0.7)),
                                   rtol=1e-6, atol=1e-6)
    from libstevi_tpu.optim.huber import huber_weight as jw
    from libstevi_tpu_torch.optim.huber import huber_weight as tw
    np.testing.assert_allclose(tw(_t(r), 0.7).numpy(),
                               _np(jw(jnp.asarray(r), 0.7)), rtol=1e-6)


@pytest.mark.parametrize("huber", [None, 0.5])
def test_gauss_newton_matches_jax(huber):
    """An exponential fit (with 5 gross outliers under Huber): x, the
    solution history, the residual norm and the status, 1e-4."""
    t = np.linspace(0, 1, 40).astype(np.float32)
    y = (2.0 * np.exp(-1.3 * t)).astype(np.float32)
    if huber:
        y[:5] += 3.0

    def jres(p, t, y):
        return p[0] * jnp.exp(p[1] * t) - y

    def tres(p, t, y):
        return p[0] * torch.exp(p[1] * t) - y

    want = J.GaussNewton(jres, iters=20, huber_delta=huber).solve(
        jnp.asarray([1.0, 0.0]), jnp.asarray(t), jnp.asarray(y))
    got = T.GaussNewton(tres, iters=20, huber_delta=huber).solve(
        torch.tensor([1.0, 0.0]), _t(t), _t(y))
    np.testing.assert_allclose(got.x.numpy(), _np(want.x), **TOL)
    np.testing.assert_allclose(got.history.numpy(), _np(want.history), **TOL)
    np.testing.assert_allclose(float(got.residual_norm),
                               float(want.residual_norm), **TOL)
    assert got.history.shape == (21, 2)
    assert got.status.name == want.status.name
    assert bool(got.converged) == bool(want.converged)


def test_ransac_with_jax_draws_matches_jax():
    """A line fit with 35% outliers: the port replays JAX's index sets
    (`jax.random.split` + `choice`) through ``draw`` and picks the same
    hypothesis; the model after the weighted refit within 1e-4, the
    inlier masks equal."""
    rng = np.random.default_rng(7)
    N, it = 200, 48
    x = rng.uniform(-1, 1, N).astype(np.float32)
    y = 2.5 * x + 0.7
    out = rng.random(N) < 0.35
    y = np.where(out, rng.uniform(-10, 10, N), y).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def jfit(sub):
        A = jnp.stack([sub[0], jnp.ones_like(sub[0])], -1)
        return jnp.linalg.lstsq(A, sub[1])[0]

    def jrefit(d, w):
        A = jnp.stack([d[0], jnp.ones_like(d[0])], -1) * w[:, None]
        return jnp.linalg.lstsq(A, d[1] * w)[0]

    def tfit(sub):
        A = torch.stack([sub[0], torch.ones_like(sub[0])], -1)
        return T.least_squares(A, sub[1])

    def trefit(d, w):
        A = torch.stack([d[0], torch.ones_like(d[0])], -1) * w[:, None]
        return T.least_squares(A, d[1] * w)

    def jres(m, d):
        return m[0] * d[0] + m[1] - d[1]

    def tres(m, d):
        return m[0] * d[0] + m[1] - d[1]

    sets = np.stack([_np(jax.random.choice(k, N, (2,), replace=False))
                     for k in jax.random.split(key, it)])
    for jr, tr in ((None, None), (jrefit, trefit)):
        want = J.ransac(jfit, jres, (jnp.asarray(x), jnp.asarray(y)), 2, it,
                        0.05, key=key, refit_fn=jr)
        got = T.ransac(tfit, tres, (_t(x), _t(y)), 2, it, 0.05,
                       refit_fn=tr, draw=lambda: sets)
        np.testing.assert_allclose(got.model.numpy(), _np(want.model), **TOL)
        assert np.array_equal(got.inliers.numpy(), _np(want.inliers))
        assert int(got.n_inliers) == int(want.n_inliers)


def test_ransac_generator_draws_are_distinct_and_fit():
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, 300).astype(np.float32)
    y = (1.5 * x - 0.2).astype(np.float32)
    y[rng.random(300) < 0.3] = 9.0
    gen = torch.Generator().manual_seed(1)
    from libstevi_tpu_torch.optim.ransac import draw_index_sets
    sets = draw_index_sets(5, 4, 200, gen)
    assert (torch.sort(sets, 1).values.diff(dim=1) > 0).all()
    res = T.ransac(lambda s: T.least_squares(
        torch.stack([s[0], torch.ones_like(s[0])], -1), s[1]),
        lambda m, d: m[0] * d[0] + m[1] - d[1], (_t(x), _t(y)), 2, 32, 0.01,
        generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(res.model.numpy(), [1.5, -0.2], atol=1e-4)


def test_bfgs_matches_jax():
    """Rosenbrock from (-1.2, 1): x, f and the iteration count."""
    def jf(x):
        return (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2

    want = J.bfgs_minimize(jf, jnp.asarray([-1.2, 1.0]), iters=60)
    got = T.bfgs_minimize(jf, torch.tensor([-1.2, 1.0]), iters=60)
    np.testing.assert_allclose(got.x.numpy(), _np(want.x), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(float(got.f), float(want.f), atol=1e-4)
    assert bool(got.converged) == bool(want.converged)


@pytest.mark.parametrize("color", [False, True], ids=["gray", "rgb"])
def test_l0_smoothing_matches_jax(color):
    """Piecewise-constant patches plus noise at 24x32: the beta schedule
    equals the JAX loop's count, and the result agrees within 1e-3 on
    >= 0.99 of the values (a threshold decision can flip on a rounding
    of the FFTs)."""
    rng = np.random.default_rng(9)
    img = np.zeros((24, 32, 3) if color else (24, 32), np.float32)
    img[4:14, 6:20] = 0.8
    img[16:, 18:] = 0.3
    img = (img + rng.normal(0, 0.03, img.shape)).astype(np.float32)
    assert len(beta_schedule(0.02, 2.0, 1e5)) == 22
    want = _np(j_l0(jnp.asarray(img)))
    got = l0_smoothing(_t(img)).numpy()
    assert got.shape == want.shape
    close = np.isclose(got, want, rtol=0, atol=1e-3)
    assert close.mean() >= 0.99, close.mean()


def test_pca_and_affine_space_match_jax():
    rng = np.random.default_rng(10)
    d = (rng.normal(size=(100, 1)) * np.array([[3.0, 1.0, 0.5]])
         + rng.normal(size=(100, 3)) * 0.1).astype(np.float32)
    wc, ws, wm = J.principal_components(jnp.asarray(d), 2)
    gc, gs, gm = T.principal_components(_t(d), 2)
    np.testing.assert_allclose(gs.numpy(), _np(ws), **TOL)
    np.testing.assert_allclose(gm.numpy(), _np(wm), **TOL)
    for g, w in zip(gc.numpy(), _np(wc)):        # each up to its sign
        assert min(np.abs(g - w).max(), np.abs(g + w).max()) < 1e-4
    A = rng.normal(size=(5, 4)).astype(np.float32)
    ja, ta = J.AffineSpace(jnp.asarray(A)), T.AffineSpace(_t(A))
    np.testing.assert_allclose(ta.M.numpy(), _np(ja.M))
    np.testing.assert_allclose(ta.b.numpy(), _np(ja.b))
    al = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_allclose(ta.full_coeffs(_t(al)).numpy(),
                               _np(ja.full_coeffs(jnp.asarray(al))))


def test_assignment_matches_jax():
    from libstevi_tpu.optim.assignment import match_descriptors as jm
    from libstevi_tpu_torch.optim.assignment import match_descriptors as tm
    rng = np.random.default_rng(13)
    c = rng.uniform(size=(6, 6))
    for a, b in zip(T.optimal_assignment(c), J.optimal_assignment(c)):
        assert np.array_equal(a, b)
    assert np.array_equal(T.extend_cost_for_n_best(c, 3),
                          J.extend_cost_for_n_best(c, 3))
    da, db = rng.normal(size=(5, 8)), rng.normal(size=(7, 8))
    for a, b in zip(tm(da, db), jm(da, db)):
        assert np.array_equal(a, b)
