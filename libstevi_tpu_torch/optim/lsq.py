"""L2 and spherical best-approximation solvers (counterpart of
`libstevi_tpu/optim/lsq.py`), and `small_lstsq`, the one small-system
solver every solver of the package calls.

Reference parity: `optimization/l2optimization.h:36-64` (`leastSquares`;
`affineBestL2Approximation`: min ||Ax-b|| s.t. sum(x)=1 by substituting
the last coefficient) and `optimization/sphericaloptimization.h:36-66`
(`sphericalAffineBestApproximation`: closed-form best direction on the unit
sphere within the affine constraint, the barycentric hook of the NCC/ZNCC
refinement traits, `matching_costs.h:436-439`).

All solvers broadcast over leading batch dimensions: the per-pixel solves
of the image refinement are one call over (H * W) systems.
"""

from __future__ import annotations

import torch


def small_lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Minimum-norm least-squares solution of A (..., m, k) x = b (..., m),
    the JAX package's `jnp.linalg.lstsq`: singular values below
    ``eps * max(m, k)`` times the largest (eps of A's type) count as zero,
    so a rank-deficient system gives its minimum-norm solution and an
    all-zero one gives 0 (NaN in b stays NaN, as through an SVD).

    The same arithmetic on every device, in float64, cast back to A's
    type: a closed form for k = 1 and k = 2, else the Gram matrix A^T A
    (k x k) diagonalized by `jacobi_eigh`, the cutoff applied to the
    square roots of its eigenvalues.  Library routines do not serve:
    `torch.linalg.lstsq`'s CUDA driver (gels) assumes full rank and
    returns garbage without raising on a rank-deficient system; the
    batched `torch.linalg.eigh` (cuSOLVER's syevBatched) refuses batches
    of 32768 matrices and more, and `torch.linalg.svd` of (49, k)
    matrices takes ~300 us a matrix on an H100 (`PERF.md` §6)."""
    m, k = A.shape[-2:]
    rcond = torch.finfo(A.dtype).eps * max(m, k)
    a = A.double()
    c = _atb(a, b.double())
    if k == 1:
        g = _dot(a[..., 0], a[..., 0])
        inv = torch.where(g > 0, 1.0 / torch.where(g > 0, g, 1.0), 0.0)
        x = c * inv[..., None]
    elif k == 2:
        x = _lstsq2(a, c, rcond)
    else:
        G = gram(a, a)
        bad = ~torch.isfinite(G).all(-1).all(-1)
        lam, V = jacobi_eigh(torch.where(bad[..., None, None], 0.0, G))
        lam = lam.clamp_min(0.0)
        s = lam.sqrt()
        keep = (s > 0) & (s >= rcond * s.amax(-1, keepdim=True))
        inv = torch.where(keep, 1.0 / torch.where(keep, lam, 1.0), 0.0)
        x = _matvec(V, inv * _atb(V, c))
        x = torch.where(bad[..., None], float("nan"), x)
    return x.to(A.dtype)


def _round_robin(n: int):
    """The n - 1 rounds of n / 2 disjoint (p, q) pairs (n even) that meet
    every pair once: the circle method."""
    rest = list(range(1, n))
    rounds = []
    for _ in range(n - 1):
        order = [0] + rest
        rounds.append([(min(order[i], order[n - 1 - i]),
                        max(order[i], order[n - 1 - i]))
                       for i in range(n // 2)])
        rest = rest[-1:] + rest[:-1]
    return rounds


def jacobi_sweeps(n: int) -> int:
    """Fixed sweep counts with a margin: the off-diagonal mass of Gram
    matrices of 49 rows reaches float64 rounding after 4 sweeps at n <= 4
    and 7 at n <= 10 (rank-deficient ones included)."""
    return 5 if n <= 4 else 8 if n <= 10 else 12


def jacobi_eigh(G: torch.Tensor):
    """Eigenvalues (..., n) and eigenvectors (..., n, n) (columns, in no
    particular order) of symmetric matrices G (..., n, n) by cyclic
    Jacobi rotations (Golub & Van Loan, Algorithm 8.4.3), the n / 2
    disjoint rotations of a round-robin round applied at once to the
    rows, then the columns: elementwise torch ops only, so the same
    arithmetic on every device and any batch size.  A fixed count of
    sweeps, each meeting every off-diagonal pair once (`jacobi_sweeps`:
    the off-diagonal mass falls quadratically), and no host sync."""
    n = G.shape[-1]
    odd = n % 2
    if odd:
        G = torch.nn.functional.pad(G, (0, 1, 0, 1))
    N = n + odd
    batch = G.shape[:-2]
    G = G.reshape(-1, N, N)
    V = torch.eye(N, dtype=G.dtype, device=G.device).expand_as(G).clone()
    rounds = [tuple(torch.tensor(v, device=G.device) for v in zip(*r))
              for r in _round_robin(N)]
    for _ in range(jacobi_sweeps(N)):
        for P, Q in rounds:
            app, aqq, apq = G[:, P, P], G[:, Q, Q], G[:, P, Q]
            rot = apq != 0
            tau = (aqq - app) / (2.0 * torch.where(rot, apq, 1.0))
            t = (torch.where(tau >= 0, 1.0, -1.0)
                 / (tau.abs() + torch.sqrt(1.0 + tau * tau)))
            t = torch.where(rot & torch.isfinite(t), t, 0.0)
            cs = 1.0 / torch.sqrt(1.0 + t * t)
            sn = t * cs
            # G <- J^T G J and V <- V J, J = [[c, s], [-s, c]] on (p, q)
            G = _rotate(_rotate(G, P, Q, cs, sn, -2), P, Q, cs, sn, -1)
            V = _rotate(V, P, Q, cs, sn, -1)
    lam = torch.diagonal(G, dim1=-2, dim2=-1)
    if odd:
        lam, V = lam[:, :n], V[:, :n, :n]
    return lam.reshape(batch + (n,)), V.reshape(batch + (n, n))


def _rotate(X, P, Q, cs, sn, dim):
    """Rows (dim -2) or columns (dim -1) P, Q of X (B, N, N) rotated:
    x_p <- c x_p - s x_q, x_q <- s x_p + c x_q, one (c, s) a pair."""
    c, s = cs[:, :, None], sn[:, :, None]
    if dim == -1:
        X = X.mT
    xp, xq = X[:, P], X[:, Q]
    out = torch.empty_like(X)
    out[:, P] = c * xp - s * xq
    out[:, Q] = s * xp + c * xq
    return out.mT if dim == -1 else out


def _lstsq2(a: torch.Tensor, c: torch.Tensor, rcond: float) -> torch.Tensor:
    """`small_lstsq` for two unknowns: the 2 x 2 Gram matrix
    [[p, q], [q, r]]'s eigenvalues in closed form; both kept, the inverse;
    one kept, the projection on its eigenvector; none, 0 (times A^T b)."""
    p = _dot(a[..., 0], a[..., 0])
    q = _dot(a[..., 0], a[..., 1])
    r = _dot(a[..., 1], a[..., 1])
    c0, c1 = c[..., 0], c[..., 1]
    half = 0.5 * (p - r)
    disc = torch.sqrt(half * half + q * q)
    lam1 = 0.5 * (p + r) + disc
    det = p * r - q * q
    lam2 = torch.where(lam1 > 0, det / torch.where(lam1 > 0, lam1, 1.0),
                       0.0).clamp_min(0.0)
    s1, s2 = lam1.clamp_min(0.0).sqrt(), lam2.sqrt()
    both = (s2 > 0) & (s2 >= rcond * s1)
    one = ~both & (s1 > 0)
    # both kept: G^-1 c through the adjugate
    dsafe = torch.where(both, det, 1.0)
    x_both = torch.stack([(r * c0 - q * c1) / dsafe,
                          (p * c1 - q * c0) / dsafe], -1)
    # one kept: v (v . c) / lam1, v the unit eigenvector of lam1 (the
    # larger of its two expressions, for stability)
    va = torch.stack([q, lam1 - p], -1)
    vb = torch.stack([lam1 - r, q], -1)
    na, nb = va.norm(dim=-1), vb.norm(dim=-1)
    v = torch.where((na >= nb)[..., None], va, vb)
    nv = torch.maximum(na, nb)
    v = v / torch.where(nv > 0, nv, 1.0)[..., None]
    proj = (v * c).sum(-1) / torch.where(one, lam1, 1.0)
    x_one = v * proj[..., None]
    return torch.where(both[..., None], x_both,
                       torch.where(one[..., None], x_one, 0.0 * c))


def least_squares(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """argmin_x ||Ax - b||_2 (minimum-norm for underdetermined systems)."""
    return small_lstsq(A, b)


def _affine_parts(A: torch.Tensor):
    """Affine-constraint substitution with the LAST column as reference
    (referenceId = -1, `l2optimization.h:54`): x = e_n + spread(alpha),
    A x = M alpha + b0 where M = A[:, :-1] - A[:, -1:] and b0 = A[:, -1]."""
    M = A[..., :, :-1] - A[..., :, -1:]
    b0 = A[..., :, -1]
    return M, b0


def _full_coeffs(alpha: torch.Tensor) -> torch.Tensor:
    last = 1.0 - torch.sum(alpha, dim=-1, keepdim=True)
    return torch.cat([alpha, last], dim=-1)


# the batched products of the solvers, as elementwise products and sums:
# over hundreds of thousands of (49, k) systems cuBLAS's batched gemv and
# small gemm run tiles far larger than k (~0.1 ms a call for k = 2)

def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def _matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A (..., m, k) x (..., k) -> (..., m)."""
    return (A * x[..., None, :]).sum(-1)


def _atb(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^T b: A (..., m, k), b (..., m) -> (..., k)."""
    return (A * b[..., :, None]).sum(-2)


def gram(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """X^T Y over the row axis: X (..., m, k), Y (..., m, l) -> (..., k, l);
    elementwise for k * l <= 4, a batched product past it."""
    if X.shape[-1] * Y.shape[-1] <= 4:
        return (X[..., :, :, None] * Y[..., :, None, :]).sum(-3)
    return X.mT @ Y


def affine_best_l2_approximation(A: torch.Tensor,
                                 b: torch.Tensor) -> torch.Tensor:
    """argmin_x ||Ax - b||_2 subject to sum(x) == 1
    (`affineBestL2Approximation`, `l2optimization.h:50-64`)."""
    M, b0 = _affine_parts(A)
    return _full_coeffs(small_lstsq(M, b - b0))


def spherical_affine_best_approximation(A: torch.Tensor,
                                        b: torch.Tensor) -> torch.Tensor:
    """argmin_x || Ax/||Ax|| - b/||b|| ||_2 subject to sum(x) == 1
    (`sphericalAffineBestApproximation`, `sphericaloptimization.h:36-66`):
    project b onto col(A), scale the affine offset's residual, solve.

    Where the offset's residual a_perp vanishes (b0 lies in the span of
    M: the columns' affine hull holds the origin, as for zero-mean flat
    windows) the scale g = |a_perp|^2 / (a_perp . b_perp) is 0, the limit
    of g ~ |a_perp| that the JAX package's float32 SVD reaches through
    rounding (its a_perp there is rounding noise); an exact 0 / 0 would
    be NaN."""
    M, b0 = _affine_parts(A)
    b_perp = _matvec(A, small_lstsq(A, b))
    a_perp = b0 - _matvec(M, small_lstsq(M, b0))
    aa = (a_perp * a_perp).sum(-1)
    g = torch.where(aa > 0, aa / (a_perp * b_perp).sum(-1), 0.0)
    alpha = small_lstsq(M, g[..., None] * b_perp - b0)
    return _full_coeffs(alpha)
