"""Relative pose, triangulation, essential matrix, P3P/PnP (counterpart of
`libstevi_tpu/geometry/alignement.py`).

Reference parity: `geometry/alignement.h` — `projectPoints` (:44-96, pinhole
x/z, y/z), `reprojectPoints` (:142, closed-form two-view depth from the x and
y constraints, averaged, with non-finite fallback), `reprojectPointsLstSqr`
(:209, per-point 2x2 least squares on the two rays),
`estimateEssentialMatrix` (:275, 8-point + SVD null vector),
`essentialMatrix2Transforms` (:388, U W V^T factorizations),
`selectTransform` (:434, cheirality + reprojection-error tie-break),
`findTransform` (:532), `p3p` (:547,670 — Lambda-Twist, Persson & Nordberg
ECCV 2018), `pnpRefine` (:982, Gauss-Newton on reprojection residuals,
the Jacobian from `torch.func.jacfwd`) and `pnp` (:1064, P3P hypotheses
from the first 3 points scored by all-point reprojection).

The candidates of `select_transform`, P3P and `pnp` are scored as one
batch (a leading axis of 4 or 2) instead of the JAX package's `vmap`; the
Lambda-Twist cubic and eigen steps use closed forms plus a fixed-count
Newton polish.  Points are (N, 2) / (N, 3) row-major tensors.

The SVD of an essential matrix (two equal singular values) is not unique:
LAPACK on the CPU and cuSOLVER on the card may return other factors, and
then the four (R, t) candidates come in another order.  The set is the
same, and so is `select_transform`'s pick.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .core import AffineTransform, matvec, unskew, vec
from .rotations import inverse_rodrigues_formula, rodrigues_formula


# ---------------------------------------------------------------------------
# Projection / triangulation
# ---------------------------------------------------------------------------

def project_points(pts: torch.Tensor, transform: AffineTransform | None = None
                   ) -> torch.Tensor:
    """(..., 3) camera- or scene-frame points -> (..., 2) homogeneous image
    coordinates (x/z, y/z)."""
    if transform is not None:
        pts = transform.apply(pts)
    return pts[..., :2] / pts[..., 2:3]


def reproject_points(transform: AffineTransform, pt_cam_1: torch.Tensor,
                     pt_cam_2: torch.Tensor) -> torch.Tensor:
    """Two-view triangulation: (N, 2) homogeneous coords in both cameras ->
    (N, 3) points in camera-1 frame (`reprojectPoints`,
    `alignement.h:142-184`: solve the x- and y- epipolar depth equations,
    average, fall back to whichever is finite).  A transform with a
    leading batch axis gives (B, N, 3)."""
    R, t = transform.R, transform.t

    def Rij(i, j):
        return R[..., i, j, None]

    def ti(i):
        return t[..., i, None]

    x1, y1 = pt_cam_1[..., 0], pt_cam_1[..., 1]
    u2, v2 = pt_cam_2[..., 0], pt_cam_2[..., 1]
    rz = Rij(2, 0) * x1 + Rij(2, 1) * y1 + Rij(2, 2)
    rx = Rij(0, 0) * x1 + Rij(0, 1) * y1 + Rij(0, 2)
    ry = Rij(1, 0) * x1 + Rij(1, 1) * y1 + Rij(1, 2)
    z_a = (ti(0) - u2 * ti(2)) / (u2 * rz - rx)
    z_b = (ti(1) - v2 * ti(2)) / (v2 * rz - ry)
    z = (z_a + z_b) / 2.0
    z = torch.where(torch.isfinite(z), z, z_a)
    z = torch.where(torch.isfinite(z), z, z_b)
    ones = torch.ones_like(x1)
    return torch.stack([x1, y1, ones], -1) * z[..., None]


def reproject_points_lstsqr(transform: AffineTransform, pt_cam_1: torch.Tensor,
                            pt_cam_2: torch.Tensor) -> torch.Tensor:
    """Least-squares two-ray triangulation (`reprojectPointsLstSqr`,
    `alignement.h:209-253`): per point, solve for the two ray scales with a
    pseudo-inverted 2x2 normal matrix, return the midpoint."""
    R, t = transform.R, transform.t
    v1 = torch.cat([pt_cam_1, torch.ones_like(pt_cam_1[..., :1])], -1)
    v2 = torch.cat([pt_cam_2, torch.ones_like(pt_cam_2[..., :1])], -1)
    v2c1 = v2 @ R  # R^T v2, batched
    b = -(R.T @ t)

    a00 = torch.sum(v1 * v1, -1)
    a01 = -torch.sum(v1 * v2c1, -1)
    a11 = torch.sum(v2c1 * v2c1, -1)
    # normal matrix [[a00, a01], [a01, a11]], rhs A^T b
    r0 = torch.sum(v1 * b, -1)
    r1 = -torch.sum(v2c1 * b, -1)
    det = a00 * a11 - a01 * a01
    safe = torch.abs(det) > 1e-12
    det_s = torch.where(safe, det, 1.0)
    l0 = torch.where(safe, (a11 * r0 - a01 * r1) / det_s, 0.0)
    l1 = torch.where(safe, (-a01 * r0 + a00 * r1) / det_s, 0.0)
    est1 = v1 * l0[..., None]
    est2 = v2c1 * l1[..., None] + b
    return (est1 + est2) / 2.0


# ---------------------------------------------------------------------------
# Essential matrix
# ---------------------------------------------------------------------------

def estimate_essential_matrix(pt_cam_1: torch.Tensor, pt_cam_2: torch.Tensor
                              ) -> torch.Tensor:
    """8-point essential matrix from (N >= 8, 2) homogeneous coordinates
    (`estimateEssentialMatrix`, `alignement.h:275-306`; E contracts as
    [x2 y2 1]^T E [x1 y1 1]).  Defined up to sign, as any null vector."""
    x1, y1 = pt_cam_1[..., 0], pt_cam_1[..., 1]
    x2, y2 = pt_cam_2[..., 0], pt_cam_2[..., 1]
    ones = torch.ones_like(x1)
    F = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2,
                     x1, y1, ones], 0)          # (9, N)
    # null vector of F^T == left singular vector of F for the smallest sv;
    # the thin SVD keeps V at (9, N), and N == 8 pads one zero column so
    # u[:, 8] is the true null vector
    if F.shape[1] < 9:
        F = torch.nn.functional.pad(F, (0, 9 - F.shape[1]))
    u, _, _ = torch.linalg.svd(F, full_matrices=False)
    return u[:, 8].reshape(3, 3)


def essential_matrix_to_transforms(E: torch.Tensor
                                   ) -> Tuple[AffineTransform, AffineTransform]:
    """E -> the two candidate (R, t) factorizations
    (`essentialMatrix2Transforms`, `alignement.h:388-430`)."""
    u, _, vt = torch.linalg.svd(E)
    u = torch.where(torch.linalg.det(u) < 0, -u, u)
    v = vt.T
    v = torch.where(torch.linalg.det(v) < 0, -v, v)
    W = vec([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.device)
    R1 = u @ W @ v.T
    R2 = u @ W.T @ v.T
    Wz = vec([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 0.0]], E.device)
    t1 = unskew(u @ Wz @ u.T)
    return AffineTransform(R1, t1), AffineTransform(R2, -t1)


def select_transform(T1: AffineTransform, T2: AffineTransform,
                     pt_cam_1: torch.Tensor, pt_cam_2: torch.Tensor
                     ) -> AffineTransform:
    """Cheirality selection among the 4 (R, t) combinations, with a
    bidirectional reprojection-error tie-break (`selectTransform`,
    `alignement.h:434-530`).  All four candidates are scored as one batch
    and the best valid one taken by `argmin`, no exceptions."""
    Rs = torch.stack([T1.R, T1.R, T2.R, T2.R])
    ts = torch.stack([T1.t, T2.t, T1.t, T2.t])
    cand = AffineTransform(Rs, ts)
    reproj = reproject_points(cand, pt_cam_1, pt_cam_2)          # (4, N, 3)
    ok1 = torch.all(reproj[..., 2] >= 0.0, -1)
    inv = cand.inverse()
    reproj2 = reproject_points(inv, pt_cam_2, pt_cam_1)
    ok2 = torch.all(reproj2[..., 2] >= 0.0, -1)
    n = pt_cam_1.shape[0]

    def each(T):
        return AffineTransform(T.R[:, None], T.t[:, None])

    err = torch.linalg.vector_norm(
        project_points(reproj, each(cand)) - pt_cam_2, dim=(-2, -1)) / n
    err = err + torch.linalg.vector_norm(
        project_points(reproj2, each(inv)) - pt_cam_1, dim=(-2, -1)) / n
    # near-epipole correspondences triangulate to inf depth, which PASSES
    # z >= 0 and then projects to NaN; NaN would win argmin
    err = torch.where(torch.isfinite(err), err, float("inf"))
    errs = torch.where(ok1 & ok2, err, float("inf"))
    best = torch.argmin(errs)
    return AffineTransform(Rs[best], ts[best])


def find_transform(pt_cam_1: torch.Tensor, pt_cam_2: torch.Tensor
                   ) -> AffineTransform:
    """Essential matrix + cheirality in one call (`findTransform`,
    `alignement.h:532-545`)."""
    E = estimate_essential_matrix(pt_cam_1, pt_cam_2)
    T1, T2 = essential_matrix_to_transforms(E)
    return select_transform(T1, T2, pt_cam_1, pt_cam_2)


# ---------------------------------------------------------------------------
# P3P (Lambda-Twist) and PnP
# ---------------------------------------------------------------------------

def _newton_cubic(a, b, c, d, x0, iters: int = 50):
    x = x0
    for _ in range(iters):
        fx = a * x ** 3 + b * x ** 2 + c * x + d
        dfx = 3 * a * x ** 2 + 2 * b * x + c
        x = x - fx / torch.where(torch.abs(dfx) > 1e-30, dfx, 1e-30)
    return x


def _pair_form(b, i, j) -> torch.Tensor:
    """The quadratic form of ||l_i y_i - l_j y_j||^2 (unit rays, y_i . y_j
    = b) in the depth vector (l1, l2, l3)."""
    m = torch.zeros(3, 3, dtype=b.dtype, device=b.device)
    m[i, i] = 1.0
    m[j, j] = 1.0
    m[i, j] = -b
    m[j, i] = -b
    return m


def p3p(pt_cam: torch.Tensor, pt_world: torch.Tensor):
    """Lambda-Twist P3P (`p3p`, `alignement.h:670-944`; Persson & Nordberg,
    ECCV 2018).  pt_cam: (3, 3) homogeneous rays (rows are points, last
    component 1 allowed — they are normalized); pt_world: (3, 3) scene
    points.  Returns (Rs (4, 3, 3), ts (4, 3), valid (4,)) world->cam
    candidates: fixed 4 solution slots with a validity mask.
    """
    dev = pt_cam.device
    y = pt_cam / torch.linalg.vector_norm(pt_cam, dim=-1, keepdim=True)
    x1, x2, x3 = pt_world[0], pt_world[1], pt_world[2]
    y1, y2, y3 = y[0], y[1], y[2]

    d12 = x1 - x2
    d13 = x1 - x3
    d23 = x2 - x3
    d12xd23 = torch.linalg.cross(d12, d23)
    X = torch.stack([d12, d23, d12xd23], -1)
    invX = torch.linalg.inv(X)

    a12 = torch.dot(d12, d12)
    a13 = torch.dot(d13, d13)
    a23 = torch.dot(d23, d23)

    b12 = torch.dot(y1, y2)
    b13 = torch.dot(y1, y3)
    b23 = torch.dot(y2, y3)

    # Lambda-Twist pencil: D1 = M12 a23 - M23 a12, D2 = M13 a23 - M23 a13
    M12m = _pair_form(b12, 0, 1)
    M13m = _pair_form(b13, 0, 2)
    M23m = _pair_form(b23, 1, 2)

    D1 = M12m * a23 - M23m * a12
    D2 = M13m * a23 - M23m * a13

    # cubic det(D1 + gamma D2) = d0 + c1 g + c2 g^2 + c3 g^3, coefficients
    # recovered by sampling the determinant at g = 0, +-1, 2
    p0 = torch.linalg.det(D1)
    p1 = torch.linalg.det(D1 + D2)
    pm1 = torch.linalg.det(D1 - D2)
    p2 = torch.linalg.det(D1 + 2.0 * D2)
    d0 = p0
    c2p = (p1 + pm1) / 2.0 - d0
    s = (p1 - pm1) / 2.0                       # = c1 + c3
    c3p = (p2 - d0 - 4.0 * c2p - 2.0 * s) / 6.0
    c1p = s - c3p
    gamma = _newton_cubic(c3p, c2p, c1p, d0, torch.zeros_like(d0))

    D0 = D1 + gamma * D2  # rank-2, one zero eigenvalue

    # eigen decomposition knowing one zero eigenvalue
    f = D0.reshape(-1)
    p1c = -f[0] - f[4] - f[8]
    p0c = (-f[1] * f[1] - f[2] * f[2] - f[5] * f[5]
           + f[0] * (f[4] + f[8]) + f[4] * f[8])
    delta = torch.clamp_min(p1c * p1c - 4 * p0c, 0.0)
    sq = torch.sqrt(delta)
    s1 = torch.where(p1c < 0, (-p1c + sq) / 2, 2 * p0c / (-p1c + sq))
    s2 = torch.where(p1c < 0, (-p1c - sq) / 2, 2 * p0c / (-p1c - sq))

    def eigvec(lam):
        c = lam * lam + f[0] * f[4] - lam * (f[0] + f[4]) - f[1] * f[1]
        c = torch.where(torch.abs(c) > 1e-20, c, 1e-20)
        a1 = (lam * f[2] + f[1] * f[5] - f[2] * f[4]) / c
        a2 = (lam * f[5] + f[1] * f[2] - f[0] * f[5]) / c
        v = torch.stack([a1, a2, torch.ones_like(a1)])
        return v / torch.linalg.vector_norm(v)

    bv1 = eigvec(s1)
    bv2 = eigvec(s2)
    swap = torch.abs(s1) < torch.abs(s2)
    sig1 = torch.where(swap, s2, s1)
    sig2 = torch.where(swap, s1, s2)
    e1 = torch.where(swap, bv2, bv1)
    e2 = torch.where(swap, bv1, bv2)

    sp = torch.sqrt(torch.clamp_min(-sig2 / sig1, 0.0))

    def solutions_for(sgn):
        w0 = (e1[0] - sgn * sp * e2[0])
        w1 = (e1[1] - sgn * sp * e2[1])
        w2 = (e1[2] - sgn * sp * e2[2])
        # the plane w . l = 0 intersected with the D1 quadric: with
        # l = (-(w1 t + w2) / w0, t, 1) * l3, l^T D1 l is a quadratic in t
        w0s = torch.where(torch.abs(w0) > 1e-12, w0, 1e-12)

        def l_of(t):
            t = torch.as_tensor(t, dtype=w0.dtype, device=dev)
            return torch.stack([-(w1 * t + w2) / w0s, t,
                                torch.ones_like(t)], -1)

        def qform(A, t):
            l = l_of(t)
            return l @ A @ l

        # coefficients of the quadratic in t, sampled at t = 1, 0, -1
        qa = qform(D1, 1.0)
        qb_ = qform(D1, 0.0)
        qm = qform(D1, -1.0)
        A_ = (qa + qm) / 2 - qb_
        B_ = (qa - qm) / 2
        C_ = qb_
        disc = B_ * B_ - 4 * A_ * C_
        ok = disc >= 0
        sqd = torch.sqrt(torch.clamp_min(disc, 0.0))
        A_s = torch.where(torch.abs(A_) > 1e-20, A_, 1e-20)
        taus = torch.stack([(-B_ + sqd) / (2 * A_s), (-B_ - sqd) / (2 * A_s)])

        # lift both roots: scale so that ||l1 y1 - l2 y2||^2 = a12
        l_dir = l_of(taus)                                  # (2, 3)
        diffv = l_dir[:, 0:1] * y1 - l_dir[:, 1:2] * y2
        den = torch.sum(diffv * diffv, -1)
        scale = torch.sqrt(a12 / torch.clamp_min(den, 1e-20))
        ls = l_dir * scale[:, None]
        valid = ok & torch.all(ls > 0, -1)
        return ls, valid

    ls_a, va = solutions_for(1.0)
    ls_b, vb = solutions_for(-1.0)
    ls = torch.cat([ls_a, ls_b], 0)          # (4, 3)
    valid = torch.cat([va, vb], 0)

    # the four poses at once
    z1 = ls[:, 0:1] * y1
    z2 = ls[:, 1:2] * y2
    z3 = ls[:, 2:3] * y3
    dz12 = z1 - z2
    dz23 = z2 - z3
    Y = torch.stack([dz12, dz23, torch.linalg.cross(dz12, dz23)], -1)
    Rs = Y @ invX
    ts = z1 - matvec(Rs, x1)
    return Rs, ts, valid


def pnp_refine(R0: torch.Tensor, t0: torch.Tensor, pt_cam: torch.Tensor,
               pt_world: torch.Tensor, iters: int = 10) -> AffineTransform:
    """Gauss-Newton refinement of a world->cam pose on reprojection residuals
    (`pnpRefine`, `alignement.h:982-1062`), the Jacobian from
    `torch.func.jacfwd` (the reference's `JacobianPointProjection`, :946)."""
    params = torch.cat([inverse_rodrigues_formula(R0), t0])

    def residuals(p):
        R = rodrigues_formula(p[:3])
        proj = project_points(pt_world @ R.T + p[3:])
        return (proj - pt_cam).reshape(-1)

    eye = torch.eye(6, dtype=params.dtype, device=params.device)
    for _ in range(iters):
        res = residuals(params)
        J = torch.func.jacfwd(residuals)(params)
        JtJ = J.T @ J + 1e-8 * eye
        # a singular system gives inf / NaN, as `jnp.linalg.solve` does
        step = torch.linalg.solve_ex(JtJ, J.T @ res).result
        params = params - step
    return AffineTransform(rodrigues_formula(params[:3]), params[3:])


def pnp(pt_cam: torch.Tensor, pt_world: torch.Tensor, refine: bool = True
        ) -> AffineTransform:
    """PnP: P3P on the first three points, candidates scored by all-point
    reprojection error, optional Gauss-Newton polish (`pnp`,
    `alignement.h:1064-1155`).

    Failure signalling: when every P3P candidate is invalid (collinear
    or degenerate first three points), the returned transform carries
    NaN entries — check ``torch.isfinite(T.R).all()`` (the analogue of the
    reference's empty optional)."""
    rays = torch.cat([pt_cam[:3], torch.ones_like(pt_cam[:3, :1])], -1)
    Rs, ts, valid = p3p(rays, pt_world[:3])

    cam_pts = pt_world @ Rs.transpose(-1, -2) + ts[:, None]      # (4, N, 3)
    proj = project_points(cam_pts)
    err = torch.sum((proj - pt_cam) ** 2, (-2, -1))
    err = torch.where(torch.isfinite(err), err, float("inf"))
    err = torch.where(torch.all(cam_pts[..., 2] > 0, -1), err, float("inf"))
    errs = torch.where(valid, err, float("inf"))
    best = torch.argmin(errs)
    R, t = Rs[best], ts[best]
    if refine:
        return pnp_refine(R, t, pt_cam, pt_world)
    return AffineTransform(R, t)
