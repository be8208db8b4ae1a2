"""Alignment of two sets of 3-D rays (origin + direction) (counterpart of
`libstevi_tpu/geometry/raysalignment.py`).

Reference parity: `geometry/genericraysalignement.h` — `RayInfos` (:36),
`alignRaysSets` (:71: Gauss-Newton on the coplanarity residual
``<v_j, (R p_i + t - p_j) x R v_i>``), `relaxedAlignRaysSets` (:161:
18-parameter linear relaxation solved by SVD null space), and the
RANSAC-robust axis variant (:600).

Residuals and `torch.func.jacfwd` Jacobians batch over all ray pairs
(`optim.GaussNewton`); the robust variant runs `optim.ransac`, whose
index sets come from a ``generator`` or an injected ``draw``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .core import AffineTransform
from .rotations import rodrigues_formula
from ..optim.gauss_newton import GaussNewton
from ..optim.ransac import ransac


@dataclass
class RayInfos:
    """A bundle of rays: origins (N, 3) and unit directions (N, 3)."""

    origins: torch.Tensor
    directions: torch.Tensor


def _coplanarity_residuals(params, o1, v1, o2, v2):
    R = rodrigues_formula(params[:3])
    p = o1 @ R.T + params[3:] - o2
    rv = v1 @ R.T
    return torch.einsum("ni,ni->n", v2, torch.linalg.cross(p, rv))


def _zeros6(rays: RayInfos) -> torch.Tensor:
    return torch.zeros(6, dtype=rays.origins.dtype, device=rays.origins.device)


def align_rays_sets(rays1: RayInfos, rays2: RayInfos,
                    init: torch.Tensor | None = None, iters: int = 50
                    ) -> AffineTransform:
    """Gauss-Newton alignment (`alignRaysSets`,
    `genericraysalignement.h:71-158`): find (R, t) mapping frame 1 into
    frame 2 such that corresponding rays intersect."""
    x0 = _zeros6(rays1) if init is None else init
    gn = GaussNewton(_coplanarity_residuals, iters=iters, damping=1e-9)
    res = gn.solve(x0, rays1.origins, rays1.directions,
                   rays2.origins, rays2.directions)
    return AffineTransform(rodrigues_formula(res.x[:3]), res.x[3:])


def relaxed_align_rays_sets(rays1: RayInfos, rays2: RayInfos
                            ) -> AffineTransform:
    """18-parameter linear relaxation (`relaxedAlignRaysSets`,
    `genericraysalignement.h:161-330`): treat M = R and N = [t]x R as free
    3x3 matrices; each pair gives the linear constraint
    ``v2 . (M (o1 x v1) - o2 x (M v1) + N v1) = 0`` (equivalent to the
    coplanarity residual), solve the null space by SVD, then project M back
    onto SO(3) and recover t.

    The null vector is the last right singular vector of the (N, 18)
    constraint matrix.  From 18 pairs on, the thin SVD holds it (the full
    one would make an N x N U: 4 TB at a million pairs); below 18 it lies
    in the null space only the full V spans.  Its sign does not reach R or
    t."""
    o1, v1 = rays1.origins, rays1.directions
    o2, v2 = rays2.origins, rays2.directions
    N_rays = o1.shape[0]

    c1 = torch.linalg.cross(o1, v1)                    # (N, 3): o1 x v1
    # v2 . (M c1): coefficient of M_ab = v2_a * c1_b
    coeff_M1 = v2[:, :, None] * c1[:, None, :]         # (N, 3, 3)
    # - v2 . (o2 x (M v1)) = -(M v1) . (v2 x o2)
    w = torch.linalg.cross(v2, o2)                     # (N, 3)
    coeff_M2 = -w[:, :, None] * v1[:, None, :]
    # v2 . (N v1): coefficient of N_ab = v2_a * v1_b
    coeff_N = v2[:, :, None] * v1[:, None, :]

    A = torch.cat([(coeff_M1 + coeff_M2).reshape(N_rays, 9),
                   coeff_N.reshape(N_rays, 9)], 1)    # (N, 18)
    _, _, vt = torch.linalg.svd(A, full_matrices=N_rays < 18)
    x = vt[-1]
    M = x[:9].reshape(3, 3)
    Nm = x[9:].reshape(3, 3)

    # project M onto SO(3) (sign-corrected)
    u, s, vvt = torch.linalg.svd(M)
    R = u @ vvt
    det = torch.linalg.det(R)
    R = R * torch.sign(det)
    scale = torch.mean(s) * torch.sign(det)
    # N = [t]x R  =>  [t]x = N R^T / scale
    Tx = Nm @ R.T / torch.where(torch.abs(scale) > 1e-12, scale, 1.0)
    t = torch.stack([Tx[2, 1] - Tx[1, 2], Tx[0, 2] - Tx[2, 0],
                     Tx[1, 0] - Tx[0, 1]]) / 2.0
    return AffineTransform(R, t)


def robust_align_rays_sets(rays1: RayInfos, rays2: RayInfos,
                           n_iterations: int = 64, threshold: float = 1e-3,
                           generator: torch.Generator | None = None,
                           draw=None) -> AffineTransform:
    """RANSAC-robust alignment (`robustRelaxedAxisAlignRaysSets`,
    `genericraysalignement.h:600`): minimal GN fits on sampled subsets of
    6 pairs scored by the coplanarity residual, refined on the winner's
    inliers.  ``generator`` and ``draw`` are `optim.ransac`'s: the index
    sets from a ``torch.Generator`` (default seed 0 on the rays' device) or
    an (n_iterations, 6) integer tensor that ``draw()`` returns."""
    data = (rays1.origins, rays1.directions, rays2.origins, rays2.directions)
    x0 = _zeros6(rays1)

    def fit(sub):
        gn = GaussNewton(_coplanarity_residuals, iters=20, damping=1e-8)
        return gn.solve(x0, *sub).x

    def residual(params, d):
        return _coplanarity_residuals(params, *d)

    def refit(d, w):
        # weighted GN on the winner's inliers (`:600` refines on the
        # consensus set, not the 6-ray minimal sample)
        def wres(params, o1, v1, o2, v2):
            return _coplanarity_residuals(params, o1, v1, o2, v2) * w

        gn = GaussNewton(wres, iters=20, damping=1e-8)
        return gn.solve(x0, *d).x

    res = ransac(fit, residual, data, n_samples=6,
                 n_iterations=n_iterations, threshold=threshold,
                 generator=generator, refit_fn=refit, draw=draw)
    x = res.model
    return AffineTransform(rodrigues_formula(x[:3]), x[3:])
