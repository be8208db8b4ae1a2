"""Cost-based subpixel refinement (counterpart of
`libstevi_tpu/ops/refinement.py`).

Reference parity: `correlation/cost_based_refinement.h` — `refineCostTriplet`
(:44; Equiangular / Parabola / Gaussian 1-D peak kernels),
`refineDispCostInterpolation` (:129), 2-D isotropic and anisotropic
line-fit refinement (`refineDisp2dCostInterpolation`, :166) and the 9-point
quadratic patch fit (`refineCostPatch`/`refineDisp2dCostPatchInterpolation`,
:72,379).  1-D refinement does NOT clamp deltas (the reference doesn't): a
NaN band slot gives a NaN disparity.  The 2-D variants zero both deltas
when |delta| > 1 or NaN (:362-366,424-428).

Everything is elementwise over (H, W) maps.  The 9-point patch fit's
6-parameter least squares has a constant normal matrix, so its
pseudo-inverse is a constant (6, 9) matrix.
"""

from __future__ import annotations

import enum

import numpy as np
import torch


class InterpolationKernel(enum.Enum):
    EQUIANGULAR = 0
    PARABOLA = 1
    GAUSSIAN = 2


class IsotropyHypothesis(enum.Enum):
    ISOTROPIC = 0
    ANISOTROPIC = 1


def refine_cost_triplet(kernel: InterpolationKernel, cm1, c0, c1):
    """Subpixel offset from a (c[-1], c[0], c[1]) triplet
    (`refineCostTriplet`, `cost_based_refinement.h:44-69`)."""
    if kernel is InterpolationKernel.EQUIANGULAR:
        alpha = torch.copysign(torch.ones_like(c0), c0 - cm1) * torch.maximum(
            torch.abs(c0 - cm1), torch.abs(c1 - c0))
        return (c1 - cm1) / (2 * alpha)
    if kernel is InterpolationKernel.PARABOLA:
        return (cm1 - c1) / (2 * (c1 - 2 * c0 + cm1))
    lm1, l0, l1 = torch.log(cm1), torch.log(c0), torch.log(c1)
    return (lm1 - l1) / (2 * (l1 - 2 * l0 + lm1))


def refine_disp_cost_interpolation(kernel: InterpolationKernel,
                                   truncated_cv: torch.Tensor,
                                   raw_disparity: torch.Tensor) -> torch.Tensor:
    """refined = raw + triplet offset around the center slot of an
    (H, W, 2r+1) truncated cost volume (`refineDispCostInterpolation`,
    `cost_based_refinement.h:129-163`)."""
    r = (truncated_cv.shape[-1] - 1) // 2
    if r < 1 or 2 * r + 1 != truncated_cv.shape[-1]:
        raise ValueError("truncated cost volume must have odd width >= 3")
    delta = refine_cost_triplet(kernel, truncated_cv[..., r - 1],
                                truncated_cv[..., r], truncated_cv[..., r + 1])
    return raw_disparity.float() + delta


# ---------------------------------------------------------------------------
# 2-D refinement
# ---------------------------------------------------------------------------

def _is_score_volume(tcv: torch.Tensor) -> torch.Tensor:
    """Heuristic score/cost detection from the central pixel
    (`cost_based_refinement.h:184-203`)."""
    H, W = tcv.shape[0], tcv.shape[1]
    r0 = (tcv.shape[2] - 1) // 2
    r1 = (tcv.shape[3] - 1) // 2
    c = tcv[H // 2, W // 2]
    v0 = c[r0, r1]
    return ((v0 > c[r0 + 1, r1]) | (v0 > c[r0 - 1, r1])
            | (v0 > c[r0, r1 + 1]) | (v0 > c[r0, r1 - 1]))


def _guarded(delta0, delta1, raw):
    """raw + (delta0, delta1), both deltas zeroed where either is NaN or
    larger than 1 in magnitude."""
    bad = ((torch.abs(delta0) > 1) | (torch.abs(delta1) > 1)
           | torch.isnan(delta0) | torch.isnan(delta1))
    delta0 = torch.where(bad, 0.0, delta0)
    delta1 = torch.where(bad, 0.0, delta1)
    return torch.stack([raw[..., 0] + delta0, raw[..., 1] + delta1], dim=-1)


def _tie_last_argopt(vals: torch.Tensor, is_score: torch.Tensor):
    """argmax (score) / argmin (cost) over the last axis, ties toward the
    last index, as the reference's >= / <= loops."""
    D = vals.shape[-1]
    flipped = torch.flip(vals, dims=(-1,))
    amin = D - 1 - torch.argmin(flipped, dim=-1)
    amax = D - 1 - torch.argmax(flipped, dim=-1)
    return torch.where(is_score, amax, amin)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(x, -1, idx.long()[..., None])[..., 0]


def _line_delta(kernel, tcv, is_score, along0: bool):
    """Fit delta_a = a * delta_b + b from triplet refinements on the center
    row/col and its two neighbors (`cost_based_refinement.h:272-353`)."""
    S0, S1 = tcv.shape[2], tcv.shape[3]
    r0, r1 = (S0 - 1) // 2, (S1 - 1) // 2
    if along0:
        center = refine_cost_triplet(kernel, tcv[..., r0 - 1, r1],
                                     tcv[..., r0, r1], tcv[..., r0 + 1, r1])
        lines = [tcv[..., :, r1 + off] for off in (-1, 1)]   # (H, W, S0)
        S, rc = S0, r0
    else:
        center = refine_cost_triplet(kernel, tcv[..., r0, r1 - 1],
                                     tcv[..., r0, r1], tcv[..., r0, r1 + 1])
        lines = [tcv[..., r0 + off, :] for off in (-1, 1)]   # (H, W, S1)
        S, rc = S1, r1
    sides = []
    for line in lines:
        am = _tie_last_argopt(line, is_score)
        interior = (am > 0) & (am < S - 1)
        amc = am.clamp(1, S - 2).to(torch.int32)
        d = amc - rc + refine_cost_triplet(
            kernel, _take(line, amc - 1), _take(line, amc),
            _take(line, amc + 1))
        sides.append(torch.where(interior, d, center))
    a = (sides[1] - sides[0]) / 2
    b = (sides[0] + center + sides[1]) / 3
    return a, b


def refine_disp_2d_cost_interpolation(
        kernel: InterpolationKernel, truncated_cv: torch.Tensor,
        raw_disparity: torch.Tensor,
        isotropy: IsotropyHypothesis = IsotropyHypothesis.ISOTROPIC
        ) -> torch.Tensor:
    """2-D subpixel refinement on an (H, W, 2r0+1, 2r1+1) truncated CV
    (`refineDisp2dCostInterpolation`, `cost_based_refinement.h:166-376`):
    (H, W, 2) float32."""
    H, W, S0, S1 = truncated_cv.shape
    r0, r1 = (S0 - 1) // 2, (S1 - 1) // 2
    if S0 % 2 == 0 or S1 % 2 == 0:
        raise ValueError("2-D truncated cost volume widths must be odd "
                         "(2r+1; `cost_based_refinement.h:180`)")
    if r0 < 1 or r1 < 1:
        raise ValueError("2-D truncated cost volume radii must be >= 1")
    tcv = truncated_cv.float()
    raw = raw_disparity.float()

    if isotropy is IsotropyHypothesis.ISOTROPIC:
        delta0 = refine_cost_triplet(kernel, tcv[..., r0 - 1, r1],
                                     tcv[..., r0, r1], tcv[..., r0 + 1, r1])
        delta1 = refine_cost_triplet(kernel, tcv[..., r0, r1 - 1],
                                     tcv[..., r0, r1], tcv[..., r0, r1 + 1])
        return _guarded(delta0, delta1, raw)

    is_score = _is_score_volume(tcv)
    a0, b0 = _line_delta(kernel, tcv, is_score, True)
    a1, b1 = _line_delta(kernel, tcv, is_score, False)
    denom = 1 - a0 * a1
    delta0 = (a0 * b1 + b0) / denom
    delta1 = (a1 * b0 + b1) / denom
    return _guarded(delta0, delta1, raw)


def _patch_pinv() -> np.ndarray:
    """Pseudo-inverse of the 9-point quadratic design matrix
    (`refineCostPatch`, `cost_based_refinement.h:85-116`): rows are
    [dv^2, dv*dh, dh^2, dv, dh, 1] for (dv, dh) on the 3x3 stencil."""
    dv = np.array([-1, -1, -1, 0, 0, 0, 1, 1, 1], np.float64)
    dh = np.array([-1, 0, 1, -1, 0, 1, -1, 0, 1], np.float64)
    A = np.stack([dv * dv, dv * dh, dh * dh, dv, dh, np.ones(9)], axis=1)
    return np.linalg.inv(A.T @ A) @ A.T  # (6, 9)


_PATCH_PINV = _patch_pinv().astype(np.float32)


def refine_cost_patch(kernel: InterpolationKernel, patch: torch.Tensor):
    """Newton step of a 6-parameter quadratic fit to a (..., 3, 3) cost
    patch; returns (delta0, delta1)."""
    if kernel is InterpolationKernel.GAUSSIAN:
        patch = torch.log(patch)
    elif kernel is not InterpolationKernel.PARABOLA:
        raise ValueError("patch refinement supports Parabola or Gaussian")
    L = patch.reshape(patch.shape[:-2] + (9,))
    pinv = torch.from_numpy(_PATCH_PINV).to(L.device)
    fitted = torch.einsum("...j,kj->...k", L, pinv)
    a, b, c, d, e = (fitted[..., n] for n in range(5))
    # solve [[2a, b], [b, 2c]] x = [-d, -e]
    det = 4 * a * c - b * b
    delta0 = (-2 * c * d + b * e) / det
    delta1 = (b * d - 2 * a * e) / det
    return delta0, delta1


def refine_disp_2d_cost_patch_interpolation(
        kernel: InterpolationKernel, truncated_cv: torch.Tensor,
        raw_disparity: torch.Tensor) -> torch.Tensor:
    """9-point quadratic patch refinement
    (`refineDisp2dCostPatchInterpolation`, `cost_based_refinement.h:379-436`):
    (H, W, 2) float32."""
    S0, S1 = truncated_cv.shape[2], truncated_cv.shape[3]
    r0, r1 = (S0 - 1) // 2, (S1 - 1) // 2
    patch = truncated_cv[..., r0 - 1:r0 + 2, r1 - 1:r1 + 2].float()
    delta0, delta1 = refine_cost_patch(kernel, patch)
    return _guarded(delta0, delta1, raw_disparity.float())
