"""Point-cloud map estimation from per-coordinate scalar observations
(counterpart of `libstevi_tpu/geometry/pointcloudalignment.py`).

Reference parity: `geometry/pointcloudalignment.h` — the observation model
is ``obs_k = selected_coordinate(T(pts[:, idx_k]))`` (each observation pins
one coordinate axis of one transformed point):
  * `estimateAffineMap` (:33: 12-parameter closed-form LSQ with pseudo
    inverse, offset at identity),
  * `estimateTranslationMap` (:376), `estimateScaleMap` (:436),
    `estimateRotationMap` (:494) — reduced closed forms,
  * `estimateShapePreservingMap` (:739: damped Gauss-Newton on the 7-DoF
    similarity with small-angle rotation updates, scale updated as
    exp(delta), left-composition of the increment).

The axis selection is a one-hot (N, 3) matrix, so every solver is dense
linear algebra over (N, k) design matrices.  The iterations are Python
loops of a fixed count; the shape-preserving map freezes its state once it
has converged, so it ends where the JAX package's `while_loop` stops, and
reads its status from the device once.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .core import skew, AffineTransform, IterativeTermination, vec
from .rotations import (ShapePreservingTransform, angle_axis_rotate,
                        axis_angle_to_quaternion, quaternion_product,
                        quaternion_to_axis_angle)


class Axis(enum.Enum):
    X = 0
    Y = 1
    Z = 2


def _axis_onehot(coordinate, device):
    idx = torch.as_tensor([c.value if isinstance(c, Axis) else int(c)
                           for c in coordinate], dtype=torch.int64,
                          device=device)
    return F.one_hot(idx, 3).float(), idx


def _pinv_solve(A, b, tol=1e-4):
    """x = pinv(A^T A) A^T b with the reference's singular-value cutoff
    (absolute, on the singular values of A^T A)."""
    AtA = A.T @ A
    u, s, vt = torch.linalg.svd(AtA)
    s_inv = torch.where(torch.abs(s) > tol,
                        1.0 / torch.where(s != 0, s, 1.0), 0.0)
    return vt.T @ (s_inv * (u.T @ (A.T @ b)))


def _points(pts, idxs):
    """(N, 3) observed points of the (3, M) cloud."""
    return pts[:, torch.as_tensor(idxs, dtype=torch.int64,
                                  device=pts.device)].T


def _picked(P, axis_idx):
    return torch.gather(P, 1, axis_idx[:, None])[:, 0]


def _skew_rows(tsel, axis_idx):
    """The selected row of each point's cross-product matrix."""
    S = skew(tsel)                                   # (N, 3, 3)
    return torch.gather(S, 1, axis_idx[:, None, None].expand(
        -1, 1, 3))[:, 0, :]


def estimate_affine_map(obs: torch.Tensor, pts: torch.Tensor,
                        idxs, coordinate) -> AffineTransform:
    """Closed-form 12-parameter affine map (`estimateAffineMap`,
    `pointcloudalignment.h:33-90`).  pts: (3, M); obs, idxs, coordinate
    aligned length-N."""
    onehot, _ = _axis_onehot(coordinate, pts.device)
    P = _points(pts, idxs)
    A = torch.cat([onehot[:, a:a + 1] * P for a in range(3)] + [onehot], 1)
    offset = vec([1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0], pts.device)
    x = _pinv_solve(A, obs - A @ offset) + offset
    return AffineTransform(x[:9].reshape(3, 3), x[9:])


def estimate_translation_map(obs, pts, idxs, coordinate) -> torch.Tensor:
    """Closed-form translation (`estimateTranslationMap`, :376)."""
    onehot, axis_idx = _axis_onehot(coordinate, pts.device)
    r = obs - _picked(_points(pts, idxs), axis_idx)
    counts = torch.clamp_min(torch.sum(onehot, 0), 1.0)
    return (onehot * r[:, None]).sum(0) / counts


def estimate_scale_map(obs, pts, idxs, coordinate) -> torch.Tensor:
    """Closed-form scale (`estimateScaleMap`, :436): least-squares s for
    obs = s * coord."""
    _, axis_idx = _axis_onehot(coordinate, pts.device)
    picked = _picked(_points(pts, idxs), axis_idx)
    return torch.sum(picked * obs) / torch.clamp_min(
        torch.sum(picked * picked), 1e-12)


def _compose_rotations(delta_r, r):
    q = quaternion_product(axis_angle_to_quaternion(delta_r),
                           axis_angle_to_quaternion(r))
    return quaternion_to_axis_angle(q)


def estimate_rotation_map(obs, pts, idxs, coordinate, iters: int = 50,
                          damping: float = 0.5) -> torch.Tensor:
    """Gauss-Newton rotation-only map (`estimateRotationMap`, :494)."""
    _, axis_idx = _axis_onehot(coordinate, pts.device)
    ids = torch.as_tensor(idxs, dtype=torch.int64, device=pts.device)
    r = torch.zeros(3, device=pts.device)
    for _ in range(iters):
        tp = angle_axis_rotate(r, pts.T).T           # (3, M)
        tsel = tp[:, ids].T                          # (N, 3)
        f0 = _picked(tsel, axis_idx)
        A = -_skew_rows(tsel, axis_idx)
        delta = _pinv_solve(A, obs - f0, tol=1e-6) * damping
        r = _compose_rotations(delta, r)
    return r


@dataclass
class ShapePreservingResult:
    transform: ShapePreservingTransform
    status: IterativeTermination


def estimate_shape_preserving_map(obs: torch.Tensor, pts: torch.Tensor,
                                  idxs, coordinate, n_steps: int = 50,
                                  incr_limit: float = 1e-8,
                                  damping: float = 0.5,
                                  damping_scale: float = 0.1
                                  ) -> ShapePreservingResult:
    """Damped Gauss-Newton 7-DoF similarity (`estimateShapePreservingMap`,
    `pointcloudalignment.h:739-835`): parameters (rx, ry, rz, tx, ty, tz,
    log s), left-composed small increments, SVD pseudo-inverse normal solve.
    """
    dev = pts.device
    onehot, axis_idx = _axis_onehot(coordinate, dev)
    ids = torch.as_tensor(idxs, dtype=torch.int64, device=dev)
    r, t = torch.zeros(3, device=dev), torch.zeros(3, device=dev)
    s = torch.ones((), device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    scale = vec([damping] * 6 + [damping_scale], dev)
    for _ in range(n_steps):
        cur = ShapePreservingTransform(r, t, s)
        tsel = cur.apply(pts.T)[ids]                 # (N, 3)
        f0 = _picked(tsel, axis_idx)
        A = torch.cat([-_skew_rows(tsel, axis_idx), onehot, f0[:, None]],
                      1)                             # (N, 7)
        delta = _pinv_solve(A, obs - f0, tol=1e-6) * scale
        change = ShapePreservingTransform(delta[:3], delta[3:6],
                                          torch.exp(delta[6]))
        new = change * cur
        # convergence measures the UNDAMPED step: each component divides
        # by its own damping
        und = torch.cat([delta[:6] / damping, delta[6:] / damping_scale])
        converged = torch.linalg.vector_norm(und) < incr_limit
        # a converged state stays as the while loop leaves it
        r = torch.where(done, r, new.r)
        t = torch.where(done, t, new.t)
        s = torch.where(done, s, new.s)
        done = done | converged
    # the one host read
    status = (IterativeTermination.CONVERGED if bool(done)
              else IterativeTermination.MAX_STEP_REACHED)
    return ShapePreservingResult(ShapePreservingTransform(r, t, s), status)
