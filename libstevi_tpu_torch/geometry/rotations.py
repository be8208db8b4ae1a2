"""Rotations, rigid-body and similarity transforms (counterpart of
`libstevi_tpu/geometry/rotations.py`).

Reference parity: `geometry/rotations.h` — `rodriguezFormula` (:31),
`angleAxisRotate` (:47), `inverseRodriguezFormula` (:61),
`diffRodriguezLieAlgebra` (:127), `axisAngleToQuaternion` (:208, [w,x,y,z]),
`quaternionToAxisAngle` (:271), `RigidBodyTransform` (:279; r,t on the SO(3)
manifold), `interpolateRigidBodyTransformOnManifold` (:424),
`ShapePreservingTransform` (:439; r,t,s 7-DoF similarity), Euler XYZ/ZYX
(:539-568).

All functions broadcast over leading batch dims; the small-angle branches
are `torch.where` selects with Taylor fallbacks, so `torch.func` gradients
through theta ~= 0 stay finite.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from .core import cross, skew, unskew, AffineTransform

_EPS = 1e-6


def _safe_norm(r: torch.Tensor) -> torch.Tensor:
    """norm with a gradient-safe sqrt at 0."""
    sq = torch.sum(r * r, -1)
    safe = torch.where(sq > 0, sq, 1.0)
    return torch.where(sq > 0, torch.sqrt(safe), 0.0)


def _eye(m: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=m.dtype, device=m.device).expand(m.shape)


def rodrigues_formula(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = _safe_norm(r)[..., None, None]
    m = skew(r)
    small = theta < _EPS
    theta_s = torch.where(small, 1.0, theta)
    a = torch.where(small, 1.0, torch.sin(theta_s) / theta_s)
    b = torch.where(small, 0.5,
                    (1.0 - torch.cos(theta_s)) / (theta_s * theta_s))
    return _eye(m) + a * m + b * (m @ m)


def angle_axis_rotate(r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate (..., 3) vectors by axis-angle r without forming R."""
    theta = _safe_norm(r)[..., None]
    rxv = cross(r, v)
    rxrxv = cross(r, rxv)
    small = theta < _EPS
    theta_s = torch.where(small, 1.0, theta)
    a = torch.where(small, 1.0, torch.sin(theta_s) / theta_s)
    b = torch.where(small, 0.5,
                    (1.0 - torch.cos(theta_s)) / (theta_s * theta_s))
    return v + a * rxv + b * rxrxv


def inverse_rodrigues_formula(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), with the
    reference's three-regime numerical handling (`rotations.h:61-117`):
    near-identity, near-pi, and the generic case."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    d = torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)
    Rt = R.transpose(-1, -2)
    dR = unskew(R - Rt)
    nDr = _safe_norm(dR)
    theta = torch.arccos(d)

    # generic branch
    denom = 2.0 * torch.sqrt(torch.clamp_min(1.0 - d * d, _EPS ** 2))
    omega_gen = (theta / denom)[..., None] * dR

    # near-identity branch (d > 0.999)
    omega_id = 0.5 * dR

    # near-pi branch (antisymmetric part vanishes but d is not ~1)
    S = R + Rt + (1.0 - trace)[..., None, None] * _eye(R)
    denom3 = torch.clamp_min(3.0 - trace, _EPS)[..., None]
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], -1)
    n = torch.sqrt(torch.clamp_min(diag / denom3, 0.0))
    # signs from the dominant row of S; argmax takes the first index on a
    # tie, as jnp.argmax does
    k = torch.argmax(n, -1)
    rows = torch.gather(S, -2, k[..., None, None].expand(
        k.shape + (1, 3)))[..., 0, :]
    nk = torch.gather(n, -1, k[..., None])
    n_signed = rows / denom3 / torch.clamp_min(nk, _EPS)
    n_signed = torch.where(F.one_hot(k, 3).bool(), n, n_signed)
    omega_pi = theta[..., None] * n_signed

    return torch.where((d > 0.999)[..., None], omega_id,
                       torch.where((nDr < 1e-3)[..., None], omega_pi,
                                   omega_gen))


def diff_rodrigues_lie_algebra(r: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO(3) at r (`diffRodriguezLieAlgebra`,
    `rotations.h:127`).  Kept for API parity; prefer torch.func.jacfwd."""
    theta = _safe_norm(r)[..., None, None]
    m = skew(r)
    small = theta < _EPS
    theta_s = torch.where(small, 1.0, theta)
    a = torch.where(small, 0.5,
                    (1.0 - torch.cos(theta_s)) / (theta_s * theta_s))
    b = torch.where(small, 1.0 / 6.0,
                    (theta_s - torch.sin(theta_s)) / (theta_s ** 3))
    return _eye(m) - a * m + b * (m @ m)


def axis_angle_to_quaternion(r: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> unit quaternion [w, x, y, z] (`rotations.h:208`)."""
    theta = _safe_norm(r)[..., None]
    small = theta < _EPS
    theta_s = torch.where(small, 1.0, theta)
    half = 0.5 * theta_s
    s = torch.where(small, 0.5, torch.sin(half) / theta_s)
    w = torch.where(small[..., 0], 1.0, torch.cos(half[..., 0]))
    q = torch.cat([w[..., None], s * r], -1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [w, x, y, z] -> axis-angle (`rotations.h:271`)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[..., 0] < 0, -1.0, 1.0)  # take the short rotation
    q = q * sign[..., None]
    w = q[..., 0]
    v = q[..., 1:]
    nv = _safe_norm(v)
    theta = 2.0 * torch.arctan2(nv, w)
    small = nv < _EPS
    scale = torch.where(small, 2.0, theta / torch.where(small, 1.0, nv))
    return scale[..., None] * v


def quaternion_product(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Hamilton product, [w, x, y, z] convention."""
    w1, x1, y1, z1 = qa[..., 0], qa[..., 1], qa[..., 2], qa[..., 3]
    w2, x2, y2, z2 = qb[..., 0], qb[..., 1], qb[..., 2], qb[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


@dataclass(frozen=True)
class RigidBodyTransform:
    """x -> R(r) x + t with r the axis-angle (`RigidBodyTransform`,
    `rotations.h:279`)."""

    r: torch.Tensor
    t: torch.Tensor

    @classmethod
    def identity(cls, device="cuda") -> "RigidBodyTransform":
        return cls(torch.zeros(3, device=device), torch.zeros(3, device=device))

    @classmethod
    def from_affine(cls, a: AffineTransform) -> "RigidBodyTransform":
        return cls(inverse_rodrigues_formula(a.R), a.t)

    def to_affine(self) -> AffineTransform:
        return AffineTransform(rodrigues_formula(self.r), self.t)

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return angle_axis_rotate(self.r, pts) + self.t

    def __mul__(self, other: "RigidBodyTransform") -> "RigidBodyTransform":
        """(self * other)(x) == self(other(x)); composition happens on the
        manifold via quaternions (`rotations.h:330-356`)."""
        q = quaternion_product(axis_angle_to_quaternion(self.r),
                               axis_angle_to_quaternion(other.r))
        return RigidBodyTransform(quaternion_to_axis_angle(q),
                                  self.apply(other.t))

    def inverse(self) -> "RigidBodyTransform":
        return RigidBodyTransform(-self.r,
                                  -angle_axis_rotate(-self.r, self.t))


@dataclass(frozen=True)
class ShapePreservingTransform:
    """7-DoF similarity x -> s R(r) x + t (`ShapePreservingTransform`,
    `rotations.h:439`)."""

    r: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor

    @classmethod
    def identity(cls, device="cuda") -> "ShapePreservingTransform":
        return cls(torch.zeros(3, device=device), torch.zeros(3, device=device),
                   torch.ones((), device=device))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        return self.s * angle_axis_rotate(self.r, pts) + self.t

    def to_affine(self) -> AffineTransform:
        return AffineTransform(self.s * rodrigues_formula(self.r), self.t)

    def __mul__(self, other):
        q = quaternion_product(axis_angle_to_quaternion(self.r),
                               axis_angle_to_quaternion(other.r))
        return ShapePreservingTransform(quaternion_to_axis_angle(q),
                                        self.apply(other.t),
                                        self.s * other.s)

    def inverse(self) -> "ShapePreservingTransform":
        inv_s = 1.0 / self.s
        return ShapePreservingTransform(
            -self.r, -inv_s * angle_axis_rotate(-self.r, self.t), inv_s)


def interpolate_rigid_body_transform_on_manifold(
        w1, t1: RigidBodyTransform, w2, t2: RigidBodyTransform
        ) -> RigidBodyTransform:
    """Weighted interpolation on SE(3): scale the delta transform by
    w2 / (w1 + w2) in the tangent space and recompose
    (`interpolateRigidBodyTransformOnManifold`, `rotations.h:424-437`)."""
    delta = t2 * t1.inverse()
    w = w2 / (w1 + w2)
    scaled = RigidBodyTransform(w * delta.r, w * delta.t)
    return scaled * t1


def euler_radxyz_to_rotation(rx, ry, rz, device="cuda") -> torch.Tensor:
    """R = Rz @ Ry @ Rx (XYZ EXTRINSIC, equivalently ZYX intrinsic;
    `eulerRadXYZToRotation`, `rotations.h:539`).  Angles are numbers or
    tensors (a tensor's device wins over ``device``)."""
    for a in (rx, ry, rz):
        if isinstance(a, torch.Tensor):
            device = a.device
    rx, ry, rz = (torch.as_tensor(a, dtype=torch.float32, device=device)
                  for a in (rx, ry, rz))
    rx, ry, rz = torch.broadcast_tensors(rx, ry, rz)
    z = torch.zeros_like(rx)
    ex = torch.stack([rx, z, z], -1)
    ey = torch.stack([z, ry, z], -1)
    ez = torch.stack([z, z, rz], -1)
    return rodrigues_formula(ez) @ rodrigues_formula(ey) @ rodrigues_formula(ex)


def euler_degxyz_to_rotation(rx, ry, rz, device="cuda") -> torch.Tensor:
    d2r = math.pi / 180.0
    return euler_radxyz_to_rotation(rx * d2r, ry * d2r, rz * d2r, device)
