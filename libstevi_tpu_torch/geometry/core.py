"""Core geometry types (counterpart of `libstevi_tpu/geometry/core.py`).

Reference parity: `geometry/core.h` — `skew`/`unskew` (:28,38),
`IterativeTermination` (:56), `AffineTransform<T>` (:65; R,t with
composition and batched apply).

Transforms are frozen dataclasses of tensors; every operation broadcasts
over leading batch dimensions, and points are (..., 3) row vectors.  The
device comes from the tensors; constructors that make tensors from
nothing take ``device`` (default ``cuda``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import torch


class IterativeTermination(enum.Enum):
    ERROR = 0
    CONVERGED = 1
    MAX_STEP_REACHED = 2


def vec(values, device) -> torch.Tensor:
    """``values`` (a number, sequence, array or tensor) as a float32
    tensor on ``device``."""
    return torch.as_tensor(values, dtype=torch.float32, device=device)


def skew(r: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = r[..., 0], r[..., 1], r[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def unskew(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3), inverse of `skew` for antisymmetric m."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], -1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting the batch dims
    (`torch.linalg.cross` needs equal ranks)."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) x (..., j) -> (..., i), broadcasting the batch dims."""
    return torch.einsum("...ij,...j->...i", M, v)


@dataclass(frozen=True)
class AffineTransform:
    """x -> R @ x + t.  R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    @classmethod
    def identity(cls, device="cuda") -> "AffineTransform":
        return cls(torch.eye(3, device=device), torch.zeros(3, device=device))

    def apply(self, pts: torch.Tensor) -> torch.Tensor:
        """pts: (..., 3) -> (..., 3)."""
        return matvec(self.R, pts) + self.t

    def __mul__(self, other: "AffineTransform") -> "AffineTransform":
        """Composition: (self * other)(x) == self(other(x))."""
        return AffineTransform(self.R @ other.R, self.apply(other.t))

    def inverse(self) -> "AffineTransform":
        Rt = self.R.transpose(-1, -2)
        return AffineTransform(Rt, -matvec(Rt, self.t))
