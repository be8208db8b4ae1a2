"""Pose kinematics helpers (counterpart of
`libstevi_tpu/geometry/posesmath.py`).

Reference parity: `geometry/posesmath.h:38` — `computeRotationSpeed`: the
body-frame rotation rate taking pose r1 to pose r2 over dt (the axis-angle
of the delta rotation divided by dt).
"""

from __future__ import annotations

import torch

from .core import vec
from .rotations import (axis_angle_to_quaternion, quaternion_product,
                        quaternion_to_axis_angle)


def compute_rotation_speed(r1: torch.Tensor, r2: torch.Tensor,
                           dt: float) -> torch.Tensor:
    """Axis-angle rates (rad/s) of the rotation taking r1 to r2 over dt."""
    q1 = axis_angle_to_quaternion(r1)
    q2 = axis_angle_to_quaternion(r2)
    q1_inv = q1 * vec([1.0, -1.0, -1.0, -1.0], q1.device)
    delta = quaternion_product(q2, q1_inv)
    return quaternion_to_axis_angle(delta) / dt
