"""Covariance kernel family (counterpart of
`libstevi_tpu/statistics/covariance_kernels.py`).

Reference parity: `statistics/covarianceKernels.h:41` — Matérn kernels
(including the nu = 1/2 exponential and nu -> inf Gaussian limits).
"""

from __future__ import annotations

import math

import torch


def exponential_kernel(d: torch.Tensor, length_scale: float = 1.0,
                       variance: float = 1.0) -> torch.Tensor:
    return variance * torch.exp(-torch.abs(d) / length_scale)


def gaussian_kernel(d: torch.Tensor, length_scale: float = 1.0,
                    variance: float = 1.0) -> torch.Tensor:
    return variance * torch.exp(-(d * d) / (2.0 * length_scale * length_scale))


def matern_kernel(d: torch.Tensor, nu: float = 1.5, length_scale: float = 1.0,
                  variance: float = 1.0) -> torch.Tensor:
    """Matérn covariance for nu in {0.5, 1.5, 2.5} (closed forms) or the
    Gaussian limit for nu = inf."""
    r = torch.abs(d) / length_scale
    if nu == 0.5:
        return variance * torch.exp(-r)
    if nu == 1.5:
        s = math.sqrt(3.0) * r
        return variance * (1.0 + s) * torch.exp(-s)
    if nu == 2.5:
        s = math.sqrt(5.0) * r
        return variance * (1.0 + s + s * s / 3.0) * torch.exp(-s)
    if nu == math.inf:
        return gaussian_kernel(d, length_scale, variance)
    raise ValueError("supported nu: 0.5, 1.5, 2.5, inf")
