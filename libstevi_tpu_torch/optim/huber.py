"""Huber loss family (counterpart of `libstevi_tpu/optim/huber.py`).

Reference parity: `optimization/huber_kernel.h:34-148` — Huber, pseudo-Huber
and sqrt-Huber kernels (derivatives come from autodiff; the value
functions match the reference definitions).
"""

from __future__ import annotations

import torch


def huber_loss(r: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = torch.abs(r)
    return torch.where(a <= delta, 0.5 * r * r, delta * (a - 0.5 * delta))


def pseudo_huber_loss(r: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    return delta * delta * (torch.sqrt(1.0 + (r / delta) ** 2) - 1.0)


def sqrt_huber_loss(r: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """sqrt of the Huber kernel, usable as a robust residual reweighting
    in Gauss-Newton (`huber_kernel.h:120-148`)."""
    return torch.sqrt(huber_loss(r, delta))


def huber_weight(r: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """IRLS weight w(r) = psi(r)/r for the Huber kernel."""
    a = torch.abs(r)
    return torch.where(a <= delta, 1.0, delta / torch.clamp_min(a, 1e-12))
