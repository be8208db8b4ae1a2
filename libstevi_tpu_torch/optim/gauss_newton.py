"""Gauss-Newton solver framework (counterpart of
`libstevi_tpu/optim/gauss_newton.py`).

Reference parity: `optimization/gaussnewtownproblem.h:84-208` — the abstract
`GaussNewtownProblem` (user supplies residuals + Jacobian, QR-solved steps,
optional robust kernel, solution history, convergence status).

The user supplies only a residual function of torch ops; the Jacobian
comes from `torch.func.jacfwd` (replacing the virtual `computeJacobian`),
the iteration is a Python loop of ``iters`` damped steps with the
solution history stacked, and the status is read from the device once,
at the end.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable

import torch

from .huber import huber_weight


class ConvergenceType(enum.Enum):
    ERROR = 0
    CONVERGED = 1
    MAX_STEPS_REACHED = 2


@dataclass
class GNResult:
    x: torch.Tensor
    history: torch.Tensor         # (iters+1, n) solution history
    residual_norm: torch.Tensor
    converged: torch.Tensor       # bool: step norm fell below tolerance
    status: ConvergenceType | None = None


def normal_equations(residual_fn: Callable, x: torch.Tensor, *args,
                     huber_delta: float | None = None):
    """(J^T J, J^T r) of ``residual_fn`` at x (Huber-weighted when
    ``huber_delta`` is set), J from `torch.func.jacfwd`."""
    r = residual_fn(x, *args)
    J = torch.func.jacfwd(residual_fn)(x, *args)
    if huber_delta is not None:
        Jw = J * huber_weight(r, huber_delta)[:, None]
        return Jw.T @ J, Jw.T @ r
    return J.T @ J, J.T @ r


def damped_step(JtJ: torch.Tensor, Jtr: torch.Tensor,
                damping: float) -> torch.Tensor:
    """delta of (J^T J + damping I) delta = J^T r; a singular system gives
    inf / NaN as `jnp.linalg.solve` does (no raise)."""
    eye = torch.eye(JtJ.shape[-1], dtype=JtJ.dtype, device=JtJ.device)
    return torch.linalg.solve_ex(JtJ + damping * eye, Jtr).result


class GaussNewton:
    """Gauss-Newton with optional Huber robustification.

    ``residual_fn(x, *args) -> (m,)``; `solve` runs a fixed number of damped
    GN steps and reports convergence by final step size.
    """

    def __init__(self, residual_fn: Callable, iters: int = 25,
                 damping: float = 1e-8, huber_delta: float | None = None,
                 tol: float = 1e-5):
        self.residual_fn = residual_fn
        self.iters = iters
        self.damping = damping
        self.huber_delta = huber_delta
        self.tol = tol

    def solve(self, x0: torch.Tensor, *args) -> GNResult:
        x = x0
        hist, steps = [x0], []
        for _ in range(self.iters):
            JtJ, Jtr = normal_equations(self.residual_fn, x, *args,
                                        huber_delta=self.huber_delta)
            delta = damped_step(JtJ, Jtr, self.damping)
            x = x - delta
            hist.append(x)
            steps.append(torch.linalg.norm(delta))
        r = self.residual_fn(x, *args)
        conv = steps[-1] < self.tol
        # the one host read (`gaussnewtownproblem.h:121` ConvergenceType)
        status = (ConvergenceType.CONVERGED if bool(conv)
                  else ConvergenceType.MAX_STEPS_REACHED)
        return GNResult(x=x, history=torch.stack(hist, 0),
                        residual_norm=torch.linalg.norm(r),
                        converged=conv, status=status)
