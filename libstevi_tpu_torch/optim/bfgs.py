"""BFGS quasi-Newton minimizer (counterpart of `libstevi_tpu/optim/bfgs.py`).

Reference parity: `optimization/bfgs.h` (274 LoC hand-rolled BFGS).  Here a
compact BFGS with backtracking line search; gradients come from
`torch.func.grad` instead of user-supplied closures.  The ``iters`` steps
and the ``ls_steps`` line-search halvings are fixed-length loops with no
host sync: a finished run keeps its state.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class BfgsResult:
    x: torch.Tensor
    f: torch.Tensor
    converged: torch.Tensor
    n_iter: torch.Tensor


def bfgs_minimize(fun, x0: torch.Tensor, iters: int = 100, tol: float = 1e-6,
                  ls_steps: int = 20) -> BfgsResult:
    """Minimize ``fun(x)`` from x0 with BFGS + backtracking Armijo search."""
    n = x0.shape[0]
    grad = torch.func.grad(fun)
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)

    def line_search(x, p, f0, g0):
        slope = torch.dot(g0, p)
        t = torch.ones((), dtype=x0.dtype, device=x0.device)
        done = torch.zeros((), dtype=torch.bool, device=x0.device)
        for _ in range(ls_steps):
            ok = fun(x + t * p) <= f0 + 1e-4 * t * slope
            t = torch.where(done | ok, t, t * 0.5)
            done = done | ok
        return torch.where(done, t, 0.0)

    x, H, f, g = x0, eye, fun(x0), grad(x0)
    done = torch.linalg.norm(g) < tol
    hist = []
    for _ in range(iters):
        p = -(H @ g)
        s = line_search(x, p, f, g) * p
        x_new = x + s
        g_new = grad(x_new)
        y = g_new - g
        sy = torch.dot(s, y)
        safe = sy > 1e-12
        rho = torch.where(safe, 1.0 / torch.where(safe, sy, 1.0), 0.0)
        V = eye - rho * torch.outer(s, y)
        H_new = torch.where(safe, V @ H @ V.T + rho * torch.outer(s, s), H)
        f_new = fun(x_new)
        keep = done | (torch.linalg.norm(g_new) < tol)
        x = torch.where(done, x, x_new)
        H = torch.where(done, H, H_new)
        f = torch.where(done, f, f_new)
        g = torch.where(done, g, g_new)
        done = keep
        hist.append(keep)
    n_iter = (torch.argmax(torch.stack(hist).to(torch.uint8)) + 1
              if hist else torch.tensor(iters))
    return BfgsResult(x=x, f=f, converged=done, n_iter=n_iter)
