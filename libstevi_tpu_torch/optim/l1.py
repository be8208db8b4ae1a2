"""L1 (least absolute differences) solvers (counterpart of
`libstevi_tpu/optim/l1.py`).

Reference parity: `optimization/l1optimization.h` — `weighted_median` (:62)
and `leastAbsoluteDifferences` (:100; exact active-set descent with weighted
medians).  `affineBestL1Approximation` is the sum(x)==1 constrained variant
(the barycentric hook of the SAD/ZSAD refinement traits).

Documented deviation, kept from the JAX package: L1 is solved by IRLS
(iteratively reweighted least squares with epsilon-smoothed weights, a
fixed count of iterations, no host sync inside the loop) instead of the
reference's exact combinatorial descent: the same minimizer up to the
smoothing tolerance.  Leading dimensions of A and b are batch dimensions.
"""

from __future__ import annotations

import torch

from .lsq import _affine_parts, _atb, _full_coeffs, _matvec, gram, small_lstsq


def weighted_median(elements: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """Element at the 50% point of the weight distribution (lower weighted
    median, `l1optimization.h:36-66`)."""
    order = torch.argsort(elements, dim=-1, stable=True)
    se = torch.take_along_dim(elements, order, -1)
    sw = torch.take_along_dim(weights, order, -1)
    cum = torch.cumsum(sw, -1)
    half = cum[..., -1:] / 2.0
    idx = torch.argmax((cum >= half).to(torch.uint8), dim=-1)
    return torch.take_along_dim(se, idx[..., None], -1)[..., 0]


def least_absolute_differences(A: torch.Tensor, b: torch.Tensor,
                               tol: float = 1e-6, iters: int = 30
                               ) -> torch.Tensor:
    """argmin_x ||Ax - b||_1 via IRLS (`leastAbsoluteDifferences`,
    `l1optimization.h:100-257`)."""
    x = small_lstsq(A, b)
    for _ in range(iters):
        r = _matvec(A, x) - b
        w = 1.0 / torch.sqrt(r * r + tol)
        Aw = A * w[..., :, None]
        x = small_lstsq(gram(Aw, A), _atb(Aw, b))
    return x


def affine_best_l1_approximation(A: torch.Tensor, b: torch.Tensor,
                                 tol: float = 1e-6, iters: int = 30
                                 ) -> torch.Tensor:
    """argmin_x ||Ax - b||_1 s.t. sum(x) == 1
    (`affineBestL1Approximation`, `l1optimization.h:258+`)."""
    M, b0 = _affine_parts(A)
    return _full_coeffs(least_absolute_differences(M, b - b0, tol, iters))
