"""Least-median-of-absolute-residuals (LMedS) solvers (counterpart of
`libstevi_tpu/optim/lmeds.py`).

Reference parity: `optimization/leastmedianoptimization.h` —
`leastAbsoluteMedian` (:38,119: enumerate dimsIn-element subsets via
`ChooseInSetIndexer`, solve each exactly, keep the solution with the lowest
median absolute residual) and `affineBestLeastMedianApproximation`
(:180,204; the MEDAD/ZMEDAD barycentric hook, optionally restricted to
caller-supplied test subsets).

The subsets are static (the JAX package's, bit for bit); every subset of
every system in the batch is solved in one batched call, 64 subsets at a
time to bound the working set.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from .lsq import _affine_parts, _full_coeffs, _matvec, small_lstsq

_MAX_SUBSETS = 512
_SUBSET_CHUNK = 64     # subsets solved in one batched call


def _subsets(n: int, k: int, cap: int = _MAX_SUBSETS) -> np.ndarray:
    """All k-subsets when they fit under ``cap``; otherwise ``cap``
    subsets sampled uniformly with a fixed seed.  A lexicographic PREFIX
    would put the first rows in every subset — one outlier there would
    then contaminate every candidate model, defeating LMedS entirely."""
    total = math.comb(n, k)
    if total <= cap:
        return np.asarray(list(itertools.combinations(range(n), k)),
                          np.int32)
    rng = np.random.default_rng(0)
    picks = {tuple(np.sort(rng.choice(n, k, replace=False)))
             for _ in range(2 * cap)}
    combos = sorted(picks)[:cap]
    return np.asarray(combos, np.int32)


def _median_abs(r: torch.Tensor) -> torch.Tensor:
    """Upper median (nth_element at n/2), matching `MedianAbsDiff`."""
    k = r.shape[-1] // 2
    return torch.sort(torch.abs(r), dim=-1).values[..., k]


def _solve_square(As: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    """x of (As + 1e-12 I) x = bs, as the JAX package's `jnp.linalg.solve`
    gives it: a block that stays singular in float32 gives inf / NaN, it
    does not raise (`torch.linalg.solve_ex`; one unknown: the division)."""
    k = As.shape[-1]
    if k == 1:
        return bs / (As[..., 0] + 1e-12)
    eye = torch.eye(k, dtype=As.dtype, device=As.device)
    return torch.linalg.solve_ex(As + 1e-12 * eye, bs).result


def least_absolute_median(A: torch.Tensor, b: torch.Tensor,
                          subsets: np.ndarray | None = None) -> torch.Tensor:
    """argmin_x median(|Ax - b|) by exact subset solves
    (`leastAbsoluteMedian`, `leastmedianoptimization.h:38-178`).  A is
    (..., n, k), b (..., n); the first subset of lowest median wins (a NaN
    median wins first, as `jnp.argmin` and `torch.argmin` pick it)."""
    n, k = A.shape[-2:]
    if subsets is None:
        subsets = _subsets(n, k)
    subsets = np.asarray(subsets)
    square = subsets.shape[1] == k
    idx = torch.from_numpy(subsets.astype(np.int64)).to(A.device)
    best_x = best_med = None
    for s0 in range(0, idx.shape[0], _SUBSET_CHUNK):
        sub = idx[s0:s0 + _SUBSET_CHUNK]                  # (S, n_sub)
        As = A[..., sub, :]                               # (..., S, n_sub, k)
        bs = b[..., sub]
        x = _solve_square(As, bs) if square else small_lstsq(As, bs)
        med = _median_abs(_matvec(A[..., None, :, :], x) - b[..., None, :])
        j = torch.argmin(med, dim=-1)                     # (...,)
        m = torch.take_along_dim(med, j[..., None], -1)[..., 0]
        xj = torch.take_along_dim(x, j[..., None, None], -2)[..., 0, :]
        if best_x is None:
            best_x, best_med = xj, m
            continue
        win = (m < best_med) | (torch.isnan(m) & ~torch.isnan(best_med))
        best_x = torch.where(win[..., None], xj, best_x)
        best_med = torch.where(win, m, best_med)
    return best_x


def affine_best_least_median_approximation(A: torch.Tensor, b: torch.Tensor,
                                           subsets: np.ndarray | None = None
                                           ) -> torch.Tensor:
    """LMedS with the sum(x) == 1 constraint
    (`affineBestLeastMedianApproximation`,
    `leastmedianoptimization.h:180-221`)."""
    M, b0 = _affine_parts(A)
    return _full_coeffs(least_absolute_median(M, b - b0, subsets))
