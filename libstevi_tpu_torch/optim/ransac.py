"""Generic RANSAC (counterpart of `libstevi_tpu/optim/ransac.py`).

Reference parity: `optimization/generic_ransac.h:50-330` — templated
Model/Measure/SamplingStrategy RANSAC with OpenMP-parallel iterations and
per-thread RNG.

All hypotheses' index sets are drawn up front: from a `torch.Generator`
(on the data's device), or from an injected ``draw`` (the tests replay the
JAX package's `jax.random.split` / `choice` sets through it).  Each
hypothesis is fitted and scored by the caller's functions on unbatched
data, as under the JAX package's `vmap`; the counts and residual sums stay
on the device.  The best model (most inliers, residual-sum tie-break) is
selected lexicographically; an optional final refit on the winner's
inliers uses the caller's fit function with a weight vector.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass
class RansacResult:
    model: object
    inliers: torch.Tensor       # bool mask
    n_inliers: torch.Tensor
    best_error: torch.Tensor


def tree_leaves(tree):
    """The tensors of a (tensor, tuple, list, dict) tree, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return []


def tree_map(fn, *trees):
    """``fn`` over the tensors of matching (tensor, tuple, list, dict)
    trees."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    return t


def draw_index_sets(N: int, n_samples: int, n_iterations: int,
                    generator: torch.Generator) -> torch.Tensor:
    """(n_iterations, n_samples) int64 indices in [0, N), distinct within
    each row: uniform draws, rows holding a repeat drawn again (one host
    check a round)."""
    dev = generator.device
    idx = torch.randint(0, N, (n_iterations, n_samples), generator=generator,
                        device=dev)
    while True:
        s = torch.sort(idx, dim=1).values
        rep = (s[:, 1:] == s[:, :-1]).any(1)
        n = int(rep.sum())
        if n == 0:
            return idx
        idx[rep] = torch.randint(0, N, (n, n_samples), generator=generator,
                                 device=dev)


def ransac(fit_fn: Callable, residual_fn: Callable, data, n_samples: int,
           n_iterations: int, threshold: float,
           generator: torch.Generator | None = None,
           refit_fn: Callable | None = None,
           draw: Callable | None = None) -> RansacResult:
    """``fit_fn(subset_data) -> model``; ``residual_fn(model, data) -> (N,)``
    absolute residuals; ``refit_fn(data, weights) -> model`` (optional
    weighted refit on the winning inliers).  ``data`` is a tensor or a
    (tuple, list, dict) tree of tensors leading with the sample axis N.

    The index sets come from ``draw()`` when given (an (n_iterations,
    n_samples) integer tensor), else from ``generator`` (default: seed 0
    on the data's device)."""
    leaves = tree_leaves(data)
    N, dev = leaves[0].shape[0], leaves[0].device
    if draw is not None:
        sets = torch.as_tensor(draw()).to(dev, torch.int64)
    else:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        sets = draw_index_sets(N, n_samples, n_iterations, generator)

    models, counts, errs = [], [], []
    for it in range(sets.shape[0]):
        idx = sets[it]
        model = fit_fn(tree_map(lambda a: a[idx], data))
        res = torch.abs(residual_fn(model, data))
        inl = res < threshold
        models.append(model)
        counts.append(inl.sum())
        errs.append(torch.where(inl, res, 0.0).sum())
    counts, errs = torch.stack(counts), torch.stack(errs)
    # most inliers; tie-break on lower inlier residual sum, selected
    # LEXICOGRAPHICALLY (a packed counts*1e9 - errs float score rounds the
    # residual term away: the float32 ulp at 1e9 is 64)
    best = torch.argmin(torch.where(counts == counts.max(), errs,
                                    float("inf")))
    stacked = tree_map(lambda *m: torch.stack(m), *models)
    model = tree_map(lambda m: m[best], stacked)
    res = torch.abs(residual_fn(model, data))
    inliers = res < threshold
    if refit_fn is not None:
        model = refit_fn(data, inliers.float())
        res = torch.abs(residual_fn(model, data))
        inliers = res < threshold
    return RansacResult(model=model, inliers=inliers,
                        n_inliers=inliers.sum(),
                        best_error=torch.where(inliers, res, 0.0).sum())
