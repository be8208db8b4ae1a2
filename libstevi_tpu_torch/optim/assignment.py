"""Optimal assignment (Hungarian) and cost-matrix helpers (a copy of
`libstevi_tpu/optim/assignment.py`: numpy and scipy only).

Reference parity: `optimization/assignement_problems.h` —
`optimalAssignement` (:167, Hungarian-style optimal assignment used for
tie-point descriptor matching) and `extendCostForNBestCosts` (:29, replicate
columns so each target can absorb up to N sources).

Host-side by design (SURVEY.md §7.6: "Hungarian assignment (host-side is
fine)"): the algorithm is branch-heavy and runs on small matrices; scipy's
`linear_sum_assignment` provides the exact optimum.
"""

from __future__ import annotations

import numpy as np


def optimal_assignment(costs: np.ndarray, maximize: bool = False):
    """Returns (row_idx, col_idx) of the optimal assignment."""
    from scipy.optimize import linear_sum_assignment
    return linear_sum_assignment(np.asarray(costs), maximize=maximize)


def extend_cost_for_n_best(costs: np.ndarray, n_best: int) -> np.ndarray:
    """Tile the column set n_best times so each column can be matched by up
    to n_best rows (`extendCostForNBestCosts`,
    `assignement_problems.h:29-70`)."""
    return np.tile(np.asarray(costs), (1, n_best))


def match_descriptors(desc_a: np.ndarray, desc_b: np.ndarray,
                      metric: str = "l2", cross_check: bool = True):
    """Descriptor matching via optimal assignment on the pairwise cost
    matrix; returns (idx_a, idx_b) pairs."""
    a = np.asarray(desc_a, np.float64)
    b = np.asarray(desc_b, np.float64)
    if metric == "l2":
        costs = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    elif metric == "hamming":
        costs = np.array([[bin(int(x) ^ int(y)).count("1")
                           for y in b.reshape(len(b), -1)[:, 0]]
                          for x in a.reshape(len(a), -1)[:, 0]], np.float64) \
            if a.ndim == 1 else _hamming_costs(a, b)
    else:
        raise ValueError(metric)
    ri, ci = optimal_assignment(costs)
    return ri, ci


def _hamming_costs(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax = a.astype(np.uint32)
    bx = b.astype(np.uint32)
    x = np.bitwise_xor(ax[:, None, :], bx[None, :, :])
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1).astype(np.float64)
