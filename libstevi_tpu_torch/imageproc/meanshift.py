"""Mean-shift clustering over image feature space (counterpart of
`libstevi_tpu/imageproc/meanshift.py`).

Reference parity: `imageProcessing/meanShiftClustering.h:67` —
`meanShiftClustering`: iterate each feature vector toward the
kernel-weighted mean of all vectors within the bandwidth.

All points shift together each iteration, as in the JAX package: the
pairwise kernel is one (N, N) computation a step and its weighted mean a
matrix product (a library call; the callers keep TF32 off for float32
parity).  The labels' transitive closure squares the boolean adjacency
log2(N) times; on CUDA the squaring is a float16 product (0 / 1 entries
are exact, and a positive sum of them stays positive however it rounds),
on the CPU a float32 one: the same booleans.  Labels are the first True
index of each closed row (`argmax` of a uint8 view: torch's `argmax`
refuses bool tensors, and returns the first maximum as JAX's does).
"""

from __future__ import annotations

import math

import torch


def mean_shift_clustering(features: torch.Tensor, bandwidth: float,
                          iters: int = 30, merge_tol: float | None = None):
    """features: (N, F).  Returns (modes (N, F), labels (N,)) where labels
    group points whose modes coincide within merge_tol (default
    bandwidth/2)."""
    x = features.float()
    cur = x
    for _ in range(iters):
        d2 = torch.sum((cur[:, None, :] - x[None, :, :]) ** 2, -1)
        w = torch.exp(-d2 / (2.0 * bandwidth * bandwidth))
        cur = (w @ x) / torch.sum(w, -1, keepdim=True)
    modes = cur

    tol = bandwidth / 2.0 if merge_tol is None else merge_tol
    d2 = torch.sum((modes[:, None, :] - modes[None, :, :]) ** 2, -1)
    same = d2 <= tol * tol
    # transitively close the proximity relation before labeling: chains
    # of modes within tolerance must share ONE canonical label (argmax
    # of the raw relation can name a point that itself carries a
    # different label).  log2(n) squarings of the boolean adjacency.
    n = same.shape[0]
    steps = max(1, math.ceil(math.log2(max(n, 2))))
    dt = torch.float16 if same.is_cuda else torch.float32
    closed = same
    for _ in range(steps):
        m = closed.to(dt)
        closed = (m @ m > 0) | closed
    labels = torch.argmax(closed.to(torch.uint8), dim=1)
    return modes, labels
