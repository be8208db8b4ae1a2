"""Non-local-maximum point selection (counterpart of
`libstevi_tpu/sparse/nms.py`).

Reference parity: `sparseMatching/nonLocalMaximumPointSelection.h:13` — pick
up to N highest-scoring points above a threshold such that no two selected
points are within `radius` of each other; returns float (x, y) coordinates.

A local-max prefilter (`max_pool2d` over the (2r+1)^2 window, -inf outside
the image: `reduce_window` max 'SAME') keeps only pixels equal to their
neighbourhood max, then a greedy scan of `n_points` steps: take the global
argmax (the first index on ties, as `jnp.argmax`), then set the disk of
`radius` around it to -inf.  The scan stays on the device: each step is
an argmax, a gather and an `index_fill_` of the disk's offsets in a copy
of the map framed by a -inf border as wide as the disk, with no host read.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def non_local_maximum_point_selection(score: torch.Tensor, radius: float,
                                      n_points: int,
                                      threshold: float = -math.inf):
    """Returns (coords (N, 2) float32 [x, y], values (N,), valid (N,) bool).
    Unfilled slots have valid=False, value -inf and coords (0, 0)."""
    H, W = score.shape
    s = score.float()
    dev = s.device

    # local-maximum prefilter over the suppression radius
    r = max(1, int(radius))
    local_max = F.max_pool2d(s[None, None], 2 * r + 1, stride=1,
                             padding=r)[0, 0]
    s = torch.where((s == local_max) & (s > threshold), s, -math.inf)

    # the suppression disk as flat offsets in the framed map
    R = max(0, math.ceil(radius))
    Wp = W + 2 * R
    d = np.arange(-R, R + 1)
    di, dj = np.meshgrid(d, d, indexing="ij")
    disk = (di * di + dj * dj).astype(np.float32) <= np.float32(
        float(radius) ** 2)
    offs = torch.as_tensor((di * Wp + dj)[disk], device=dev)

    framed = torch.full((H + 2 * R, Wp), -math.inf, device=dev)
    framed[R:R + H, R:R + W] = s
    flat_map = framed.view(-1)
    n = flat_map.numel()
    flats, values = [], []
    for _ in range(n_points):
        flat = torch.argmax(flat_map).view(1)
        values.append(flat_map.index_select(0, flat))
        flats.append(flat)
        # clamped: a step past the last finite score (argmax 0) writes
        # -inf over -inf
        flat_map.index_fill_(0, (flat + offs).clamp_(0, n - 1), -math.inf)
    if not flats:
        return (torch.zeros((0, 2), device=dev),
                torch.zeros(0, device=dev),
                torch.zeros(0, dtype=torch.bool, device=dev))
    flat = torch.cat(flats)
    values = torch.cat(values)
    valid = torch.isfinite(values)
    coords = torch.stack([flat % Wp - R, flat // Wp - R], -1).float()
    coords = torch.where(valid[:, None], coords, 0.0)
    return coords, values, valid
