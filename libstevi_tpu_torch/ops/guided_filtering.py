"""Guided (cross/bilateral-style) cost-volume filtering (counterpart of
`libstevi_tpu/ops/guided_filtering.py`).

Reference parity: `correlation/guided_cost_filtering.h` —
`computeAggregationWindows` (:27: per-pixel aggregation weights over a
window from a guide image, spatial weight x match weight functors) and
`variableCostVolumeAggregation` (:102: weighted window sum of the cost
volume).

The window loop is a static loop of shifted slices of one zero-padded
copy; no per-pixel windows are materialized.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _shifted(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """y[i, j] = x[i + di, j + dj], zero outside the image."""
    H, W = x.shape[:2]
    pads = (0, 0) * (x.ndim - 2) + (max(0, -dj), max(0, dj),
                                    max(0, -di), max(0, di))
    p = F.pad(x, pads)
    return p[max(0, di):max(0, di) + H, max(0, dj):max(0, dj) + W]


def compute_aggregation_weights(guide: torch.Tensor, radius: int,
                                sigma_spatial: float = 3.0,
                                sigma_value: float = 0.1) -> torch.Tensor:
    """(H, W, (2r+1)^2) bilateral weights from the guide
    (`computeAggregationWindows`, `guided_cost_filtering.h:27`)."""
    g = guide.float()
    if g.ndim == 3:
        g = torch.mean(g, -1)
    H, W = g.shape
    ii = torch.arange(H, device=g.device)[:, None]
    jj = torch.arange(W, device=g.device)[None, :]
    # divisors as tensors: CUDA turns a division by a Python number into a
    # multiply by its reciprocal
    two_sv2 = torch.tensor(2.0 * sigma_value ** 2, device=g.device)
    ws = []
    for di in range(-radius, radius + 1):
        for dj in range(-radius, radius + 1):
            spatial = torch.exp(torch.tensor(
                -(di * di + dj * dj) / (2.0 * sigma_spatial ** 2),
                dtype=torch.float32, device=g.device))
            diff = _shifted(g, di, dj) - g
            match = torch.exp(-(diff * diff) / two_sv2)
            # out-of-image window slots carry ZERO weight (their zero-
            # filled guide diff would otherwise keep near-full weight at
            # dark border pixels and deflate the normalized aggregate)
            inb = ((ii + di >= 0) & (ii + di < H)
                   & (jj + dj >= 0) & (jj + dj < W))
            ws.append(torch.where(inb, spatial * match, 0.0))
    w = torch.stack(ws, -1)
    return w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-12)


def guided_cost_volume_aggregation(cv: torch.Tensor, guide: torch.Tensor,
                                   radius: int, sigma_spatial: float = 3.0,
                                   sigma_value: float = 0.1) -> torch.Tensor:
    """Weighted CV aggregation (`variableCostVolumeAggregation`,
    `guided_cost_filtering.h:102`)."""
    w = compute_aggregation_weights(guide, radius, sigma_spatial, sigma_value)
    out = torch.zeros_like(cv)
    k = 0
    for di in range(-radius, radius + 1):
        for dj in range(-radius, radius + 1):
            out = out + w[..., k:k + 1] * _shifted(cv, di, dj)
            k += 1
    return out
