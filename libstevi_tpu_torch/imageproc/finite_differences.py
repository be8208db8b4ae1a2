"""Central finite differences (counterpart of
`libstevi_tpu/imageproc/finite_differences.py`).

Reference parity: `imageProcessing/finiteDifferences.h:12,74` — central
differences (x[i+1] - x[i-1]) / 2 along a chosen axis, one-sided at the
borders.
"""

from __future__ import annotations

import torch


def finite_difference(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    x = x.float()
    central = (torch.roll(x, -1, axis) - torch.roll(x, 1, axis)) / 2.0
    n = x.shape[axis]
    first = x.narrow(axis, 1, 1) - x.narrow(axis, 0, 1)
    last = x.narrow(axis, n - 1, 1) - x.narrow(axis, n - 2, 1)
    return torch.cat([first, central.narrow(axis, 1, n - 2), last], axis)


def gradient_2d(img: torch.Tensor):
    """(d/drow, d/dcol) central-difference gradients."""
    return finite_difference(img, 0), finite_difference(img, 1)
