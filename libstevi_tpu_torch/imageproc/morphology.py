"""Morphological operators (counterpart of
`libstevi_tpu/imageproc/morphology.py`).

Reference parity: `imageProcessing/morphologicalOperators.h:40-321` —
erosion/dilation with rectangular or circular structuring elements,
opening/closing, min/max/median feature reductions and the median filter.

Rectangular elements are `max_pool2d` over the first two axes, -inf
outside the image (`reduce_window` max 'SAME'; erosion is the negated
max-pool of the negated image, +inf outside); arbitrary elements take one
shifted slice an offset, filled outside the image.  The median filter
sorts the stacked window samples and takes the middle one (index n // 2
of the sorted (2r+1)^2 samples, as the JAX package; not `torch.median`,
which returns the lower of two middles).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def circular_structuring_element(radius: int) -> np.ndarray:
    d = np.arange(-radius, radius + 1)
    ii, jj = np.meshgrid(d, d, indexing="ij")
    return (ii * ii + jj * jj) <= radius * radius


def _offsets(element: np.ndarray):
    r0 = (element.shape[0] - 1) // 2
    r1 = (element.shape[1] - 1) // 2
    return [(int(i) - r0, int(j) - r1) for i, j in np.argwhere(element)]


def _shifted(img: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """out[i, j] = img[i + di, j + dj], ``fill`` outside the image."""
    H, W = img.shape[:2]
    p = F.pad(img.movedim((0, 1), (-2, -1)),
              (max(0, -dj), max(0, dj), max(0, -di), max(0, di)),
              value=fill).movedim((-2, -1), (0, 1))
    return p[max(0, di):max(0, di) + H, max(0, dj):max(0, dj) + W]


def _max_pool(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Max over the (2r+1)^2 window of the first two axes, -inf outside."""
    H, W = x.shape[:2]
    planes = x.reshape(H, W, -1).permute(2, 0, 1)
    out = F.max_pool2d(planes, 2 * radius + 1, stride=1, padding=radius)
    return out.permute(1, 2, 0).reshape(x.shape)


def erosion(img: torch.Tensor, element=None, radius: int = 1) -> torch.Tensor:
    """Min over the structuring element (rectangular (2r+1)^2 default)."""
    x = img.float()
    if element is None:
        return -_max_pool(-x, radius)
    out = None
    for di, dj in _offsets(np.asarray(element)):
        s = _shifted(x, di, dj, float("inf"))
        out = s if out is None else torch.minimum(out, s)
    return out


def dilation(img: torch.Tensor, element=None, radius: int = 1) -> torch.Tensor:
    x = img.float()
    if element is None:
        return _max_pool(x, radius)
    out = None
    for di, dj in _offsets(np.asarray(element)):
        s = _shifted(x, -di, -dj, -float("inf"))
        out = s if out is None else torch.maximum(out, s)
    return out


def opening(img: torch.Tensor, element=None, radius: int = 1) -> torch.Tensor:
    return dilation(erosion(img, element, radius), element, radius)


def closing(img: torch.Tensor, element=None, radius: int = 1) -> torch.Tensor:
    return erosion(dilation(img, element, radius), element, radius)


def median_filter(img: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """Window median with edge-clamped borders
    (`morphologicalOperators.h` median reduction)."""
    x = img.float()
    H, W = x.shape[:2]
    rows = torch.arange(-radius, H + radius, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-radius, W + radius, device=x.device).clamp(0, W - 1)
    p = x[rows][:, cols]                             # 'edge' padding
    w = 2 * radius + 1
    s = torch.stack([p[di:di + H, dj:dj + W]
                     for di in range(w) for dj in range(w)], -1)
    return torch.sort(s, -1).values[..., s.shape[-1] // 2]
