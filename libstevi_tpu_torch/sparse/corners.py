"""Corner detectors: Harris structure tensor and FAST segment test
(counterpart of `libstevi_tpu/sparse/corners.py`).

Reference parity: `sparseMatching/cornerDetectors.h` — `HarrisCornerMMat`
(:20: optional unnormalized Gaussian low-pass of sigma (r+1)/2 with mirror
padding, gradients from the separable [-1,0,1] x [1,2,1] kernels of
`standardConvolutionFilters.h:278-360`), `HarrisCornerScore` (:184: Noble's
measure det/trace with non-finite values zeroed), windowed (:266: M summed
over a window before scoring) and masked (:318) variants, and
`FASTCornerDetection` (:457: 16-point Bresenham-circle segment test).

The filters are separable shifted-product sums on mirror-padded tensors
(the taps applied in the JAX package's order); FAST takes the 16 circle
offsets as shifted copies of the edge-padded image and finds runs of
>= `n_contig` brighter / darker samples with a wrap-around rolling AND.
Torch ops on the input's device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..imageproc.convolutions import PaddingType, pad_axis
from ..imageproc.filters import gaussian_filter_taps
from ..ops.filters import box_filter_2d


def _conv1d(x: torch.Tensor, taps, axis: int) -> torch.Tensor:
    """Odd-length 1-D correlation with mirror padding along `axis`."""
    r = (len(taps) - 1) // 2
    xp = pad_axis(x, axis, r, r, PaddingType.MIRROR)
    n = x.shape[axis]
    out = 0.0
    for k, t in enumerate(taps):
        out = out + float(t) * xp.narrow(axis, k, n)
    return out


def _gaussian_taps(radius: int) -> np.ndarray:
    """Unnormalized Gaussian taps, sigma = (radius+1)/2
    (`cornerDetectors.h:29,46-48`; normalize=false)."""
    return gaussian_filter_taps((radius + 1) / 2.0, radius, normalize=False)


def harris_m_mat(img: torch.Tensor, low_pass_radius: int = 3):
    """Structure-tensor entries (dx^2, dx*dy, dy^2) after the optional
    Gaussian low-pass (`HarrisCornerMMat`, `cornerDetectors.h:20-72`)."""
    x = img.float()
    if low_pass_radius >= 1:
        taps = _gaussian_taps(low_pass_radius)
        x = _conv1d(x, taps, 0)
        x = _conv1d(x, taps, 1)
    # x = COLUMNS (the repo-wide image convention): dx differentiates
    # along axis 1
    dx = _conv1d(_conv1d(x, [-1.0, 0.0, 1.0], 1), [1.0, 2.0, 1.0], 0)
    dy = _conv1d(_conv1d(x, [1.0, 2.0, 1.0], 1), [-1.0, 0.0, 1.0], 0)
    return dx * dx, dx * dy, dy * dy


def _noble(a, b, c):
    score = (a * c - b * b) / (a + c)
    return torch.where(torch.isfinite(score), score, 0.0)


def harris_corner_score(img: torch.Tensor, low_pass_radius: int = 3
                        ) -> torch.Tensor:
    """Noble's corner measure det(M)/trace(M), non-finite -> 0
    (`HarrisCornerScore`, `cornerDetectors.h:184-216`).  A 3-D input is
    treated as (H, W, C) and channel scores are summed (:218-264)."""
    if img.ndim == 3:
        return sum(harris_corner_score(img[..., c], low_pass_radius)
                   for c in range(img.shape[-1]))
    return _noble(*harris_m_mat(img, low_pass_radius))


def windowed_harris_corner_score(img: torch.Tensor, window_radius: int = 2,
                                 low_pass_radius: int = 0) -> torch.Tensor:
    """Structure tensor aggregated over a window before scoring
    (`windowedHarrisCornerScore`, `cornerDetectors.h:266-316`)."""
    return _noble(*(box_filter_2d(m, window_radius, window_radius)
                    for m in harris_m_mat(img, low_pass_radius)))


def masked_harris_corner_score(img: torch.Tensor, mask: torch.Tensor,
                               window_radius: int = 2,
                               low_pass_radius: int = 0) -> torch.Tensor:
    """Windowed Harris restricted to a mask (`cornerDetectors.h:318-455`):
    masked-out pixels contribute nothing and score 0."""
    m = mask.float()
    score = _noble(*(box_filter_2d(e * m, window_radius, window_radius)
                     for e in harris_m_mat(img, low_pass_radius)))
    return torch.where(m > 0, score, 0.0)


# the 16 Bresenham circle offsets of radius 3, clockwise from 12 o'clock
_FAST_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    np.int32)


def fast_corner_detection(img: torch.Tensor, threshold: float,
                          n_contiguous: int = 12) -> torch.Tensor:
    """FAST segment test (`FASTCornerDetection`, `cornerDetectors.h:457+`):
    a pixel is a corner when >= n_contiguous consecutive circle samples are
    all brighter than center+threshold or all darker than center-threshold.
    Returns a bool (H, W) map (border ring of 3 px is False)."""
    x = img.float()
    H, W = x.shape
    rows = torch.arange(-3, H + 3, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-3, W + 3, device=x.device).clamp(0, W - 1)
    pad = x[rows][:, cols]                       # 'edge' padding
    circle = torch.stack([pad[3 + di:3 + di + H, 3 + dj:3 + dj + W]
                          for di, dj in _FAST_OFFSETS.tolist()])
    brighter = circle > (x + threshold)[None]
    darker = circle < (x - threshold)[None]

    def has_run(flags):
        ring = torch.cat([flags, flags[:n_contiguous - 1]], 0)
        run = ring[:16]
        for k in range(1, n_contiguous):
            run = run & ring[k:k + 16]
        return run.any(0)

    edge = torch.zeros((H, W), dtype=torch.bool, device=x.device)
    edge[3:H - 3, 3:W - 3] = True
    return (has_run(brighter) | has_run(darker)) & edge
