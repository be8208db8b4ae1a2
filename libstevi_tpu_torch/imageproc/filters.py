"""Standard convolution filters (counterpart of
`libstevi_tpu/imageproc/filters.py`).

Reference parity: `imageProcessing/standardConvolutionFilters.h` —
`separatedGaussianFilters` (:213: taps exp(-d^2 / 2 sigma^2), optionally
normalized), `finiteDifferencesKernels` (:278: [-1, 0, 1]) and
`extendLinearKernels` (:325: [1, 2, 1]).  The tap generators are the JAX
package's numpy code; the passes run through `convolutions.Filter`.
"""

from __future__ import annotations

import numpy as np
import torch

from .convolutions import Filter, PaddingInfos, PaddingType


def gaussian_filter_taps(sigma: float, radius: int,
                         normalize: bool = True) -> np.ndarray:
    d = np.arange(-radius, radius + 1, dtype=np.float64)
    taps = np.exp(-(d * d) / (2.0 * sigma * sigma))
    if normalize:
        taps /= taps.sum()
    return taps.astype(np.float32)


def separated_gaussian_filter(sigma: float, radius: int,
                              normalize: bool = True,
                              mode: PaddingType = PaddingType.MIRROR):
    """Returns the two 1-D Filter passes (vertical then horizontal)."""
    taps = torch.from_numpy(gaussian_filter_taps(sigma, radius, normalize))
    pad = PaddingInfos(radius, mode=mode)
    no = PaddingInfos(0)
    v = Filter(taps[:, None], (pad, no))
    h = Filter(taps[None, :], (no, pad))
    return v, h


def finite_differences_kernel() -> np.ndarray:
    return np.asarray([-1.0, 0.0, 1.0], np.float32)


def extend_linear_kernel() -> np.ndarray:
    return np.asarray([1.0, 2.0, 1.0], np.float32)


def gaussian_blur(img: torch.Tensor, sigma: float, radius: int | None = None,
                  mode: PaddingType = PaddingType.MIRROR) -> torch.Tensor:
    if radius is None:
        radius = max(1, int(3 * sigma))
    v, h = separated_gaussian_filter(sigma, radius, True, mode)
    return h.convolve(v.convolve(img))
