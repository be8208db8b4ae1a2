"""Kernel interpolation / image resampling (counterpart of
`libstevi_tpu/interpolation/interpolation.py`).

Reference parity: `interpolation/interpolation.h:81-216` — generic N-d kernel
interpolation with pyramid (bilinear) and bicubic kernels and Constant
(clamp) or Zero border conditions, consumed by the rectifier backward maps
and the hierarchical matcher's guide upsampling.

A KxK separable stencil is K^2 gathers of the image at clamped integer
positions, weighted by the fractional offsets.
"""

from __future__ import annotations

import torch


def _gather_clamped(img: torch.Tensor, ii: torch.Tensor, jj: torch.Tensor,
                    zero_border: bool) -> torch.Tensor:
    H, W = img.shape[:2]
    vals = img[ii.clamp(0, H - 1).long(), jj.clamp(0, W - 1).long()]
    if zero_border:
        inb = (ii >= 0) & (ii < H) & (jj >= 0) & (jj < W)
        if img.ndim == 3:
            inb = inb[..., None]
        vals = torch.where(inb, vals, 0.0)
    return vals


def _floor_frac(coords: torch.Tensor):
    ci, cj = coords[..., 0], coords[..., 1]
    i0 = torch.floor(ci).to(torch.int32)
    j0 = torch.floor(cj).to(torch.int32)
    return i0, j0, ci - i0, cj - j0


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor,
                    zero_border: bool = False) -> torch.Tensor:
    """Sample (H, W[, C]) at coords (..., 2) of (row, col) float positions
    with the pyramid (bilinear) kernel; clamped borders by default
    (`BorderCondition::Constant`)."""
    i0, j0, fi, fj = _floor_frac(coords)
    if img.ndim == 3:
        fi, fj = fi[..., None], fj[..., None]
    v00 = _gather_clamped(img, i0, j0, zero_border)
    v01 = _gather_clamped(img, i0, j0 + 1, zero_border)
    v10 = _gather_clamped(img, i0 + 1, j0, zero_border)
    v11 = _gather_clamped(img, i0 + 1, j0 + 1, zero_border)
    top = v00 * (1 - fj) + v01 * fj
    bot = v10 * (1 - fj) + v11 * fj
    return top * (1 - fi) + bot * fi


def _cubic_weights(t: torch.Tensor, a: float = -0.5):
    """Keys cubic convolution weights for offsets (-1, 0, 1, 2)."""
    t2 = t * t
    t3 = t2 * t
    w_m1 = a * (t3 - 2 * t2 + t)
    w_0 = (a + 2) * t3 - (a + 3) * t2 + 1
    w_1 = -(a + 2) * t3 + (2 * a + 3) * t2 - a * t
    w_2 = a * (t2 - t3)
    return w_m1, w_0, w_1, w_2


def bicubic_sample(img: torch.Tensor, coords: torch.Tensor,
                   zero_border: bool = False) -> torch.Tensor:
    """Keys bicubic resampling at (..., 2) (row, col) coordinates."""
    i0, j0, fi, fj = _floor_frac(coords)
    wi = _cubic_weights(fi)
    wj = _cubic_weights(fj)
    out = 0.0
    for a, di in enumerate((-1, 0, 1, 2)):
        row = 0.0
        for b, dj in enumerate((-1, 0, 1, 2)):
            v = _gather_clamped(img, i0 + di, j0 + dj, zero_border)
            wb = wj[b][..., None] if img.ndim == 3 else wj[b]
            row = row + v * wb
        wa = wi[a][..., None] if img.ndim == 3 else wi[a]
        out = out + row * wa
    return out


def interpolate_image(img: torch.Tensor, coords: torch.Tensor,
                      kernel: str = "bilinear",
                      zero_border: bool = False) -> torch.Tensor:
    """Generic entry: `interpolate` (`interpolation.h:153`) with the pyramid
    or bicubic kernel.  coords is (..., 2) of (row, col)."""
    if kernel == "bilinear":
        return bilinear_sample(img, coords, zero_border)
    if kernel == "bicubic":
        return bicubic_sample(img, coords, zero_border)
    raise ValueError(f"unknown kernel {kernel!r}")


def resample_image(img: torch.Tensor, backward_map: torch.Tensor,
                   kernel: str = "bilinear") -> torch.Tensor:
    """Resample through a dense (H', W', 2) backward map of (row, col)
    source coordinates (the rectifier output format)."""
    return interpolate_image(img, backward_map, kernel)
