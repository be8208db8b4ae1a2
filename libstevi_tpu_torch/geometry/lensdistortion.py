"""Brown lens-distortion model and single-camera image rectifier
(counterpart of `libstevi_tpu/geometry/lensdistortion.py`).

Reference parity: `geometry/lensdistortion.h` — `radialDistortion` (:35,
(k1 r^2 + k2 r^4 + k3 r^6) * pos), `tangentialDistortion` (:48),
`skewDistortion` (:163, x += B1*hx + B2*hy applied in pixel space),
Newton/fixed-point inverses (:63,117; 5 iterations by default),
`fullLensDistortionHomogeneousCoordinates` (:215) and its inverse (:260),
and `ImageRectifier` (:308; Minimal/Maximal/Same ROI + dense backward map).

Everything broadcasts over (..., 2) point tensors; the Newton inverses are
Python loops of a fixed count, and the rectifier's backward map is one
vectorized evaluation over the pixel grid; the resampling itself is
`interpolation.resample_image`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import vec
from .imagecoordinates import (focal, image_to_homogeneous,
                               homogeneous_to_image)


def radial_distortion(pos: torch.Tensor, k123) -> torch.Tensor:
    """(..., 2) homogeneous positions -> radial displacement."""
    k123 = vec(k123, pos.device)
    r2 = torch.sum(pos * pos, -1, keepdim=True)
    dr = k123[0] * r2 + k123[1] * r2 * r2 + k123[2] * r2 * r2 * r2
    return dr * pos


def tangential_distortion(pos: torch.Tensor, t12) -> torch.Tensor:
    t12 = vec(t12, pos.device)
    x, y = pos[..., 0], pos[..., 1]
    r2 = x * x + y * y
    dx = t12[1] * (r2 + 2 * x * x) + 2 * t12[0] * x * y
    dy = t12[0] * (r2 + 2 * y * y) + 2 * t12[1] * x * y
    return torch.stack([dx, dy], -1)


def skew_distortion(pos: torch.Tensor, B12, f, pp) -> torch.Tensor:
    """Homogeneous -> pixel coordinates with skew terms
    (`skewDistortion`, `lensdistortion.h:163-174`)."""
    B12 = vec(B12, pos.device)
    r = homogeneous_to_image(pos, f, pp)
    dx = B12[0] * pos[..., 0] + B12[1] * pos[..., 1]
    return torch.stack([r[..., 0] + dx, r[..., 1]], -1)


def inverse_skew_distortion(pos: torch.Tensor, B12, f, pp) -> torch.Tensor:
    B12 = vec(B12, pos.device)
    f = focal(f, pos)
    pp = vec(pp, pos.device)
    y = (pos[..., 1] - pp[1]) / f[1]
    x = (pos[..., 0] - B12[1] * y - pp[0]) / (f[0] + B12[0])
    return torch.stack([x, y], -1)


def invert_radial_distortion(pos: torch.Tensor, k123,
                             iters: int = 5) -> torch.Tensor:
    """Newton iteration on the radius (`invertRadialDistorstion`,
    `lensdistortion.h:63-82`)."""
    k1, k2, k3 = vec(k123, pos.device)
    rb = torch.linalg.vector_norm(pos, dim=-1)
    r = rb
    for _ in range(iters):
        num = r + k1 * r ** 3 + k2 * r ** 5 + k3 * r ** 7 - rb
        den = 1 + 3 * k1 * r ** 2 + 5 * k2 * r ** 4 + 7 * k3 * r ** 6
        r = r - num / den
    scale = torch.where(rb > 0, r / torch.where(rb > 0, rb, 1.0), 1.0)
    return pos * scale[..., None]


def invert_radial_tangential_distortion(pos: torch.Tensor, k123, t12,
                                        iters: int = 5) -> torch.Tensor:
    """2-D Newton on the combined forward model
    (`invertRadialTangentialDistorstion`, `lensdistortion.h:117-160`)."""
    k1, k2, k3 = vec(k123, pos.device)
    t1, t2 = vec(t12, pos.device)
    npos = pos
    for _ in range(iters):
        x, y = npos[..., 0], npos[..., 1]
        r2 = x * x + y * y
        dr = k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
        fx = x + x * dr + t2 * (r2 + 2 * x * x) + 2 * t1 * x * y - pos[..., 0]
        fy = y + y * dr + t1 * (r2 + 2 * y * y) + 2 * t2 * x * y - pos[..., 1]
        drdr2 = k1 + 2 * k2 * r2 + 3 * k3 * r2 ** 2
        drdx = 2 * drdr2 * x
        drdy = 2 * drdr2 * y
        a = 1 + dr + x * drdx + 6 * t2 * x + 2 * t1 * y
        b = 2 * t2 * y + 2 * t1 * x + x * drdy
        c = 2 * t2 * y + 2 * t1 * x + y * drdx
        d = 1 + dr + y * drdy + 6 * t1 * y + 2 * t2 * x
        det = a * d - b * c
        nx = x - (d * fx - b * fy) / det
        ny = y - (-c * fx + a * fy) / det
        npos = torch.stack([nx, ny], -1)
    return npos


def invert_tangential_distortion(pos: torch.Tensor, t12,
                                 iters: int = 5) -> torch.Tensor:
    """(`invertTangentialDistorstion`, `lensdistortion.h:85-114`)."""
    t1, t2 = vec(t12, pos.device)
    npos = pos
    for _ in range(iters):
        x, y = npos[..., 0], npos[..., 1]
        r2 = x * x + y * y
        fx = x + t2 * (r2 + 2 * x * x) + 2 * t1 * x * y - pos[..., 0]
        fy = y + t1 * (r2 + 2 * y * y) + 2 * t2 * x * y - pos[..., 1]
        a = 1 + 6 * t2 * x + 2 * t1 * y
        b = 2 * t2 * y + 2 * t1 * x
        c = b
        d = 1 + 6 * t1 * y + 2 * t2 * x
        det = a * d - b * c
        nx = x - (d * fx - b * fy) / det
        ny = y - (-c * fx + a * fy) / det
        npos = torch.stack([nx, ny], -1)
    return npos


def full_lens_distortion_homogeneous(pos: torch.Tensor, f, pp,
                                     k123=None, t12=None, B12=None
                                     ) -> torch.Tensor:
    """Homogeneous coords -> distorted pixel coords
    (`fullLensDistortionHomogeneousCoordinates`, `lensdistortion.h:215-250`)."""
    m = pos
    if k123 is not None:
        m = m + radial_distortion(pos, k123)
    if t12 is not None:
        m = m + tangential_distortion(pos, t12)
    if B12 is not None:
        B12a = vec(B12, pos.device)
        r = homogeneous_to_image(m, f, pp)
        dx = B12a[0] * m[..., 0] + B12a[1] * m[..., 1]
        return torch.stack([r[..., 0] + dx, r[..., 1]], -1)
    return homogeneous_to_image(m, f, pp)


def invert_full_lens_distortion_homogeneous(pos: torch.Tensor, f, pp,
                                            k123=None, t12=None, B12=None,
                                            iters: int = 5) -> torch.Tensor:
    """Distorted pixel coords -> homogeneous coords
    (`invertFullLensDistortionHomogeneousCoordinates`,
    `lensdistortion.h:260-296`)."""
    if B12 is not None:
        inv = inverse_skew_distortion(pos, B12, f, pp)
    else:
        inv = image_to_homogeneous(pos, f, pp)
    if k123 is None and t12 is None:
        return inv
    if k123 is None:
        return invert_tangential_distortion(inv, t12, iters)
    if t12 is None:
        return invert_radial_distortion(inv, k123, iters)
    return invert_radial_tangential_distortion(inv, k123, t12, iters)


def pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) float32 [x, y] pixel positions (`meshgrid`, 'xy')."""
    jj, ii = torch.meshgrid(
        torch.arange(w, dtype=torch.float32, device=device),
        torch.arange(h, dtype=torch.float32, device=device), indexing="xy")
    return torch.stack([jj, ii], -1)


class ImageRectifier:
    """Single-camera undistortion: ROI + dense backward resampling map
    (`ImageRectifier`, `lensdistortion.h:308-592`).

    ROI methods: 'same' (full source frame), 'maximal' (bounding box of the
    undistorted border), 'minimal' (largest box inside the undistorted
    border).  The backward map is (H_roi, W_roi, 2) of (row, col) source
    coordinates, built by one vectorized forward-distortion over the grid
    on ``device``; the ROI is decided on the host from the undistorted
    border.
    """

    MINIMAL, MAXIMAL, SAME = "minimal", "maximal", "same"

    def __init__(self, f, pp, source_size, k123=None, t12=None, B12=None,
                 device="cuda"):
        self.device = torch.device(device)
        self.f = vec(f, self.device).expand(2)
        self.pp = vec(pp, self.device)
        self.source_size = tuple(int(s) for s in source_size)  # (H, W)
        self.k123, self.t12, self.B12 = k123, t12, B12
        self.roi_top_left = None
        self.roi_bottom_right = None
        self.backward_map = None

    def _undistort_pixels(self, pts: torch.Tensor) -> np.ndarray:
        hom = invert_full_lens_distortion_homogeneous(
            pts, self.f, self.pp, self.k123, self.t12, self.B12)
        return homogeneous_to_image(hom, self.f, self.pp).cpu().numpy()

    def compute(self, roi_method: str = "same") -> bool:
        H, W = self.source_size
        if roi_method == self.SAME:
            tl = np.array([0, 0])
            br = np.array([H - 1, W - 1])
        else:
            # undistorted positions of the border pixels
            xs = torch.arange(W, dtype=torch.float32, device=self.device)
            ys = torch.arange(H, dtype=torch.float32, device=self.device)
            zw, zh = torch.zeros_like(xs), torch.zeros_like(ys)
            ut = self._undistort_pixels(torch.stack([xs, zw], -1))
            ub = self._undistort_pixels(torch.stack([xs, zw + (H - 1.0)], -1))
            ul = self._undistort_pixels(torch.stack([zh, ys], -1))
            ur = self._undistort_pixels(torch.stack([zh + (W - 1.0), ys], -1))
            if roi_method == self.MAXIMAL:
                all_pts = np.concatenate([ut, ub, ul, ur], 0)
                tl = np.array([np.floor(all_pts[:, 1].min()),
                               np.floor(all_pts[:, 0].min())]).astype(int)
                br = np.array([np.ceil(all_pts[:, 1].max()),
                               np.ceil(all_pts[:, 0].max())]).astype(int)
            elif roi_method == self.MINIMAL:
                tl = np.array([np.ceil(ut[:, 1].max()),
                               np.ceil(ul[:, 0].max())]).astype(int)
                br = np.array([np.floor(ub[:, 1].min()),
                               np.floor(ur[:, 0].min())]).astype(int)
            else:
                return False
        self.roi_top_left = tl
        self.roi_bottom_right = br
        # br is an INCLUSIVE pixel coordinate: the grid spans br - tl + 1
        # rows and columns
        rng = br - tl + 1
        if rng[0] <= 1 or rng[1] <= 1:
            return False
        new_pp = self.pp - vec([tl[1], tl[0]], self.device)
        pos = pixel_grid(int(rng[0]), int(rng[1]), self.device)
        hom = image_to_homogeneous(pos, self.f, new_pp)
        src = full_lens_distortion_homogeneous(hom, self.f, self.pp,
                                               self.k123, self.t12, self.B12)
        # map stores (row, col) like the reference (`lensdistortion.h:568-569`)
        self.backward_map = torch.stack([src[..., 1], src[..., 0]], -1)
        return True

    @property
    def target_pp(self):
        return self.pp - vec([self.roi_top_left[1], self.roi_top_left[0]],
                             self.device)
