"""Edge extraction and pixel rasterization of lines / triangles
(counterpart of `libstevi_tpu/imageproc/edges.py`).

Reference parity: `imageProcessing/edgesDetection.h:39` (gradient-based edge
extraction), `imageProcessing/pixelsLines.h:33` (line rasterization) and
`imageProcessing/pixelsTriangles.h:47` (triangle rasterization with
barycentric weights).

The hysteresis grows the strong edges through the weak ones to the fixed
point of the JAX package's `while_loop`, run by
`connected_components.fixed_point` (blocks of sweeps between host reads;
growth only adds pixels, so the fixed point is the same); the sweeps run
are kept on ``detect_edges.sweeps``.  The rasterizers are the JAX
package's numpy code.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .connected_components import fixed_point
from .filters import gaussian_blur
from .finite_differences import finite_difference
from .morphology import _shifted, dilation


def detect_edges(image: torch.Tensor, low: float = 0.1, high: float = 0.3
                 ) -> torch.Tensor:
    """Gradient-magnitude edges with non-maximum suppression along the
    gradient direction and double thresholding (`edgesDetection.h:39`)."""
    x = gaussian_blur(image.float(), 1.0, 2)
    # `jnp.gradient`: central differences inside, one-sided at the ends
    gy, gx = finite_difference(x, 0), finite_difference(x, 1)
    # the root and the angle in float64, rounded once to float32: the same
    # bits on every device (the CPU's float32 sqrt is off by an ulp at
    # times, and the bins and the suppression compare these values)
    mag = torch.sqrt((gx * gx + gy * gy).double()).float()
    ang = torch.atan2(gy.double(), gx.double()).float()

    # quantize direction to 4 bins and compare against the two neighbors;
    # shifts pad with -inf (a roll would wrap the opposite border in).  The
    # divisor is a tensor: CUDA turns a division by a Python number into a
    # multiply by its reciprocal
    quarter = torch.tensor(math.pi / 4, device=ang.device)
    a = torch.round(ang / quarter).to(torch.int32) % 4
    shifts = [(0, 1), (1, 1), (1, 0), (1, -1)]
    nmax = torch.zeros_like(mag, dtype=torch.bool)
    for k, (di, dj) in enumerate(shifts):
        keep = ((mag >= _shifted(mag, -di, -dj, -math.inf))
                & (mag >= _shifted(mag, di, dj, -math.inf)))
        nmax = torch.where(a == k, keep, nmax)

    mx = mag.max()
    # a flat image (mx == 0) has no edges
    strong = nmax & (mag >= high * mx) & (mx > 0)
    weak = nmax & (mag >= low * mx) & (mx > 0)

    def grow(s):
        return torch.where(weak, torch.maximum(s, dilation(s, radius=1)), s)

    s, detect_edges.sweeps = fixed_point(grow, strong.float(), math.inf)
    return s > 0.5


detect_edges.sweeps = 0


def rasterize_line(p0, p1) -> np.ndarray:
    """Integer pixels of the segment p0 -> p1 (row, col), Bresenham-style
    (`pixelsLines.h:33`)."""
    r0, c0 = int(round(p0[0])), int(round(p0[1]))
    r1, c1 = int(round(p1[0])), int(round(p1[1]))
    n = max(abs(r1 - r0), abs(c1 - c0)) + 1
    rr = np.round(np.linspace(r0, r1, n)).astype(np.int64)
    cc = np.round(np.linspace(c0, c1, n)).astype(np.int64)
    keep = np.ones(n, bool)
    keep[1:] = (rr[1:] != rr[:-1]) | (cc[1:] != cc[:-1])
    return np.stack([rr[keep], cc[keep]], 1)


def rasterize_triangle(v0, v1, v2, shape=None):
    """Pixels inside the triangle with their barycentric weights
    (`pixelsTriangles.h:47`).  Returns (pixels (N, 2), weights (N, 3))."""
    v = np.asarray([v0, v1, v2], np.float64)
    rmin = int(np.floor(v[:, 0].min()))
    rmax = int(np.ceil(v[:, 0].max()))
    cmin = int(np.floor(v[:, 1].min()))
    cmax = int(np.ceil(v[:, 1].max()))
    if shape is not None:
        rmin = max(rmin, 0); cmin = max(cmin, 0)
        rmax = min(rmax, shape[0] - 1); cmax = min(cmax, shape[1] - 1)
    rr, cc = np.meshgrid(np.arange(rmin, rmax + 1),
                         np.arange(cmin, cmax + 1), indexing="ij")
    p = np.stack([rr.ravel(), cc.ravel()], 1).astype(np.float64)
    d = (v[1, 0] - v[0, 0]) * (v[2, 1] - v[0, 1]) \
        - (v[2, 0] - v[0, 0]) * (v[1, 1] - v[0, 1])
    if abs(d) < 1e-12:
        return np.zeros((0, 2), np.int64), np.zeros((0, 3))
    w1 = ((p[:, 0] - v[0, 0]) * (v[2, 1] - v[0, 1])
          - (v[2, 0] - v[0, 0]) * (p[:, 1] - v[0, 1])) / d
    w2 = ((v[1, 0] - v[0, 0]) * (p[:, 1] - v[0, 1])
          - (p[:, 0] - v[0, 0]) * (v[1, 1] - v[0, 1])) / d
    w0 = 1.0 - w1 - w2
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    return (p[inside].astype(np.int64),
            np.stack([w0[inside], w1[inside], w2[inside]], 1))
