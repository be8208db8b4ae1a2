"""Masked inpainting (counterpart of `libstevi_tpu/imageproc/inpainting.py`).

Reference parity: `imageProcessing/inpainting.h:46,100,178` —
nearest-neighbor fill and first-order diffusion inpainting of masked pixels.

Both are sweeps of neighborhood reductions, as in the JAX package.  The
nearest fill's `lax.while_loop` (until no distance is infinite, at most
``max_iters or H + W`` sweeps) runs its sweeps in blocks of
`SWEEPS_PER_READ` between host reads: a pixel's first finite distance is
its graph distance, so sweeps after the last one that fills a pixel
change nothing, and the result equals the per-sweep loop's.  The four
neighbours are visited in the JAX order (up, down, left, right) with a
strict ``<``, so ties between equidistant neighbours go the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .connected_components import SWEEPS_PER_READ


def _neighbors(x: torch.Tensor, fill) -> list:
    """The four shifted copies of ``x`` (first two axes), in the order
    (-1, 0), (1, 0), (0, -1), (0, 1), ``fill`` outside the image."""
    H, W = x.shape[:2]
    planes = x.movedim((0, 1), (-2, -1))
    outs = []
    for di, dj in [(-1, 0), (1, 0), (0, -1), (0, 1)]:
        p = F.pad(planes, (max(0, -dj), max(0, dj), max(0, -di), max(0, di)),
                  value=fill)
        p = p[..., max(0, di):max(0, di) + H, max(0, dj):max(0, dj) + W]
        outs.append(p.movedim((-2, -1), (0, 1)))
    return outs


def nearest_neighbor_inpainting(img: torch.Tensor, mask: torch.Tensor,
                                max_iters: int | None = None) -> torch.Tensor:
    """Fill mask==True pixels with the value of the nearest (L1) valid
    pixel, propagating one ring per sweep (`inpainting.h:46`)."""
    x = img.float()
    H, W = x.shape[:2]
    m = torch.broadcast_to(mask.bool(), (H, W))
    dist = torch.where(m, torch.inf, 0.0)
    val = torch.where(m[..., None] if x.ndim == 3 else m, 0.0, x)
    cap = max_iters or H + W
    it = 0
    while it < cap and bool(torch.isinf(dist).any()):
        for _ in range(min(SWEEPS_PER_READ, cap - it)):
            nd = _neighbors(dist, torch.inf)
            nv = _neighbors(val, 0.0)
            best_d, best_v = dist, val
            for d, v in zip(nd, nv):
                better = d + 1.0 < best_d
                best_d = torch.where(better, d + 1.0, best_d)
                bm = better[..., None] if val.ndim == 3 else better
                best_v = torch.where(bm, v, best_v)
            dist, val = best_d, best_v
            it += 1
    return val


def diffusion_inpainting(img: torch.Tensor, mask: torch.Tensor,
                         iters: int = 200) -> torch.Tensor:
    """First-order (Laplace) diffusion fill: masked pixels converge to the
    average of their neighbors (`inpainting.h:100,178`)."""
    x = img.float()
    init = nearest_neighbor_inpainting(x, mask)
    m = mask.bool() if x.ndim == 2 else torch.broadcast_to(
        mask.bool()[..., None], x.shape)
    cnt = sum(_neighbors(torch.ones_like(x), 0.0))
    den = torch.clamp(cnt, min=1.0)
    cur = init
    for _ in range(iters):
        avg = sum(_neighbors(cur, 0.0)) / den
        cur = torch.where(m, avg, x)
    return cur
