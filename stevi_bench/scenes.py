"""Rectified gray stereo pairs made from a seed, on the device.

A scene is a set of slanted planes, each the support of a Voronoi cell of
the right (source) view: plane k has the disparity d_k(i, j) = a_k +
b_k (i - si_k) + c_k (j - sj_k), kept inside [0.05 D, 0.95 D] over the
whole image.  The right view is a smoothed random texture times each plane's
albedo.  The left view is rendered from it: left pixel (i, x) shows the
plane point (i, j) with j + d_k(i, j) = x, nearest plane (largest
disparity) first, so planes occlude one another; a left pixel that no plane
reaches (disoccluded, or out of the right view) gets fresh noise.  Both
views then get Gaussian noise and are clamped to [0, 1].  Every draw comes
from one ``torch.Generator`` seeded with the run's seed, so a seed gives the
same pairs on the same device type.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _texture(H, W, u):
    """A texture in [0, 1]: fine noise (a 3x3 mean) over a coarse one."""
    def smooth(k):
        x = F.avg_pool2d(u(1, 1, H, W), k, stride=1, padding=k // 2)[0, 0]
        lo, hi = x.amin(), x.amax()
        return (x - lo) / (hi - lo)
    return 0.7 * smooth(3) + 0.3 * smooth(15)


def make_pair(H: int, W: int, D: int, gen: torch.Generator, planes: int,
              noise: float):
    """(left, right, disparity) (H, W) float32 on ``gen``'s device: the
    pair and the ground-truth disparity of the right view."""
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    ii = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    jj = torch.arange(W, device=dev, dtype=torch.float32)[None]
    si, sj = u(planes) * H, u(planes) * W
    label = torch.stack([(ii - si[k]) ** 2 + (jj - sj[k]) ** 2
                         for k in range(planes)]).argmin(0)
    a = D * (0.2 + 0.6 * u(planes))
    b = (2 * u(planes) - 1) * (0.075 * D / H)
    c = (2 * u(planes) - 1) * (0.075 * D / W)
    albedo = 0.5 + 0.5 * u(planes)
    tex = _texture(H, W, u)
    right = tex * albedo[label]
    gt = (a[label] + b[label] * (ii - si[label]) + c[label] * (jj - sj[label]))

    best = torch.full((H, W), -1.0, device=dev)
    left = torch.empty((H, W), device=dev)
    x = jj.expand(H, W)
    for k in range(planes):
        j = (x - a[k] - b[k] * (ii - si[k]) + c[k] * sj[k]) / (1 + c[k])
        j0 = j.floor().clamp(0, W - 1).long()
        j1 = (j0 + 1).clamp(max=W - 1)
        on = ((j >= 0) & (j <= W - 1)
              & (label.gather(1, j.round().clamp(0, W - 1).long()) == k))
        d = x - j
        win = on & (d > best)
        f = j - j0
        val = (tex.gather(1, j0) * (1 - f) + tex.gather(1, j1) * f) * albedo[k]
        left = torch.where(win, val, left)
        best = torch.where(win, d, best)
    left = torch.where(best >= 0, left, u(H, W))
    left = (left + noise * torch.randn((H, W), generator=gen, device=dev))
    right = (right + noise * torch.randn((H, W), generator=gen, device=dev))
    return left.clamp(0, 1), right.clamp(0, 1), gt


def make_pool(H: int, W: int, D: int, seed: int, n: int, planes: int,
              noise: float, device: torch.device):
    """``n`` pairs from ``seed``, made on ``device`` and returned as host
    tensors (pinned where ``device`` is a CUDA device): [(left, right)]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2 ** 63 - 1))
    pin = device.type == "cuda"
    pool = []
    for _ in range(n):
        left, right, _ = make_pair(H, W, D, gen, planes, noise)
        pool.append(tuple(t.to("cpu").pin_memory() if pin else t.clone()
                          for t in (left, right)))
    return pool
