"""Scanline dynamic-programming stereo (Cox / Birchfield style), the
counterpart of `libstevi_tpu/ops/dp_stereo.py`.

Reference parity: `correlation/dynamic_programing_stereo.h` —
`DynamicProgramming` (:37) with `JumpCostPolicy` (:56),
`SGMLikeJumpCostPolicy` (:76: P1 for |delta d| = 1, P2 for larger jumps) and
`SGMLikeWithImageGuideJumpCostPolicy` (:105: jump costs modulated by the
guide-image gradient), `extractOptimalIndex` (:134: per-row optimal path
with occlusion marking).

The JAX package's D x D jump-penalty DP is kept as it is (it departs from
LibStevi; the port matches the JAX package).  All rows run together: a
loop over columns carries the (H, D) cost-to-come and stores the argmin
transitions; a reverse loop backtracks the optimal path.  Occlusions are
marked where the backtracked path jumps by more than one disparity step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.types import disp_dtype


@dataclass
class DpStereoResult:
    disparity: torch.Tensor       # (H, W) int32
    occlusion: torch.Tensor       # (H, W) bool


def _diff_prepend_first(x: torch.Tensor) -> torch.Tensor:
    """x[:, j] - x[:, j - 1] along axis 1, 0 at j = 0."""
    return torch.diff(x, dim=1, prepend=x[:, :1])


def dp_stereo(cv: torch.Tensor, P1: float = 1.0, P2: float = 4.0,
              guide: torch.Tensor | None = None,
              guide_scale: float = 1.0) -> DpStereoResult:
    """Per-row DP over an (H, W, D) cost volume with SGM-like jump costs;
    `guide` (H, W) modulates the jump penalty by exp(-guide_scale*|grad|)
    (guide_scale sets the edge sensitivity: larger -> penalties collapse
    faster at image edges) (`SGMLikeWithImageGuideJumpCostPolicy`)."""
    H, W, D = cv.shape
    dev = cv.device
    cv = cv.float()
    dd = torch.arange(D, device=dev)
    delta = torch.abs(dd[:, None] - dd[None, :])
    base_pen = torch.where(delta == 1, P1,
                           torch.where(delta > 1, P2, 0.0)).float()
    if guide is None:
        pen = torch.ones((H, W), device=dev)
    else:
        grad = torch.abs(_diff_prepend_first(guide.float()))
        pen = torch.exp(-grad * guide_scale)

    # forward: cost-to-come (H, D) and the argmin transitions (W, H, D)
    args = torch.zeros((W, H, D), dtype=torch.int32, device=dev)
    prev = cv[:, 0]
    for j in range(1, W):
        total = prev[:, None, :] + base_pen * pen[:, j, None, None]
        best, arg = torch.min(total, dim=2)      # first minimum, as argmin
        args[j] = arg.to(torch.int32)
        prev = cv[:, j] + best

    # backtrack from the last column's optimum
    d = torch.argmin(prev, dim=-1)
    path = torch.empty((H, W), dtype=torch.int64, device=dev)
    rows = torch.arange(H, device=dev)
    for j in range(W - 1, -1, -1):
        path[:, j] = d
        d = args[j, rows, d].long()
    occl = torch.abs(_diff_prepend_first(path)) > 1
    return DpStereoResult(path.to(disp_dtype), occl)
