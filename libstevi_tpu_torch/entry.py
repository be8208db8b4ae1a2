"""Entry points of the port, mirroring `__graft_entry__.py` and the
`bench_grid.py` configurations.

`flagship_forward` is the main path: box ZNCC cost volume (7x7 window,
D=120, bf16 volume) -> 8-direction SGM (P1=0.1, P2=0.5, Pout=100) -> tie-last
WTA -> truncated band (r=1) -> parabola subpixel, at the reference benchmark
geometry (480x640; `test/benchmarks/benchmarkCrossCorrelationAlgorithms.cpp:
370-401`).  `entry(device)` returns it with a random pair made from seed 0.

`patchmatch_forward` is the PatchMatch matcher in the `BENCH_GRID_r05` /
`PARITY_r05` configuration (NCC, 7x7 window, disparities [0, 119], 5
iterations, 4 random candidates); `wta_forward` is the per-matching-function
cost volume + WTA of `bench_grid.py:128-138` (7x7 window, D=120).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import MATCH_TRAITS, MatchingFunction, SearchOffset1
from .ops import (InterpolationKernel, dense_sgm_stereo,
                  extract_selected_index, patch_match,
                  unfold_based_cost_volume)

FLAGSHIP = dict(h_radius=3, v_radius=3, disp_width=120, P1=0.1, P2=0.5,
                n_directions=8, cost_vol_radius=1,
                refine_kernel=InterpolationKernel.PARABOLA,
                cv_dtype=torch.bfloat16)
PATCHMATCH = dict(search=SearchOffset1(0, 119), h_radius=3, v_radius=3,
                  n_iter=5, n_random=4)
WTA = dict(h_radius=3, v_radius=3, search=120)
HEIGHT, WIDTH = 480, 640


def flagship_forward(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
    """Refined disparity (H, W) float32 of a gray pair."""
    disp, _, _ = dense_sgm_stereo(MatchingFunction.ZNCC, img_l, img_r,
                                  **FLAGSHIP)
    return disp


def patchmatch_forward(img_l: torch.Tensor, img_r: torch.Tensor,
                       generator: torch.Generator | None = None) -> torch.Tensor:
    """PatchMatch NCC disparity (H, W) int32 of a gray pair; candidates come
    from ``generator`` (on the images' device)."""
    return patch_match(MatchingFunction.NCC, img_l, img_r,
                       generator=generator, **PATCHMATCH)


def wta_forward(func: MatchingFunction, img_l: torch.Tensor,
                img_r: torch.Tensor) -> torch.Tensor:
    """WTA disparity index (H, W) int32 of ``func``'s cost volume."""
    cv = unfold_based_cost_volume(func, img_l, img_r, **WTA)
    return extract_selected_index(cv, MATCH_TRAITS[func].strategy)


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship forward and a random
    480x640 pair on ``device``."""
    rng = np.random.default_rng(0)
    img_l = torch.from_numpy(
        rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32)).to(device)
    img_r = torch.from_numpy(
        rng.uniform(0, 1, (HEIGHT, WIDTH)).astype(np.float32)).to(device)
    return flagship_forward, (img_l, img_r)
