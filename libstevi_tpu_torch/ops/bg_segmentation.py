"""Disparity estimation with background removal (counterpart of
`libstevi_tpu/ops/bg_segmentation.py`).

Reference parity: `correlation/disparity_plus_background_segmentation.h` —
`DisparityEstimatorWithBackgroundRemoval` (:64): precompute a background
cost volume + WTA disparity from a background image pair
(`computeBackgroundDisp`, :82); for a live pair, a pixel is background when
its cost at the background disparity is within a relative threshold of the
background's own cost there (`computeDispAndForegroundMask`, :106);
foreground pixels get a fresh WTA disparity.

Documented deviation, kept from the JAX package: the reference runs BFS
chains over neighboring pixels to confirm foreground regions (`:130-220`, a
sequential flood fill); here region consistency is enforced by a
morphological opening of the foreground mask — same intent (suppress
isolated false foreground).

The volumes come from `feature_volume_to_cost_volume`, so on CUDA tensors
the dot / SSD / SAD families launch K5 (`fv_backend`), once for the
background and once a live frame; the rest is torch ops on the volumes'
device.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.types import MATCH_TRAITS, MatchingFunction, disp_dtype
from ..core.search import SearchOffset1
from .cost_volume import extract_selected_index, feature_volume_to_cost_volume


@dataclass
class StereoDispWithBgMask:
    disp: torch.Tensor
    fg_mask: torch.Tensor     # bool, True = foreground


class DisparityEstimatorWithBackgroundRemoval:
    def __init__(self, func: MatchingFunction,
                 relative_threshold: float = 0.8, disp_tol: int = 2):
        self.func = func
        self.rel_threshold = relative_threshold
        self.disp_tol = disp_tol
        self.bg_cv = None
        self.bg_idx = None
        self.search = None

    def compute_background_disp(self, source_fv: torch.Tensor,
                                target_fv: torch.Tensor,
                                search: SearchOffset1) -> bool:
        if not search.is_valid:
            return False
        self.search = search
        self.bg_cv = feature_volume_to_cost_volume(
            self.func, target_fv, source_fv, search)
        self.bg_idx = extract_selected_index(
            self.bg_cv, MATCH_TRAITS[self.func].strategy)
        return True

    def compute_disp_and_foreground_mask(self, live_cv: torch.Tensor
                                         ) -> StereoDispWithBgMask:
        """live_cv: the live pair's cost volume over the same search range."""
        from ..imageproc.morphology import dilation, opening
        assert self.bg_cv is not None, "background not computed"
        idx = self.bg_idx[..., None].long()
        cost_bg = torch.gather(self.bg_cv, -1, idx)[..., 0]
        cost_fg = torch.gather(live_cv, -1, idx)[..., 0]

        # RAW min/max ratio like the reference (`:163`): sign-opposite
        # scores (e.g. an anti-correlated occluder under ZNCC) give a
        # negative ratio and are correctly NOT similar — an abs() ratio
        # would call them background
        lo = torch.minimum(cost_bg, cost_fg)
        hi = torch.maximum(cost_bg, cost_fg)
        ratio = lo / torch.where(torch.abs(hi) > 1e-12, hi, 1e-12)
        similar = ratio > self.rel_threshold
        live_idx = extract_selected_index(
            live_cv, MATCH_TRAITS[self.func].strategy)
        # the reference's disp_tol (`:199`) stops region GROWTH at pixels
        # whose live optimum sits within the tolerance of the background
        # disparity: only disparity-displaced dissimilar pixels seed
        # regions; cost-dissimilar-but-near-bg pixels join only when
        # adjacent to a seeded region (vectorized analogue of the BFS)
        moved = torch.abs(live_idx.int() - self.bg_idx.int()) >= self.disp_tol
        strong = (~similar) & moved
        seed = opening(strong.float(), radius=1) > 0.5
        grown = dilation(seed.float(), radius=1) > 0.5
        fg = seed | ((~similar) & grown)
        disp_fg = live_idx + self.search.lower
        disp_bg = self.bg_idx + self.search.lower
        disp = torch.where(fg, disp_fg, disp_bg).to(disp_dtype)
        return StereoDispWithBgMask(disp=disp, fg_mask=fg)
