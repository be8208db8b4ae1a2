"""Hierarchical (coarse-to-fine) matcher (counterpart of
`libstevi_tpu/ops/hierarchical.py`).

Reference parity: `correlation/hierarchical.h` — `buildFeaturePyramid` (:46,
unfold at each x2 average-pooled level), `computeGuidedCV` (:74: bilinear
align-corners-style upsample of the coarse disparity guide with the
reference's exact edge handling, x2 disparity upscale, truncated CV of
radius `upscale_disp_radius` around the guide, window recentering when a
better local optimum is found), and `hiearchicalTruncatedCostVolume` (:236,
recursive descent, coarsest level = full CV + WTA at (disp_width+1)/2^depth).

The reference's sequential recentering loop (:194-226) is algebraically
equivalent to evaluating the truncated window twice — once around the guide
to find the refined optimum d_r, once around d_r — because the shifted and
refilled window ends up exactly centered on d_r.  Both passes gather the
target feature vectors along W (`torch.gather` at a clamped column, the
slot zeroed where its own column lies outside the image), one window slot
at a time.  The coarsest level's full volume is `unfold_based_cost_volume`:
K1 on CUDA for a dot-family cost on gray images, K5 through
`aggregate_cost` for an unfold-route cost K5 takes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.types import (MatchingFunction, MATCH_TRAITS, ExtractionStrategy,
                          DispDirection, disp_dtype)
from ..interpolation.downsampling import average_pooling_downsample
from .cost_volume import (normalize_feature_volume, unfold_based_cost_volume,
                          extract_selected_index, _source_target)
from .matching import feature_comparison
from .unfold import unfold


@dataclass
class OffsetedCostVolume:
    """`OffsetedCostVolume` (`hierarchical.h:34-37`): the truncated cost
    volume around the estimate plus the (positive) disparity estimate."""

    truncated_cost_volume: torch.Tensor
    disp_estimate: torch.Tensor


def _bilinear_guide(disp_guide: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Upsample the coarse guide to (h, w) with the reference's exact
    bilinear scheme (`hierarchical.h:116-155`), including the x2 disparity
    upscale.  The positions divide by a tensor: CUDA turns a division by a
    Python number into a multiply by its reciprocal, which moves a floor,
    a ceil or a later rounding by an ulp.  The divisor is filled on the
    device (`torch.full`): a copy from the host would wait for the
    stream."""
    hg, wg = disp_guide.shape
    dev = disp_guide.device
    g = disp_guide.float()

    def positions(n, ng):
        return (torch.arange(n, dtype=torch.float32, device=dev) * (ng - 1)
                / torch.full((), n - 1, dtype=torch.float32, device=dev))

    def bounds(pos, size):
        lo = torch.floor(pos).to(torch.int32)
        hi = torch.ceil(pos).to(torch.int32)
        hi = torch.where(lo == hi, hi + 1, hi)
        shift = hi == size
        return torch.where(shift, lo - 1, lo), torch.where(shift, hi - 1, hi)

    v_pos, h_pos = positions(h, hg), positions(w, wg)
    v0, v1 = bounds(v_pos, hg)
    h0, h1 = bounds(h_pos, wg)

    wv = (v_pos - v0.float())[:, None]
    wh = (h_pos - h0.float())[None, :]

    v0, v1, h0, h1 = (t.long() for t in (v0, v1, h0, h1))
    g11 = g[v1][:, h1]
    g01 = g[v0][:, h1]
    g10 = g[v1][:, h0]
    g00 = g[v0][:, h0]

    interp = (wv * wh * g11 + (1 - wv) * wh * g01
              + wv * (1 - wh) * g10 + (1 - wv) * (1 - wh) * g00)
    return interp * 2.0


def _window_costs(func: MatchingFunction, source_fv: torch.Tensor,
                  target_fv: torch.Tensor, center: torch.Tensor, radius: int,
                  cv_dtype) -> torch.Tensor:
    """costs[..., k] = compare(source[i, j], target[i, j + center + k -
    radius]), a zero target vector out of range.  ``center`` is (H, W)
    int32 of *index-space* disparities (already sign-folded).  Validity is
    per slot: each slot is zeroed where its own target column lies outside
    the image, whatever the center's column."""
    H, W, F = target_fv.shape
    base_j = torch.arange(W, device=center.device)[None, :] + center
    outs = []
    for k in range(2 * radius + 1):
        t_j = base_j + (k - radius)
        inb = (t_j >= 0) & (t_j < W)
        idx = t_j.clamp(0, W - 1).long()[..., None].expand(H, W, F)
        g = torch.where(inb[..., None], torch.gather(target_fv, 1, idx), 0)
        outs.append(feature_comparison(func, source_fv, g).to(cv_dtype))
    return torch.stack(outs, dim=-1)


def compute_guided_cv(func: MatchingFunction, fv_l: torch.Tensor,
                      fv_r: torch.Tensor, disp_guide: torch.Tensor,
                      upscale_disp_radius: int = 2,
                      direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                      cv_dtype=torch.float32) -> OffsetedCostVolume:
    """Truncated cost volume around the (upscaled) disparity guide with
    recentering (`computeGuidedCV`, `hierarchical.h:74-233`).  Feature
    volumes must already be normalized for ``func``."""
    traits = MATCH_TRAITS[func]
    source_fv, target_fv = _source_target(direction, fv_l, fv_r)
    dir_sign = direction.delta_sign
    H, W, _ = source_fv.shape
    r = upscale_disp_radius

    guide = _bilinear_guide(disp_guide, H, W)
    d0 = (dir_sign * torch.round(guide)).to(torch.int32)  # index-space center

    # pass 1: window around d0.  The reference stores slot
    # dirSign*delta + r for delta in [-r, r] (slot k <-> delta =
    # dir_sign * (k - r), target position j + d0 + delta); _window_costs
    # evaluates slots at j + d0 + (k - r), so LEFT_TO_RIGHT flips the slot
    # axis to match.
    costs0 = _window_costs(func, source_fv, target_fv, d0, r, cv_dtype)
    if dir_sign == -1:
        costs0 = torch.flip(costs0, dims=(-1,))

    # refined optimum: the reference iterates delta = -r..r with strict
    # improvement, so the FIRST optimum in delta order wins; in slot order
    # that is ascending k for RIGHT_TO_LEFT and descending k for
    # LEFT_TO_RIGHT (torch's argmin returns the first optimum).
    vals = costs0 if traits.strategy is ExtractionStrategy.COST else -costs0
    if dir_sign == 1:
        k_best = torch.argmin(vals, dim=-1)
    else:
        k_best = vals.shape[-1] - 1 - torch.argmin(torch.flip(vals, (-1,)),
                                                   dim=-1)
    d_r = d0 + dir_sign * (k_best.to(torch.int32) - r)
    disp_estimate = (dir_sign * d_r).to(disp_dtype)

    # pass 2: window centered on d_r (equivalent to the reference's shift +
    # refill, `hierarchical.h:194-226`)
    costs1 = _window_costs(func, source_fv, target_fv, d_r, r, cv_dtype)
    if dir_sign == -1:
        costs1 = torch.flip(costs1, dims=(-1,))
    return OffsetedCostVolume(costs1, disp_estimate)


def hierarchical_truncated_cost_volume(
        func: MatchingFunction, img_l: torch.Tensor, img_r: torch.Tensor,
        h_radius, v_radius, disp_width: int, depth: int = 2,
        upscale_disp_radius: int = 2,
        direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
        cv_dtype=torch.float32) -> OffsetedCostVolume:
    """Coarse-to-fine matcher (`hiearchicalTruncatedCostVolume`,
    `hierarchical.h:236-314`).  ``h_radius``/``v_radius`` may be ints (same
    at all levels) or sequences of length depth+1 (coarsest first)."""
    if depth < 1:
        raise ValueError("minimum depth is 1")
    if isinstance(h_radius, int):
        h_radius = [h_radius] * (depth + 1)
    if isinstance(v_radius, int):
        v_radius = [v_radius] * (depth + 1)

    # the image pyramid (x2 average pooling a level)
    pyramid = [(img_l, img_r)]
    for _ in range(depth):
        left, right = pyramid[-1]
        pyramid.append((average_pooling_downsample(left, 2),
                        average_pooling_downsample(right, 2)))

    # coarsest level: full cost volume + WTA
    dw = disp_width
    for _ in range(depth):
        dw = (dw + 1) // 2
    cl, cr = pyramid[depth]
    cv = unfold_based_cost_volume(func, cl, cr, h_radius[0], v_radius[0], dw,
                                  direction, cv_dtype)
    disp = extract_selected_index(cv, MATCH_TRAITS[func].strategy)

    # guided refinement up the pyramid
    result = None
    for level in range(depth - 1, -1, -1):
        li, ri = pyramid[level]
        hr = h_radius[depth - level]
        vr = v_radius[depth - level]
        fv_l = normalize_feature_volume(func, unfold(hr, vr, li))
        fv_r = normalize_feature_volume(func, unfold(hr, vr, ri))
        result = compute_guided_cv(func, fv_l, fv_r, disp,
                                   upscale_disp_radius, direction, cv_dtype)
        disp = result.disp_estimate
    return result
