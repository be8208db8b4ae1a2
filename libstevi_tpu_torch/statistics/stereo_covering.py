"""Left/right covering statistics (occlusion-consistency metric; the
counterpart of `libstevi_tpu/statistics/stereo_covering.py`).

Reference parity: `statistics/stereo_covering.h:31,88` — `computeCovering`:
each target pixel votes its (fractionally split) weight into the source
column it maps to under the target disparity; `computeCoveringProportion`
counts pixels whose accumulated covering reaches a threshold.

Note: the reference splits the fractional weight as ``propLow = sourcePix -
higher`` / ``propHigh = 1 - propLow`` (`stereo_covering.h:69-71`), which is
negative on the low bin for non-integer positions; the split is replicated
verbatim (it sums to 1 and is exact for integer disparities).

The votes are two `index_put_` scatters with ``accumulate=True``: on the
card their float adds land in another order than on the CPU (ulps).  The
source columns convert to integers as the JAX package's casts do (XLA's
float to int32: NaN to 0, out of range saturated), so a NaN disparity
votes NaN into column 0 in both packages.
"""

from __future__ import annotations

import torch

from ..core.types import DispDirection


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float -> int32 conversion read back as float32: NaN -> 0,
    values past the int32 range saturated (torch's cast leaves both
    undefined)."""
    x = torch.where(torch.isnan(x), 0.0, x)
    return torch.clamp(x, -2.0 ** 31, 2.0 ** 31)


def compute_covering(disp_l: torch.Tensor, disp_r: torch.Tensor,
                     direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                     disp_scaling: float = 1.0, disp_offset: float = 0.0
                     ) -> torch.Tensor:
    """Covering mask over the SOURCE image (source = right for
    RIGHT_TO_LEFT)."""
    sign = direction.delta_sign
    if direction is DispDirection.RIGHT_TO_LEFT:
        target = disp_l.float()
    else:
        target = disp_r.float()
    H, W = target.shape

    jj = torch.arange(W, dtype=torch.float32, device=target.device)[None, :]
    source_pix = jj - sign * disp_scaling * (target - disp_offset)
    lower = _as_int32(torch.floor(source_pix))
    higher = _as_int32(torch.ceil(source_pix))
    prop_low = source_pix - higher
    prop_high = 1.0 - prop_low

    mask = torch.zeros((H, W), dtype=torch.float32, device=target.device)
    rows = torch.arange(H, device=target.device)[:, None].expand(H, W)

    lo_ok = (lower >= 0) & (lower < W)
    hi_ok = (higher >= 0) & (higher < W)
    mask.index_put_((rows, lower.clamp(0, W - 1).long()),
                    torch.where(lo_ok, prop_low, 0.0), accumulate=True)
    mask.index_put_((rows, higher.clamp(0, W - 1).long()),
                    torch.where(hi_ok, prop_high, 0.0), accumulate=True)
    return mask


def compute_covering_proportion(disp_l: torch.Tensor, disp_r: torch.Tensor,
                                covering_threshold: float = 0.5,
                                direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                                disp_scaling: float = 1.0,
                                disp_offset: float = 0.0) -> torch.Tensor:
    cov = compute_covering(disp_l, disp_r, direction, disp_scaling,
                           disp_offset)
    return torch.mean((cov >= covering_threshold).float())
