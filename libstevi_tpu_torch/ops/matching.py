"""Scalar feature-comparison kernels, vectorized over the feature axis
(counterpart of `libstevi_tpu/ops/matching.py`).

Reference parity: `correlation/matching_costs.h` — `dotProduct` (:60),
`SumSquareDiff` (:101), `SumAbsDiff` (:137), `MedianAbsDiff` (:182, which is
`std::nth_element` at index F/2, i.e. the *upper* median for even F),
`hammingScalar`/`hammingDistance` (:237,253 — popcount of xor), and
`KernelBasedMututalInformation` (:279 — KDE with per-vector Gaussian kernels
of bandwidth (max-min)/n).

Every kernel maps (..., F) x (..., F) -> (...).  Census words are uint32
values held in int64 tensors (torch's uint32 takes few operations); torch
has no popcount, so `hamming_distance` counts bits with a SWAR reduction.
"""

from __future__ import annotations

import torch

from ..core.types import MatchingFunction, MATCH_TRAITS


def dot_product(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sum(source * target, dim=-1)


def sum_square_diff(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = source - target
    return torch.sum(d * d, dim=-1)


def sum_abs_diff(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.abs(source - target), dim=-1)


def median_abs_diff(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Upper median of |s - t| (reference uses nth_element at F/2,
    `matching_costs.h:190-203`).  `torch.median` returns the lower median,
    so sort and index."""
    diffs = torch.abs(source - target)
    k = diffs.shape[-1] // 2
    return torch.sort(diffs, dim=-1).values[..., k]


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each value in [0, 2^32) held in an int64 tensor (SWAR:
    pairs, nibbles, bytes, then the four byte counts summed).  Every step
    stays below 2^33, so no int64 product can overflow."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_distance(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Popcount of xor, summed over census words (`matching_costs.h:237-263`),
    as int32."""
    x = torch.bitwise_xor(source.long(), target.long()) & 0xFFFFFFFF
    return torch.sum(popcount32(x), dim=-1).to(torch.int32)


def kernel_mutual_information(source: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    """KDE-based mutual information score (`matching_costs.h:279-341`).

    O(F^2) per pixel via outer difference matrices; bandwidth is
    (max - min) / F per vector as in the reference."""
    n = source.shape[-1]
    s = source.float()
    t = target.float()

    s_std = (s.amax(-1) - s.amin(-1)) / n
    t_std = (t.amax(-1) - t.amin(-1)) / n

    ds = (s[..., :, None] - s[..., None, :]) / s_std[..., None, None]
    dt = (t[..., :, None] - t[..., None, :]) / t_std[..., None, None]
    ks = torch.exp(-ds * ds)  # (..., F, F)
    kt = torch.exp(-dt * dt)

    p_source = ks.sum(-1)              # (..., F)
    p_target = kt.sum(-1)
    p_joint = (ks * kt).sum(-1)
    p_joint_ind = p_source * p_target / n
    return torch.sum(p_joint * torch.log(p_joint / p_joint_ind), dim=-1)


_KERNELS = {
    "dot": dot_product,
    "ssd": sum_square_diff,
    "sad": sum_abs_diff,
    "medad": median_abs_diff,
    "hamming": hamming_distance,
    "kermi": kernel_mutual_information,
}


def feature_comparison(func: MatchingFunction, source: torch.Tensor,
                       target: torch.Tensor) -> torch.Tensor:
    """`MatchingFunctionTraits<f>::featureComparison` applied along the last
    axis.  Inputs must already be normalized per the function's traits
    (`cross_correlations.h:647-722`)."""
    return _KERNELS[MATCH_TRAITS[func].kernel](source, target)


def compare_feature_volumes(func: MatchingFunction, source_fv: torch.Tensor,
                            target_fv: torch.Tensor) -> torch.Tensor:
    """Per-pixel comparison of two aligned (H, W, F) feature volumes."""
    return feature_comparison(func, source_fv, target_fv)
