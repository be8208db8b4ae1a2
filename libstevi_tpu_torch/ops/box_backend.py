"""Box-filter cost volume for the window-decomposable matching functions
(counterpart of `libstevi_tpu/ops/box_backend.py`).  For the dot family
this is the plain PyTorch version of the K1 kernel (`box_cuda.py`,
`csrc/box_cv.cu`); the SSD / ZSSD / SAD family is plain torch on every
device, as it is XLA (no Pallas kernel) in the JAX package.

Identities used (n is the full feature count (2h+1)(2v+1)C, all window sums
follow the unfold's zero fill for out-of-image samples):

    cross_d  = box(sum_c S * T_d)            (T_d = target shifted by d)
    CC   = cross_d
    NCC  = cross_d / (|S| * |T_d|),          |S| = sqrt(box(sum_c S^2))
    ZCC  = cross_d - box(S) * box(T_d) / n
    ZNCC = ZCC / (sigma_S * sigma_T_d),      sigma = sqrt(box(x^2) - box(x)^2/n)
    SSD  = vbox(sum_c (S - T_d)^2)
    ZSSD = SSD - (box(S) - box(T_d))^2 / n
    SAD  = vbox(sum_c |S - T_d|)

For SSD/SAD f(0, t) is not zero, so vbox() evaluates the product map on a
radius-extended grid (both images zero-padded by the window radii) and takes
the VALID window sum, reproducing the reference's border behavior.

Out-of-range target pixels (j + sign*d outside the image) get the
reference's all-zero target feature vector value (`cross_correlations.h:235`):
0 for the dot family, sum(s_hat^2) for SSD-type, sum(|s_hat|) for SAD.
"""

from __future__ import annotations

import torch

from ..core.types import MatchingFunction, DispDirection
from ..core.search import SearchOffset1, SearchOffset2
from .filters import box_filter_2d

DOT_FAMILY = (MatchingFunction.CC, MatchingFunction.NCC,
              MatchingFunction.ZCC, MatchingFunction.ZNCC)
_BOX_FUNCS = DOT_FAMILY + (MatchingFunction.SSD, MatchingFunction.ZSSD,
                           MatchingFunction.SAD)


def supports_box(func: MatchingFunction) -> bool:
    return func in _BOX_FUNCS


def _sum_c(x: torch.Tensor) -> torch.Tensor:
    return x if x.ndim == 2 else x.sum(-1)


def disparities(search) -> list[int]:
    """The disparities of a 1-D search: [0, width) or [lower, upper]."""
    if isinstance(search, SearchOffset1):
        return list(range(search.lower, search.upper + 1))
    return list(range(int(search)))


def box_cost_volume(func: MatchingFunction, img_l: torch.Tensor,
                    img_r: torch.Tensor, h_radius: int, v_radius: int,
                    search, direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                    cv_dtype=torch.float32) -> torch.Tensor:
    """(H, W, D) cost volume of a window-decomposable function, all
    disparities at once: the shifted targets are gathered into one
    (H, W, D[, C]) tensor and window-summed on the image axes."""
    if isinstance(search, SearchOffset2):
        raise NotImplementedError("box backend covers 1-D disparity search")
    if not supports_box(func):
        raise ValueError(f"{func} is not window-decomposable")
    if direction is DispDirection.RIGHT_TO_LEFT:
        src, tgt = img_r, img_l
    else:
        src, tgt = img_l, img_r
    sign = direction.delta_sign
    shifts = [sign * d for d in disparities(search)]

    src = src.float()
    tgt = tgt.float()
    if src.ndim == 2:
        src = src[..., None]
        tgt = tgt[..., None]
    H, W, C = src.shape
    n = (2 * h_radius + 1) * (2 * v_radius + 1) * C
    dev = src.device

    def box(x):
        return box_filter_2d(x, h_radius, v_radius)

    pad_l = max(0, -min(shifts))
    pad_r = max(0, max(shifts))
    shift_t = torch.tensor(shifts, device=dev)[None, :]
    cols = torch.arange(W, device=dev)[:, None] + pad_l + shift_t    # (W, D)
    in_range = (cols >= pad_l) & (cols < pad_l + W)

    def shifted(x):
        """x[:, j + shift_d] with zero fill: (H, W) -> (H, W, D)."""
        xp = torch.nn.functional.pad(x, (pad_l, pad_r))
        return xp[:, cols]

    sum_s = box(_sum_c(src))[..., None]
    sum_s2 = box(_sum_c(src * src))[..., None]
    if func in DOT_FAMILY:
        tgt_p = torch.nn.functional.pad(tgt, (0, 0, pad_l, pad_r))
        t_d = tgt_p[:, cols]                                      # (H, W, D, C)
        cross = box((src[:, :, None, :] * t_d).sum(-1))           # (H, W, D)
        boundary = 0.0
    else:
        # radius-extended grids: extended column x reads target column
        # x - h + shift_d; VALID window sums of the per-sample map
        hr, vr = h_radius, v_radius
        Wx = W + 2 * hr
        src_x = torch.nn.functional.pad(src, (0, 0, hr, hr, vr, vr))
        tgt_x = torch.nn.functional.pad(tgt, (0, 0, pad_l + hr, pad_r + hr,
                                              vr, vr))
        cols_x = torch.arange(Wx, device=dev)[:, None] + pad_l + shift_t
        diff = src_x[:, :, None, :] - tgt_x[:, cols_x]     # (H+2v, Wx, D, C)

        def vbox(x):
            return box(x)[vr:vr + H, hr:hr + W]

    if func is MatchingFunction.CC:
        cost = cross
    elif func is MatchingFunction.NCC:
        norm_t = torch.sqrt(shifted(box(_sum_c(tgt * tgt))))
        den = torch.sqrt(sum_s2) * norm_t
        cost = torch.where(den > 0, cross / torch.where(den > 0, den, 1.0),
                           0.0)
    elif func in (MatchingFunction.ZCC, MatchingFunction.ZNCC):
        sum_t = shifted(box(_sum_c(tgt)))
        zcc = cross - sum_s * sum_t / n
        if func is MatchingFunction.ZCC:
            cost = zcc
        else:
            sum_t2 = shifted(box(_sum_c(tgt * tgt)))
            # clamp at 0: box(x^2) - box(x)^2/n cancels to ~-1e-6 in f32 on
            # flat patches; zero-variance windows score 0 (uncorrelated)
            sigma_s = torch.sqrt(torch.clamp(sum_s2 - sum_s * sum_s / n,
                                             min=0.0))
            sigma_t = torch.sqrt(torch.clamp(sum_t2 - sum_t * sum_t / n,
                                             min=0.0))
            den = sigma_s * sigma_t
            cost = torch.where(den > 0, zcc / torch.where(den > 0, den, 1.0),
                               0.0)
    elif func is MatchingFunction.SAD:
        cost = vbox(_sum_c(diff.abs()))
        boundary = box(_sum_c(src.abs()))[..., None]
    else:
        cost = vbox(_sum_c(diff * diff))
        boundary = sum_s2                     # SSD against the zero vector
        if func is MatchingFunction.ZSSD:
            dm = sum_s - shifted(box(_sum_c(tgt)))
            cost = cost - dm * dm / n
            boundary = sum_s2 - sum_s * sum_s / n
    return torch.where(in_range, cost, boundary).to(cv_dtype)
