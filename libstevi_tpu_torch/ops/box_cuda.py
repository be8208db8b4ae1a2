"""K1: the dot-family box cost volume as a CUDA kernel (`csrc/box_cv.cu`),
the port of `libstevi_tpu/ops/box_pallas.py`.

The glue runs in PyTorch, as the XLA glue did around the TPU kernel
(`box_pallas._prep_inputs`): window sums of both images and INVERSE sigmas
(0 where sigma is 0, the variance clamped at 0 before the square root), so
the kernel's per-disparity normalization is two multiplies and zero-variance
windows score 0.  The kernel writes the (H, W, D) volume, negated for SCORE
functions and 0 where j + d >= W.

A launch writes one slice of at most ``MAX_D`` disparities (lanes keep
ceil(D_slice / 32) <= 10 sums each); a wider range is one launch a slice,
at offsets d0 = 0, 320, ..., all from one set of window statistics.

`box_cv` launches the kernel for CUDA tensors and runs `box_cv_plain`, the
plain version (`box_backend.box_cost_volume`), for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.types import MatchingFunction
from .box_backend import box_cost_volume
from .filters import box_filter_2d

_KIND = {MatchingFunction.CC: 0, MatchingFunction.NCC: 1,
         MatchingFunction.ZCC: 2, MatchingFunction.ZNCC: 3}
MAX_D = 320        # K1 and K3 keep ceil(D / 32) <= 10 values per lane


def _prep_inputs(func, img_l, img_r, h_radius, v_radius):
    """(src, tgt, sum_s, inv_s, sum_t, inv_t, n): RIGHT_TO_LEFT, so the
    source is the right image; inv_* are inverse norms (NCC) or inverse
    sigmas (ZNCC), 0 where the denominator is 0."""
    src = img_r.float().contiguous()
    tgt = img_l.float().contiguous()
    n = float((2 * h_radius + 1) * (2 * v_radius + 1))

    def stats(x):
        s = box_filter_2d(x, h_radius, v_radius)
        s2 = box_filter_2d(x * x, h_radius, v_radius)
        den = (torch.sqrt(s2) if func is MatchingFunction.NCC
               else torch.sqrt(torch.clamp(s2 - s * s / n, min=0.0)))
        inv = torch.where(den > 0, 1.0 / torch.where(den > 0, den, 1.0), 0.0)
        return s.contiguous(), inv.contiguous()

    sum_s, inv_s = stats(src)
    sum_t, inv_t = stats(tgt)
    return src, tgt, sum_s, inv_s, sum_t, inv_t, n


def box_cv_plain(func: MatchingFunction, img_l: torch.Tensor,
                 img_r: torch.Tensor, h_radius: int, v_radius: int,
                 disp_width: int, cv_dtype=torch.float32,
                 negate: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K1, on any device."""
    cv = box_cost_volume(func, img_l, img_r, h_radius, v_radius, disp_width)
    return (-cv if negate else cv).to(cv_dtype)


def box_cv(func: MatchingFunction, img_l: torch.Tensor, img_r: torch.Tensor,
           h_radius: int, v_radius: int, disp_width: int,
           cv_dtype=torch.float32, negate: bool = False) -> torch.Tensor:
    """(H, W, D) dot-family cost volume, RIGHT_TO_LEFT over d in [0, D),
    gray images, stored as ``cv_dtype`` (float32 or bfloat16) and negated
    when ``negate`` (SCORE volumes feed the COST-mode SGM negated).  On
    CUDA, one launch per slice of at most ``MAX_D`` disparities."""
    if img_l.device.type == "cpu":
        return box_cv_plain(func, img_l, img_r, h_radius, v_radius,
                            disp_width, cv_dtype, negate)
    if not (img_l.is_cuda and img_r.device == img_l.device):
        raise ValueError("box_cv: both images on one CUDA device")
    if func not in _KIND:
        raise NotImplementedError(f"box_cv: {func} is not a dot-family cost")
    if img_l.ndim != 2 or img_r.shape != img_l.shape:
        raise ValueError("box_cv: two gray (H, W) images of one shape")
    if cv_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("box_cv stores float32 or bfloat16 volumes")
    D = int(disp_width)
    if D < 1:
        raise ValueError("box_cv: D >= 1")
    if h_radius < 0 or v_radius < 0:
        raise ValueError("box_cv: negative window radius")
    H, W = img_l.shape
    src, tgt, sum_s, inv_s, sum_t, inv_t, n = _prep_inputs(
        func, img_l, img_r, h_radius, v_radius)
    out = torch.empty((H, W, D), dtype=cv_dtype, device=img_l.device)
    lib = _build.load("box_cv")
    with torch.cuda.device(img_l.device):
        for d0 in range(0, D, MAX_D):
            err = lib.box_cv_launch(
                src.data_ptr(), tgt.data_ptr(), sum_s.data_ptr(),
                inv_s.data_ptr(), sum_t.data_ptr(), inv_t.data_ptr(),
                out.data_ptr(), H, W, D, d0, min(MAX_D, D - d0), h_radius,
                v_radius, _KIND[func], 1.0 / n, int(negate),
                int(cv_dtype == torch.bfloat16),
                torch.cuda.current_stream().cuda_stream)
            _build.check(lib, err, "box_cv_launch")
            box_cv.launches += 1
    return out


box_cv.launches = 0
