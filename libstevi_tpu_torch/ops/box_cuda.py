"""K1: the dot-family box cost volume as two CUDA kernels
(`csrc/box_cv.cu`), the port of `libstevi_tpu/ops/box_pallas.py`.

`window_stats` launches the statistics kernel once for both images: window
sums and INVERSE norms (NCC) or inverse sigmas (the others; the variance
clamped at 0 before the square root), 0 where the denominator is 0, so the
volume's per-disparity normalization is two multiplies and zero-variance
windows score 0.  Its plain version is `_prep_inputs`, the glue the XLA
path ran around the TPU kernel (`box_pallas._prep_inputs`).  `box_cv` then
launches the volume kernel once, for any D: the (H, W, D) volume, negated
for SCORE functions and 0 where j + d >= W.  Its plain version is
`box_cv_plain`.

Both kernels equal their plain versions bit for bit on the card (up to the
sign of a zero): the plain versions below are written in the kernels'
order of operations, and the kernels use no FMA.  ZNCC is ill-conditioned
on flat windows (the variance cancels to a few ulps), so any other order
of the sums moves such entries by O(1); a tolerance cannot hold them.

Each wrapper launches its kernel for CUDA tensors, counting launches in
``.launches``, and runs its plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..core.types import MatchingFunction
from .filters import box_filter_2d

_KIND = {MatchingFunction.CC: 0, MatchingFunction.NCC: 1,
         MatchingFunction.ZCC: 2, MatchingFunction.ZNCC: 3}


def _prep_inputs(func, img_l, img_r, h_radius, v_radius):
    """(src, tgt, sum_s, inv_s, sum_t, inv_t, n): RIGHT_TO_LEFT, so the
    source is the right image; inv_* are inverse norms (NCC) or inverse
    sigmas (the others), 0 where the denominator is 0.  The plain version
    of the statistics kernel."""
    src = img_r.float().contiguous()
    tgt = img_l.float().contiguous()
    n = float((2 * h_radius + 1) * (2 * v_radius + 1))
    # IEEE division and square root on either device, as the kernel's:
    # CUDA turns a division by a Python number into a multiply by its
    # reciprocal, so the divisor is a tensor; the CPU's vectorized float32
    # sqrt is off by an ulp at times, the float64 one rounded back is exact
    n_t = torch.tensor(n, device=src.device)

    def sqrt(x):
        return torch.sqrt(x.double()).float()

    def stats(x):
        s = box_filter_2d(x, h_radius, v_radius)
        s2 = box_filter_2d(x * x, h_radius, v_radius)
        den = (sqrt(s2) if func is MatchingFunction.NCC
               else sqrt(torch.clamp(s2 - s * s / n_t, min=0.0)))
        inv = torch.where(den > 0, 1.0 / torch.where(den > 0, den, 1.0), 0.0)
        return s.contiguous(), inv.contiguous()

    sum_s, inv_s = stats(src)
    sum_t, inv_t = stats(tgt)
    return src, tgt, sum_s, inv_s, sum_t, inv_t, n


def _check(func, img_l, img_r, h_radius, v_radius):
    if not (img_l.is_cuda and img_r.device == img_l.device):
        raise ValueError("box_cv: both images on one CUDA device")
    if func not in _KIND:
        raise NotImplementedError(f"box_cv: {func} is not a dot-family cost")
    if img_l.ndim != 2 or img_r.shape != img_l.shape:
        raise ValueError("box_cv: two gray (H, W) images of one shape")
    if h_radius < 0 or v_radius < 0:
        raise ValueError("box_cv: negative window radius")


def _stats_launch(lib, func, img_l, img_r, h_radius, v_radius, stream):
    """The statistics kernel on CUDA images: `_prep_inputs`'s tuple."""
    src = img_r.float().contiguous()
    tgt = img_l.float().contiguous()
    H, W = src.shape
    n = float((2 * h_radius + 1) * (2 * v_radius + 1))
    stats = torch.empty((2, 2, H, W), device=src.device)  # [s, t] x [sum, inv]
    err = lib.box_stats_launch(
        src.data_ptr(), tgt.data_ptr(), stats.data_ptr(), H, W, h_radius,
        v_radius, int(func is MatchingFunction.NCC), n, stream)
    _build.check(lib, err, "box_stats_launch")
    window_stats.launches += 1
    return src, tgt, stats[0, 0], stats[0, 1], stats[1, 0], stats[1, 1], n


def window_stats(func: MatchingFunction, img_l: torch.Tensor,
                 img_r: torch.Tensor, h_radius: int, v_radius: int):
    """`_prep_inputs`'s tuple; on CUDA from one launch of the statistics
    kernel for both images."""
    if img_l.device.type == "cpu":
        return _prep_inputs(func, img_l, img_r, h_radius, v_radius)
    _check(func, img_l, img_r, h_radius, v_radius)
    lib = _build.load("box_cv")
    with torch.cuda.device(img_l.device):
        return _stats_launch(lib, func, img_l, img_r, h_radius, v_radius,
                             torch.cuda.current_stream().cuda_stream)


window_stats.launches = 0


def box_cv_plain(func: MatchingFunction, img_l: torch.Tensor,
                 img_r: torch.Tensor, h_radius: int, v_radius: int,
                 disp_width: int, cv_dtype=torch.float32,
                 negate: bool = False) -> torch.Tensor:
    """The plain PyTorch version of K1, on any device, step for step the
    kernels' arithmetic: the statistics of `_prep_inputs`, cross_d =
    box(src * tgt_d), zcc = cross - (sum_s * sum_t_d) * (1/n), cost =
    (zcc * inv_s) * inv_t_d, negated, 0 where j + d >= W, then rounded
    once to ``cv_dtype``."""
    kind = _KIND[func]
    src, tgt, sum_s, inv_s, sum_t, inv_t, n = _prep_inputs(
        func, img_l, img_r, h_radius, v_radius)
    W = src.shape[1]
    cols = (torch.arange(W, device=src.device)[:, None]
            + torch.arange(int(disp_width), device=src.device))  # (W, D)
    in_range = cols < W
    cols = cols.clamp(max=W - 1)

    def shifted(x):
        """x[:, j + d], 0 where j + d >= W: (H, W) -> (H, W, D)."""
        return torch.where(in_range, x[:, cols], 0.0)

    cost = box_filter_2d(src[..., None] * shifted(tgt), h_radius, v_radius)
    if kind & 2:
        cost = cost - sum_s[..., None] * shifted(sum_t) * (1.0 / n)
    if kind & 1:
        cost = cost * inv_s[..., None] * shifted(inv_t)
    if negate:
        cost = -cost
    return torch.where(in_range, cost, 0.0).to(cv_dtype)


def box_cv(func: MatchingFunction, img_l: torch.Tensor, img_r: torch.Tensor,
           h_radius: int, v_radius: int, disp_width: int,
           cv_dtype=torch.float32, negate: bool = False) -> torch.Tensor:
    """(H, W, D) dot-family cost volume, RIGHT_TO_LEFT over d in [0, D),
    gray images, stored as ``cv_dtype`` (float32 or bfloat16) and negated
    when ``negate`` (SCORE volumes feed the COST-mode SGM negated).  On
    CUDA, one launch of the statistics kernel (`window_stats`) and one of
    the volume kernel, for any D."""
    if img_l.device.type == "cpu":
        return box_cv_plain(func, img_l, img_r, h_radius, v_radius,
                            disp_width, cv_dtype, negate)
    _check(func, img_l, img_r, h_radius, v_radius)
    if cv_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("box_cv stores float32 or bfloat16 volumes")
    D = int(disp_width)
    if D < 1:
        raise ValueError("box_cv: D >= 1")
    H, W = img_l.shape
    out = torch.empty((H, W, D), dtype=cv_dtype, device=img_l.device)
    lib = _build.load("box_cv")
    with torch.cuda.device(img_l.device):
        stream = torch.cuda.current_stream().cuda_stream
        src, tgt, sum_s, inv_s, sum_t, inv_t, n = _stats_launch(
            lib, func, img_l, img_r, h_radius, v_radius, stream)
        err = lib.box_cv_launch(
            src.data_ptr(), tgt.data_ptr(), sum_s.data_ptr(), inv_s.data_ptr(),
            sum_t.data_ptr(), inv_t.data_ptr(), out.data_ptr(), H, W, D,
            h_radius, v_radius, _KIND[func], 1.0 / n, int(negate),
            int(cv_dtype == torch.bfloat16), stream)
    _build.check(lib, err, "box_cv_launch")
    box_cv.launches += 1
    return out


box_cv.launches = 0
