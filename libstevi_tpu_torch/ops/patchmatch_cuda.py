"""K6 and K7: the PatchMatch sweep and probe as CUDA kernels
(`csrc/patchmatch.cu`), the port of `libstevi_tpu/ops/patchmatch_pallas.py`.

Both work on a cost-oriented (H, W, D) float32 volume (score volumes
negated by the caller, +inf where a candidate is invalid) and an (H, W)
state of int32 disparities and float32 costs; ``lower`` is the disparity of
index 0 along D.

* `sweep` (K6): one propagation sweep along image axis ``axis`` (0: along
  H, each row tests the row above it, or below on ``reverse``; 1: along W,
  each column tests its left, or right, neighbour).  The first line of the
  sweep takes no candidate.
* `probe` (K7): K candidate fields (K, H, W) tried in order at every pixel.

A candidate is accepted when it lies in [lower, lower + D), its volume value
is finite and that value is <= the current cost (ties accept,
`patchmatch.h:210`).  Each wrapper launches its kernel for CUDA tensors and
runs its plain version (`*_plain`) for CPU tensors; both return new state
tensors.
"""

from __future__ import annotations

import torch

from .. import _build

_INF = float("inf")


def _select(cv: torch.Tensor, v: torch.Tensor, lower: int) -> torch.Tensor:
    """cv[..., v - lower] along the last axis, +inf where v is out of
    [lower, lower + D)."""
    D = cv.shape[-1]
    k = v.long() - lower
    inr = (k >= 0) & (k < D)
    sel = torch.gather(cv, -1, k.clamp(0, D - 1)[..., None])[..., 0]
    return torch.where(inr, sel, _INF)


def sweep_plain(cv: torch.Tensor, disp: torch.Tensor, cost: torch.Tensor,
                lower: int, axis: int, reverse: bool):
    """The plain PyTorch version of K6, on any device: a loop over lines."""
    if axis == 1:
        cv, disp, cost = cv.transpose(0, 1), disp.t(), cost.t()
    d = disp.clone()
    c = cost.clone()
    L = d.shape[0]
    step = 1 if reverse else -1
    for l in (range(L - 2, -1, -1) if reverse else range(1, L)):
        cand = d[l + step]
        sel = _select(cv[l], cand, lower)
        acc = torch.isfinite(sel) & (sel <= c[l])
        d[l] = torch.where(acc, cand, d[l])
        c[l] = torch.where(acc, sel, c[l])
    if axis == 1:
        d, c = d.t().contiguous(), c.t().contiguous()
    return d, c


def probe_plain(cv: torch.Tensor, cand: torch.Tensor, disp: torch.Tensor,
                cost: torch.Tensor, lower: int):
    """The plain PyTorch version of K7, on any device."""
    if cand.ndim == 2:
        cand = cand[None]
    d, c = disp, cost
    for v in cand:
        sel = _select(cv, v, lower)
        acc = torch.isfinite(sel) & (sel <= c)
        d = torch.where(acc, v, d)
        c = torch.where(acc, sel, c)
    return d.clone(), c.clone()


def _check(cv, disp, cost, what):
    if not (cv.is_cuda and disp.device == cv.device
            and cost.device == cv.device):
        raise ValueError(f"{what}: volume and state on one CUDA device")
    if cv.dtype != torch.float32 or cv.ndim != 3:
        raise TypeError(f"{what}: a float32 (H, W, D) cost-oriented volume")
    if disp.dtype != torch.int32 or cost.dtype != torch.float32 \
            or disp.shape != cv.shape[:2] or cost.shape != cv.shape[:2]:
        raise ValueError(f"{what}: int32 disp and float32 cost of shape "
                         f"{tuple(cv.shape[:2])}")
    return (cv.contiguous(), disp.contiguous(), cost.contiguous(),
            torch.empty_like(disp), torch.empty_like(cost))


def sweep(cv: torch.Tensor, disp: torch.Tensor, cost: torch.Tensor,
          lower: int, axis: int, reverse: bool):
    """One propagation sweep; returns the updated (disp, cost)."""
    if cv.device.type == "cpu":
        return sweep_plain(cv, disp, cost, lower, axis, reverse)
    if axis not in (0, 1):
        raise ValueError("sweep: axis 0 (along H) or 1 (along W)")
    cv, disp, cost, d_out, c_out = _check(cv, disp, cost, "sweep")
    H, W, D = cv.shape
    lib = _build.load("patchmatch")
    with torch.cuda.device(cv.device):
        err = lib.pm_sweep_launch(
            cv.data_ptr(), disp.data_ptr(), cost.data_ptr(), d_out.data_ptr(),
            c_out.data_ptr(), H, W, D, int(lower), int(axis), int(reverse),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "pm_sweep_launch")
    sweep.launches += 1
    return d_out, c_out


sweep.launches = 0


def probe(cv: torch.Tensor, cand: torch.Tensor, disp: torch.Tensor,
          cost: torch.Tensor, lower: int):
    """Accept-if-better update of (disp, cost) with candidate field(s)
    ``cand``: (H, W) for one field or (K, H, W) for K fields tried in
    order.  Returns the updated (disp, cost)."""
    if cv.device.type == "cpu":
        return probe_plain(cv, cand, disp, cost, lower)
    cv, disp, cost, d_out, c_out = _check(cv, disp, cost, "probe")
    if cand.ndim == 2:
        cand = cand[None]
    if cand.dtype != torch.int32 or cand.shape[1:] != cv.shape[:2] \
            or cand.device != cv.device:
        raise ValueError("probe: int32 candidates (K, H, W) on the volume's "
                         "device")
    cand = cand.contiguous()
    H, W, D = cv.shape
    lib = _build.load("patchmatch")
    with torch.cuda.device(cv.device):
        err = lib.pm_probe_launch(
            cv.data_ptr(), cand.data_ptr(), disp.data_ptr(), cost.data_ptr(),
            d_out.data_ptr(), c_out.data_ptr(), H, W, D, cand.shape[0],
            int(lower), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "pm_probe_launch")
    probe.launches += 1
    return d_out, c_out


probe.launches = 0
