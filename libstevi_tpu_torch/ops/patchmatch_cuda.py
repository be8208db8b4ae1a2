"""K6 and K7: the PatchMatch sweep and probe as CUDA kernels
(`csrc/patchmatch.cu`), the port of `libstevi_tpu/ops/patchmatch_pallas.py`.

Both work on a cost-oriented (H, W, D) float32 volume (score volumes
negated by the caller, +inf where a candidate is invalid) and an (H, W)
state of int32 disparities and float32 costs; ``lower`` is the disparity of
index 0 along D.

* `sweep` (K6): one propagation sweep along image axis ``axis`` (0: along
  H, each row tests the row above it, or below on ``reverse``; 1: along W,
  each column tests its left, or right, neighbour).  The first line of the
  sweep takes no candidate.  On the card it is three launches (each line's
  run length, the chains, the costs; see `csrc/patchmatch.cu`).
* `probe` (K7): K candidate fields (K, H, W) tried in order at every pixel.
* `search_probe` (K7): the random search's probe, which forms its K
  candidates from raw draws and the pre-probe disparity
  (`scaled_candidate`) in the kernel.

A candidate is accepted when it lies in [lower, lower + D), its volume value
is finite and that value is <= the current cost (ties accept,
`patchmatch.h:210`).  Each wrapper launches its kernel for CUDA tensors and
runs its plain version (`*_plain`) for CPU tensors; both return new state
tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import count

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


def scaled_candidate(draw, disp, k: int, n_random: int):
    """The k-th random candidate pulled toward ``disp`` by (k+1)/(n+1)
    with floor division, forced off the current value."""
    cand = disp + ((draw - disp) * (k + 1)) // (n_random + 1)
    return torch.where(cand == disp, disp + 1, cand)


def search_probe_plain(cv: torch.Tensor, draws: torch.Tensor,
                       disp: torch.Tensor, cost: torch.Tensor, lower: int,
                       n_random: int):
    """The plain PyTorch version of the search probe, on any device: each
    raw draw scaled toward the pre-probe ``disp``, then `probe_plain`."""
    cand = torch.stack([scaled_candidate(d, disp, k, n_random)
                        for k, d in enumerate(draws)])
    return probe_plain(cv, cand, disp, cost, lower)


MAX_K = 8      # candidate planes a K7 launch (csrc/patchmatch.cu)


def _launch(cv, fn: str, *args) -> None:
    """``fn`` of the library (built and loaded once, `_build.load`) on
    ``cv``'s device and its current stream; raises on a non-zero return.
    The device switch is made only where ``cv`` is not on the current
    device."""
    lib = _build.load("patchmatch")
    dev = cv.device
    if dev.index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            err = getattr(lib, fn)(*args,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, fn)


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
    # .contiguous() returns the tensor itself where it already is
    return cv.contiguous(), disp.contiguous(), cost.contiguous()


def _planes(cand, cv, what):
    if cand.ndim == 2:
        cand = cand[None]
    if cand.dtype != torch.int32 or cand.shape[1:] != cv.shape[:2] \
            or cand.device != cv.device:
        raise ValueError(f"{what}: int32 candidates (K, H, W) on the "
                         "volume's device")
    return cand.contiguous()


def sweep(cv: torch.Tensor, disp: torch.Tensor, cost: torch.Tensor,
          lower: int, axis: int, reverse: bool):
    """One propagation sweep; returns the updated (disp, cost)."""
    if cv.device.type == "cpu":
        return sweep_plain(cv, disp, cost, lower, axis, reverse)
    if axis not in (0, 1):
        raise ValueError("sweep: axis 0 (along H) or 1 (along W)")
    cv, disp, cost = _check(cv, disp, cost, "sweep")
    H, W, D = cv.shape
    d_out, c_out = torch.empty_like(disp), torch.empty_like(cost)
    runs = torch.empty_like(disp)          # each line's run length (A)
    _launch(cv, "pm_sweep_launch", cv.data_ptr(), disp.data_ptr(),
            cost.data_ptr(), d_out.data_ptr(), c_out.data_ptr(),
            runs.data_ptr(), H, W, D, lower, axis, reverse)
    count("launches.sweep")
    return d_out, c_out


def _probe_launches(cv, cand, base, disp, cost, lower, n_random):
    """K7 over the planes of ``cand``, MAX_K a launch, each launch's state
    the last one's output (``base``: the pre-probe disparity of a search
    probe, else None)."""
    H, W, D = cv.shape
    K = cand.shape[0]
    plane = 4 * H * W                       # bytes of one int32 plane
    d_out, c_out = disp, cost
    for k0 in range(0, K, MAX_K):
        d_in, c_in = d_out, c_out
        d_out, c_out = torch.empty_like(disp), torch.empty_like(cost)
        _launch(cv, "pm_probe_launch", cv.data_ptr(),
                cand.data_ptr() + k0 * plane,
                base.data_ptr() if base is not None else None,
                d_in.data_ptr(), c_in.data_ptr(), d_out.data_ptr(),
                c_out.data_ptr(), H, W, D, min(MAX_K, K - k0), lower,
                base is not None, k0, n_random)
    return d_out, c_out, -(-K // MAX_K)


def probe(cv: torch.Tensor, cand: torch.Tensor, disp: torch.Tensor,
          cost: torch.Tensor, lower: int):
    """Accept-if-better update of (disp, cost) with candidate field(s)
    ``cand``: (H, W) for one field or (K, H, W) for K fields tried in
    order.  Returns the updated (disp, cost)."""
    if cv.device.type == "cpu":
        return probe_plain(cv, cand, disp, cost, lower)
    cv, disp, cost = _check(cv, disp, cost, "probe")
    cand = _planes(cand, cv, "probe")
    if cand.shape[0] == 0:
        return disp.clone(), cost.clone()
    d_out, c_out, n = _probe_launches(cv, cand, None, disp, cost, lower, 0)
    count("launches.probe", n)
    return d_out, c_out


def search_probe(cv: torch.Tensor, draws: torch.Tensor, disp: torch.Tensor,
                 cost: torch.Tensor, lower: int, n_random: int):
    """The random search's probe: candidate k is `scaled_candidate` of raw
    draw k (``draws`` (K, H, W) int32) toward the pre-probe ``disp``, and
    the K candidates are tried in order, as `probe` tries them.  The
    kernel forms the candidates in registers.  Returns the updated
    (disp, cost)."""
    if cv.device.type == "cpu":
        return search_probe_plain(cv, draws, disp, cost, lower, n_random)
    cv, disp, cost = _check(cv, disp, cost, "search_probe")
    draws = _planes(draws, cv, "search_probe")
    if n_random < 1 or draws.shape[0] == 0:
        raise ValueError("search_probe: n_random >= 1 and one or more draws")
    d_out, c_out, n = _probe_launches(cv, draws, disp, disp, cost, lower,
                                      n_random)
    count("launches.probe", n)      # K7's kernel, one count
    return d_out, c_out
