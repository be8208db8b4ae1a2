"""K5: the feature-volume cost volume as a CUDA kernel (`csrc/fv_cv.cu`),
the port of `libstevi_tpu/ops/fv_backend.py`.

cost[i, j, d] = compare(source[i, j, :], target[i, j + shifts[d], :]) with
zero target features out of range (`cross_correlations.h:204-236`), for the
elementwise comparison families in `FUSABLE_KERNELS`; MEDAD, Hamming
(CENSUS) and KERMI stay on the shifted-compare loop.

`shifted_compare` is that loop in plain PyTorch: one aligned slice of a
zero-padded target per shift (the JAX package's `_shifted_compare_scan`).
`fused_fv_cost_volume` launches the kernel for CUDA tensors and runs
`fused_fv_cost_volume_plain` (the loop) for CPU tensors.  The kernel has
two instances: where the shifts are a run of step +1 or -1 (`unit_step`),
register tiles of 4 columns x 8 disparities a thread; any other list, one
thread an entry (`fv_instance`).
"""

from __future__ import annotations

import torch

from .. import _build
from ..utils.profiling import count
from .matching import _KERNELS

FUSABLE_KERNELS = ("dot", "ssd", "sad")
_KIND = {"dot": 0, "ssd": 1, "sad": 2}
WT = 32                  # image columns per block, as in csrc/fv_cv.cu
MAX_SMEM = 232448        # dynamic shared memory one block may opt in to


def shifted_compare(compare, source_fv: torch.Tensor,
                    target_fv: torch.Tensor, shifts,
                    cv_dtype=torch.float32) -> torch.Tensor:
    """(H, W, D) volume of ``compare(source, target shifted by shifts[d])``
    over the last axis, zero target features out of range."""
    W = source_fv.shape[1]
    shifts = [int(s) for s in shifts]
    pad_l = max(0, -min(shifts))
    pad_r = max(0, max(shifts))
    padded = torch.nn.functional.pad(target_fv, (0, 0, pad_l, pad_r))
    return torch.stack(
        [compare(source_fv, padded[:, pad_l + s:pad_l + s + W]).to(cv_dtype)
         for s in shifts], dim=-1)


def _layout(cv: torch.Tensor, layout: str) -> torch.Tensor:
    if layout not in ("hwd", "dhw"):
        raise ValueError(f"layout {layout!r}: 'hwd' or 'dhw'")
    return cv if layout == "hwd" else cv.movedim(-1, 1)


def fused_fv_cost_volume_plain(kernel: str, source_fv: torch.Tensor,
                               target_fv: torch.Tensor, shifts,
                               cv_dtype=torch.float32,
                               layout: str = "hwd") -> torch.Tensor:
    """The plain PyTorch version of K5, on any device."""
    cv = shifted_compare(_KERNELS[kernel], source_fv.float(),
                         target_fv.float(), shifts, cv_dtype)
    return _layout(cv, layout)


def smem_bytes(F: int, D: int, span: int) -> int:
    """Shared memory of one K5 block (`smem_bytes` in csrc/fv_cv.cu)."""
    return 4 * (F * ((WT | 1) + ((WT + span) | 1)) + D)


def unit_step(shifts) -> int:
    """+1 or -1 where ``shifts`` is a run of that step (shifts[d] =
    shifts[0] + step * d; one shift counts as +1), else 0."""
    shifts = [int(s) for s in shifts]
    steps = {b - a for a, b in zip(shifts, shifts[1:])}
    if not steps:
        return 1 if shifts else 0
    return steps.pop() if len(steps) == 1 and steps <= {1, -1} else 0


def fv_instance(shifts) -> str:
    """The K5 instance a shift list takes: 'tiled' (register tiles along a
    unit-step list, `unit_step`) or 'general' (one thread an entry)."""
    return "tiled" if unit_step(shifts) else "general"


def fused_fits(F: int, shifts) -> bool:
    """Whether K5 takes F features over ``shifts``: its block's tile fits
    one block's shared memory (`smem_bytes` <= `MAX_SMEM`)."""
    shifts = [int(s) for s in shifts]
    return smem_bytes(F, len(shifts), max(shifts) - min(shifts)) <= MAX_SMEM


def fused_fv_cost_volume(kernel: str, source_fv: torch.Tensor,
                         target_fv: torch.Tensor, shifts,
                         cv_dtype=torch.float32,
                         layout: str = "hwd") -> torch.Tensor:
    """cost[i, j, d] = compare(source[i, j, :], target[i, j + shifts[d], :])
    with zero target features out of range.  ``kernel`` is 'dot', 'ssd' or
    'sad'; ``shifts`` a static int sequence.  Returns (H, W, D) for
    layout='hwd' or an (H, D, W) view for 'dhw'."""
    if source_fv.device.type == "cpu":
        return fused_fv_cost_volume_plain(kernel, source_fv, target_fv,
                                          shifts, cv_dtype, layout)
    if not (source_fv.is_cuda and target_fv.device == source_fv.device):
        raise ValueError("fused_fv_cost_volume: both volumes on one CUDA "
                         "device")
    if kernel not in _KIND:
        raise NotImplementedError(
            f"fused_fv_cost_volume: '{kernel}' is not an elementwise family "
            f"{FUSABLE_KERNELS}; it runs on the shifted-compare loop")
    if source_fv.ndim != 3 or target_fv.shape != source_fv.shape:
        raise ValueError("fused_fv_cost_volume: two (H, W, F) volumes of "
                         "one shape")
    if cv_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("fused_fv_cost_volume stores float32 or bfloat16")
    shifts = [int(s) for s in shifts]
    H, W, F = source_fv.shape
    D = len(shifts)
    if D < 1:
        raise ValueError("fused_fv_cost_volume: no shifts")
    lo = min(shifts)
    span = max(shifts) - lo
    if not fused_fits(F, shifts):
        raise NotImplementedError(
            f"fused_fv_cost_volume: F={F} with a shift span of {span} needs "
            f"{smem_bytes(F, D, span)} bytes of shared memory per block, over "
            f"{MAX_SMEM}; a d-tiled kernel is queued in ROADMAP.md B")
    if H > 65535:
        raise NotImplementedError("fused_fv_cost_volume: H > 65535 rows")
    src = source_fv.float().contiguous()
    tgt = target_fv.float().contiguous()
    sh = torch.tensor(shifts, dtype=torch.int32).to(src.device)
    out = torch.empty((H, W, D), dtype=cv_dtype, device=src.device)
    lib = _build.load("fv_cv")
    with torch.cuda.device(src.device):
        err = lib.fv_cv_launch(
            src.data_ptr(), tgt.data_ptr(), sh.data_ptr(), out.data_ptr(),
            H, W, F, D, lo, span, _KIND[kernel],
            int(cv_dtype == torch.bfloat16), unit_step(shifts),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "fv_cv_launch")
    count("launches.fused_fv_cost_volume")
    return _layout(out, layout)


