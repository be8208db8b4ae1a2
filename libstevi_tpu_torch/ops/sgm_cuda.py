"""K2, K2k and K3: the SGM scans as CUDA kernels (`csrc/sgm_scan.cu`), the
port of `libstevi_tpu/ops/sgm_pallas_dhw.py`.

K2 (`sgm_pass`) runs one principal direction and adds its adjustment into
an f32 accumulator of the volume's shape; K2k (`sgm_knight_pass`) does the
same for one knight-move direction of the 16-direction set, in two
launches (the two seed phases, see `csrc/sgm_scan.cu`); K3 (`sgm_wta`)
runs the last direction, right to left, fused with C = cost + acc + adj,
the tie-last WTA, the band C[idx - r .. idx + r] (+inf beyond [0, D)) and,
optionally, the parabola subpixel with the SAME-mode NaN rules.  The
flagship's 8 directions are 7 K2 launches and one K3 launch; 16 directions
add the 8 knight directions between them (`sgm_wta_fused`).

K2 and K2k take the image column of the volume's first column (``col0``)
and the image width (``W_pout``) for the Pout test ``j + d >= W``, so a
margin region runs as its own contiguous volume (`sgm.sgm_cost_volume`).
K3 takes whole images only: with margins, `sgm.sgm_wta_truncated` runs the
chain of `sgm_cost_volume`, WTA and band, as the JAX package does.

The TPU path baked Pout into the cost stream and restored the multiplicity
in its WTA pass (`box_pallas.py:226-238`, `_bake_mult_plane`); the CUDA DP
adds Pout in its step, as `_line_recurrence` does, which gives the same
idx, bands and disparity.  The DP runs in f32 registers for f32 and bf16
volumes alike, as the JAX XLA path does (it casts the volume to f32).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`*_plain`, built on `sgm.direction_adj` and `sgm.knight_adj`) for
CPU tensors.
"""

from __future__ import annotations

import torch

from .. import _build
from .box_cuda import MAX_D
from .sgm import (SgmDirection, directions_for, direction_adj, knight_adj,
                  wta_bands, _tcv_from_bands)


def kernel_volume(cv: torch.Tensor) -> torch.Tensor:
    """``cv`` as a contiguous float32 or bfloat16 volume, the types the
    kernels read."""
    if cv.dtype not in (torch.float32, torch.bfloat16):
        cv = cv.float()
    return cv.contiguous()


def _check_cuda(cv: torch.Tensor, acc: torch.Tensor, what: str) -> None:
    if not cv.is_cuda or acc.device != cv.device:
        raise ValueError(f"{what}: cv and acc on one CUDA device")
    if cv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what}: cv must be float32 or bfloat16")
    if acc.dtype != torch.float32 or acc.shape != cv.shape or cv.ndim != 3:
        raise ValueError(f"{what}: acc must be float32 of cv's (H, W, D) shape")
    if not (cv.is_contiguous() and acc.is_contiguous()):
        raise ValueError(f"{what}: cv and acc must be contiguous")
    if not 1 <= cv.shape[-1] <= MAX_D:
        # ceil(D / 32) <= 10 values a lane in registers; `sgm.sgm_route`
        # sends wider ranges to K4b / K4d
        raise NotImplementedError(f"{what}: 1 <= D <= {MAX_D}")


def _pout_args(cv, col0, W_pout):
    W = cv.shape[1]
    W_pout = col0 + W if W_pout is None else W_pout
    if col0 < 0 or W_pout < col0 + W:
        raise ValueError("col0 >= 0 and W_pout >= col0 + W")
    return col0, W_pout


# ---------------------------------------------------------------------------
# K2: one principal direction
# ---------------------------------------------------------------------------

def sgm_pass_plain(cv, acc, direction: SgmDirection, P1: float, P2: float,
                   Pout: float, accumulate: bool = True, col0: int = 0,
                   W_pout: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of K2, on any device."""
    adj = direction_adj(cv.float(), direction, P1, P2, Pout, col0, W_pout)
    return acc.add_(adj) if accumulate else acc.copy_(adj)


def sgm_pass(cv: torch.Tensor, acc: torch.Tensor, direction: SgmDirection,
             P1: float, P2: float, Pout: float, accumulate: bool = True,
             col0: int = 0, W_pout: int | None = None) -> torch.Tensor:
    """Add one principal direction's adjustment into ``acc`` IN PLACE (or
    write it, when ``accumulate`` is False) and return ``acc``.  ``cv`` is
    an (H, W, D) COST volume, ``acc`` float32 of the same shape."""
    if cv.device.type == "cpu":
        return sgm_pass_plain(cv, acc, direction, P1, P2, Pout, accumulate,
                              col0, W_pout)
    _check_cuda(cv, acc, "sgm_pass")
    col0, W_pout = _pout_args(cv, col0, W_pout)
    di, dj = direction.step
    H, W, D = cv.shape
    lib = _build.load("sgm_scan")
    with torch.cuda.device(cv.device):
        err = lib.sgm_pass_launch(
            cv.data_ptr(), int(cv.dtype == torch.bfloat16), acc.data_ptr(),
            H, W, D, di, dj, P1, P2, Pout, int(accumulate), col0, W_pout,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sgm_pass_launch")
    sgm_pass.launches += 1
    return acc


sgm_pass.launches = 0


# ---------------------------------------------------------------------------
# K2k: one knight-move direction
# ---------------------------------------------------------------------------

def sgm_knight_pass_plain(cv, acc, direction: SgmDirection, P1: float,
                          P2: float, Pout: float, col0: int = 0,
                          W_pout: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of K2k, on any device."""
    return acc.add_(knight_adj(cv.float(), direction, P1, P2, Pout,
                               col0=col0, W_pout=W_pout))


def sgm_knight_pass(cv: torch.Tensor, acc: torch.Tensor,
                    direction: SgmDirection, P1: float, P2: float,
                    Pout: float, col0: int = 0,
                    W_pout: int | None = None) -> torch.Tensor:
    """Add one knight direction's adjustment into ``acc`` IN PLACE and
    return ``acc``: two K2k launches, one per seed phase, so no pixel is
    written by two lines of one launch.  The result is the same on every
    run (no atomics)."""
    if not direction.knight:
        raise ValueError(f"{direction.name} is not a knight-move direction")
    if cv.device.type == "cpu":
        return sgm_knight_pass_plain(cv, acc, direction, P1, P2, Pout, col0,
                                     W_pout)
    _check_cuda(cv, acc, "sgm_knight_pass")
    col0, W_pout = _pout_args(cv, col0, W_pout)
    (v0, h0), (v1, h1) = direction.steps
    H, W, D = cv.shape
    lib = _build.load("sgm_scan")
    with torch.cuda.device(cv.device):
        stream = torch.cuda.current_stream().cuda_stream
        for phase in (0, 1):
            err = lib.sgm_knight_launch(
                cv.data_ptr(), int(cv.dtype == torch.bfloat16),
                acc.data_ptr(), H, W, D, v0, v1, h0, h1, phase, P1, P2, Pout,
                col0, W_pout, stream)
            _build.check(lib, err, "sgm_knight_launch")
            sgm_knight_pass.launches += 1
    return acc


sgm_knight_pass.launches = 0


# ---------------------------------------------------------------------------
# K3: right-to-left direction + WTA + band + subpixel
# ---------------------------------------------------------------------------

def sgm_wta_plain(cv, acc, P1: float, P2: float, Pout: float, r: int,
                  h_radius: int, v_radius: int, refine: bool):
    """The plain PyTorch version of K3, on any device: returns (idx int32,
    bands (H, W, 2r+1) float32, disp or None)."""
    from .refinement import InterpolationKernel, refine_disp_cost_interpolation
    cvf = cv.float()
    C = acc + direction_adj(cvf, SgmDirection.RIGHT2LEFT, P1, P2, Pout) + cvf
    H, W, D = C.shape
    idx, bands = wta_bands(C, r)
    disp = None
    if refine:
        _, tcv = _tcv_from_bands(idx, bands, H, W, D, h_radius, v_radius, r)
        disp = refine_disp_cost_interpolation(InterpolationKernel.PARABOLA,
                                              tcv, idx)
    return idx, bands, disp


def sgm_wta(cv: torch.Tensor, acc: torch.Tensor, P1: float, P2: float,
            Pout: float, r: int, h_radius: int, v_radius: int,
            refine: bool):
    """The right-to-left SGM direction over the whole image ``cv`` with
    ``acc`` holding the other directions' adjustments, then tie-last WTA,
    the 2r+1 band and (``refine``) the parabola subpixel.  Returns
    (idx (H, W) int32, bands (H, W, 2r+1) float32, disp (H, W) float32 or
    None)."""
    if cv.device.type == "cpu":
        return sgm_wta_plain(cv, acc, P1, P2, Pout, r, h_radius, v_radius,
                             refine)
    _check_cuda(cv, acc, "sgm_wta")
    if r < 0 or (refine and r < 1):
        raise ValueError("sgm_wta: band radius r >= 0, and >= 1 to refine")
    H, W, D = cv.shape
    idx = torch.empty((H, W), dtype=torch.int32, device=cv.device)
    bands = torch.empty((H, W, 2 * r + 1), dtype=torch.float32,
                        device=cv.device)
    disp = (torch.empty((H, W), dtype=torch.float32, device=cv.device)
            if refine else None)
    lib = _build.load("sgm_scan")
    with torch.cuda.device(cv.device):
        err = lib.sgm_wta_launch(
            cv.data_ptr(), int(cv.dtype == torch.bfloat16), acc.data_ptr(),
            idx.data_ptr(), bands.data_ptr(),
            disp.data_ptr() if refine else None, H, W, D, P1, P2, Pout, r,
            h_radius, v_radius, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sgm_wta_launch")
    sgm_wta.launches += 1
    return idx, bands, disp


sgm_wta.launches = 0


# ---------------------------------------------------------------------------
# Composites
# ---------------------------------------------------------------------------

def sgm_accumulate(cv: torch.Tensor, directions, P1: float, P2: float,
                   Pout: float, col0: int = 0,
                   W_pout: int | None = None) -> torch.Tensor:
    """Sum of the given directions' adjustments (one K2 launch for each
    principal direction, two K2k launches for each knight direction)."""
    cv = kernel_volume(cv)
    acc = torch.empty(cv.shape, dtype=torch.float32, device=cv.device)
    for k, direction in enumerate(directions):
        if direction.knight:
            if k == 0:
                acc.zero_()
            sgm_knight_pass(cv, acc, direction, P1, P2, Pout, col0, W_pout)
        else:
            sgm_pass(cv, acc, direction, P1, P2, Pout, k > 0, col0, W_pout)
    return acc


def sgm_wta_fused(cv: torch.Tensor, P1: float, P2: float, Pout: float,
                  n_directions: int, r: int, h_radius: int, v_radius: int,
                  refine: bool):
    """SGM over a whole-image COST volume + WTA + band (+ subpixel): K2 for every
    principal direction but RIGHT2LEFT, K2k for the knight directions, then
    K3.  Returns what `sgm_wta` returns."""
    cv = kernel_volume(cv)
    dirs = [d for d in directions_for(n_directions)
            if d is not SgmDirection.RIGHT2LEFT]
    acc = sgm_accumulate(cv, dirs, P1, P2, Pout)
    return sgm_wta(cv, acc, P1, P2, Pout, r, h_radius, v_radius, refine)
