"""K2, K2k, K2s and K3: the SGM scans as CUDA kernels (`csrc/sgm_scan.cu`),
the port of `libstevi_tpu/ops/sgm_pallas_dhw.py`.

K2 (`sgm_pass`) runs one principal direction and adds its adjustment into
an f32 accumulator of the volume's shape; K2k (`knight_volumes`) runs up
to 8 knight-move directions of the 16-direction set side by side, each
into a volume of its own, in two launches (the two seed phases, see
`csrc/sgm_scan.cu`); K3 (`sgm_wta`) runs the last direction, right to
left, fused with C = cost + acc + adj, the tie-last WTA, the band
C[idx - r .. idx + r] (+inf beyond [0, D)) and, optionally, the parabola
subpixel with the SAME-mode NaN rules.  The flagship's 8 directions are 7
K2 directions and one K3 launch: the 7 in one launch, a volume each, where
they fit (`direction_volumes`), else 7 launches into one accumulator; 16
directions add the 8 knight volumes after them (`sgm_wta_fused`: K3 sums
the 15 volumes in order, or they are added to the accumulator in order,
`add_knight_volumes`).  Every path adds a knight direction's volume
p0 + p1 once, acc + (p0 + p1), the JAX XLA path's order.  K2, K2k and K2s
take any D: past D = 320 K2 runs the instances of `pass_layout`, and K2k
keeps its carry in shared memory, past its ring (`ring_fits`) in global
memory.  K3 takes D <= 320 (`ops.sgm.sgm_route` sends wider ranges to the
lane route, K4b / K4d).  K2, K2k and K3 stage the pixels ahead of each
line's step in a shared-memory ring filled by asynchronous copies, so a
step does not wait on device memory.  K3 runs a row a block: a scan warp
carries the right-to-left recurrence and hands each pixel's adjustment to
reduce warps that sum the stack, take the WTA and write the band and
disparity (`wta_layout`, its shapes).

K2s (`sgm_shard_pass`, `sgm_knight_shard_pass`) is K2 and K2k on one shard
of a distributed image, the port of `sgm_rows_shard_pass_dhw` and
`sgm_cols_shard_pass_dhw`: carries in and out, the shard's global first
scan row and the global extent (`parallel.sgm_dist` relays them).  The
port has no DHW layout: the names of the JAX functions are kept only so a
reader can find the counterpart.  Horizontal passes on a row shard are
plain K2 on the block (the W axis is not sharded).  Their plain versions
equal the kernels bit for bit, and run shard after shard they equal the
whole-image plain pass bit for bit.

K2 past D = 320 runs a line a block of G warps with D split across them,
in the instance `pass_layout` picks: the carry in registers (K d-slices a
lane, a TMA ring a warp), in shared memory, or in device memory.

K2 and K2k take the image column of the volume's first column (``col0``)
and the image width (``W_pout``) for the Pout test ``j + d >= W``, so a
margin region runs as its own contiguous volume (`sgm.sgm_cost_volume`).
K3 takes whole images only: with margins, `sgm.sgm_wta_truncated` runs the
chain of `sgm_cost_volume`, WTA and band, as the JAX package does.

The TPU path baked Pout into the cost stream and restored the multiplicity
in its WTA pass (`box_pallas.py:226-238`, `_bake_mult_plane`); the CUDA DP
adds Pout in its step, as `_line_recurrence` does, which gives the same
idx, bands and disparity.  The DP runs in f32 for f32 and bf16 volumes
alike, as the JAX XLA path does (it casts the volume to f32).

Each wrapper launches its kernel for CUDA tensors and runs its plain
version (`*_plain`, built on `sgm.direction_adj` and the knights' lane form
`_knight_lane`) for CPU tensors.  The knight kernels equal their plain
versions bit for bit; `sgm.knight_adj` (the line form the CPU's
`sgm_cost_volume` runs, which sums a pixel's overlapping lines with
`index_put_`) agrees with them within 1e-4.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..utils.profiling import count, span
from .sgm_lane_cuda import H100_SMS
from .sgm import (SgmDirection, directions_for, direction_adj,
                  direction_shard_adj, wta_bands, _dp_step, _tcv_from_bands)

MAX_D = 320        # K3 keeps ceil(D / 32) <= 10 values per lane
MAX_ACC = 15       # acc volumes K3 sums: SGM-16's 7 principal, 8 knight
# a block's 227 KB less room for the static barriers (csrc/sgm_scan.cu)
SMEM_MAX = 232448 - 1024
# the any-D K2's limits, as in csrc/sgm_scan.cu
GROUP_K4_MAX_D = 1024   # the registers instance at K = 4 (G <= 8 warps)
GROUP_MAX_D = 8192      # ... at K = 8 (G <= 32 warps)
MAX_GROUP = 32          # warps a line
PASS_SMEM = 232448 - 4096   # a block's 227 KB less the static arrays
BUF_MAX_D = PASS_SMEM // 8  # the shared instance's two carries
RING = 8                # most stages of a ring
SMEM_SM = 0.9 * 233472  # the share of an SM's 228 KB a ring plans with
# K3's layout (`wta_layout`), as in csrc/sgm_scan.cu
WTA_REDUCE = 8          # most reduce warps a row
WTA_PACE = 4            # reduce warps a row needs to keep pace with its scan
WTA_WARPS_SM = 24       # the warps an SM plans with (its registers)
WTA_CHUNK = 2048        # a scan chunk's bytes of cost vectors
WTA_CHUNKS = 4          # scan chunks in the scan warp's ring
# the static barriers of a K3 block: the chunks', two an adj slot, a stage's
WTA_BARS = WTA_CHUNKS + 4 * WTA_REDUCE + WTA_REDUCE * RING


def _r16(x: int) -> int:
    return -(-x // 16) * 16


def ring_fits(D: int, elt: int = 4, n_acc: int = 1) -> bool:
    """Whether a K2k launch lays out its ring at D: `ring_layout` in
    csrc/sgm_scan.cu at its shallowest, two stages of the cost vector's
    cover (``elt`` bytes an entry) and ``n_acc`` f32 covers, plus the two
    shared-memory carries (8 D bytes) of the any-D instance past D = 320,
    within SMEM_MAX.  K2k's second seed phase stages one f32 vector beside
    the cost's (n_acc = 1), so f32 volumes take D <= 9640 there.  Past it
    K2k loads directly and keeps its carries in global memory
    (`_knight_launch`), so it takes any D.  (K2 past D = 320 follows
    `pass_layout`.)  A pure function of its arguments."""
    stage = _r16(D * elt + 15) + n_acc * _r16(4 * D + 15)
    return 2 * stage + (_r16(8 * D) if D > MAX_D else 0) <= SMEM_MAX


class PassLayout(NamedTuple):
    """How the any-D K2 (D > 320) runs a launch (`pass_layout`)."""
    carries: str     # 'registers', 'shared' or 'device'
    K: int           # d-slices a lane (registers), else 0
    G: int           # warps a line (one line a block)
    stages: int      # ring stages a warp (registers), else 0
    smem: int        # dynamic shared memory a block


def pass_layout(D: int, elt: int = 4, n_acc: int = 1, lines: int = 1,
                sms: int = H100_SMS) -> PassLayout:
    """The instance, K, G, ring depth and shared-memory bytes of an any-D
    K2 launch over ``lines`` lines (all directions') of a volume of
    ``elt``-byte entries, staging ``n_acc`` f32 acc vectors beside the cost
    (1 where the pass accumulates): `pass_layout` in csrc/sgm_scan.cu.
    Up to D = 8192 the carry lives in registers: K = 4 slices a lane up to
    D = 1024 (G <= 8 warps), then K = 8 (G <= 32: 1024 threads leave 64
    registers a thread), and each warp stages its part of D through a TMA
    ring, RING stages deep where the launch's lines would all fit the
    card's shared memory at once, at least 2.  Past it the two carries lie
    in shared memory (8 D bytes, to D = 28544), then in device memory, 32
    warps a line, with direct loads.  A pure function of its arguments."""
    if D <= MAX_D:
        raise ValueError(f"pass_layout: the any-D K2 takes D > {MAX_D}")
    if D > GROUP_MAX_D:
        shared = D <= BUF_MAX_D
        return PassLayout("shared" if shared else "device", 0, MAX_GROUP, 0,
                          _r16(8 * D) if shared else 0)
    K = 4 if D <= GROUP_K4_MAX_D else 8
    G = -(-D // (32 * K))
    stage = _r16(32 * K * elt + 15) + n_acc * _r16(32 * K * 4 + 15)
    S = int(SMEM_SM * sms / max(lines, 1) / (G * stage))
    S = min(RING, max(2, S))
    while G * S * stage > PASS_SMEM and S > 2:
        S -= 1
    return PassLayout("registers", K, G, S, G * S * stage)


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
    if cv.shape[-1] < 1:
        raise ValueError(f"{what}: D >= 1")


def _check_carries(carries, shape, dev, what: str) -> None:
    if carries is None:
        return
    if (carries.device != dev or carries.dtype != torch.float32
            or tuple(carries.shape) != shape or not carries.is_contiguous()):
        raise ValueError(f"{what}: carries must be contiguous float32 of "
                         f"shape {shape} on cv's device")


def _ptr(t):
    return t.data_ptr() if t is not None else None


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
    sgm_pass.layout = _pass_launch(cv, acc, None, None, [direction], P1, P2,
                                   Pout, accumulate, col0, W_pout, 0,
                                   cv.shape[0])
    count("launches.sgm_pass")
    return acc


sgm_pass.layout = None  # the last launch's `PassLayout` (None: D <= 320)


def _pass_launch(cv, acc, cin, cout, directions, P1, P2, Pout, accumulate,
                 col0, W_pout, i0, H_img):
    """One K2 launch over ``directions``; direction y uses volume y of
    ``acc``.  Returns the `PassLayout` the launcher ran past D = 320 (as
    it reports it), else None."""
    steps = [s for d in directions for s in d.step]
    steps = (ctypes.c_int * len(steps))(*steps)
    H, W, D = cv.shape
    # where `pass_layout` puts the carries in device memory, each line's
    # two in an area of its own: fewer than H + W lines a direction
    spill = (torch.empty(len(directions) * (H + W) * _r16(8 * D),
                         dtype=torch.uint8, device=cv.device)
             if D > MAX_D and pass_layout(D).carries == "device" else None)
    used = (ctypes.c_int * 5)(-1, 0, 0, 0, 0)
    lib = _build.load("sgm_scan")
    with torch.cuda.device(cv.device):
        err = lib.sgm_pass_launch(
            cv.data_ptr(), int(cv.dtype == torch.bfloat16), acc.data_ptr(),
            _ptr(cin), _ptr(cout), _ptr(spill), len(directions),
            ctypes.addressof(steps), H, W, D, P1, P2, Pout, int(accumulate),
            col0, W_pout, i0, H_img, ctypes.addressof(used),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sgm_pass_launch")
    if used[0] < 0:
        return None
    return PassLayout(("registers", "shared", "device")[used[0]], *used[1:])


# ---------------------------------------------------------------------------
# K2s: one vertical or diagonal direction on one row shard
# ---------------------------------------------------------------------------

def sgm_shard_pass_plain(cv, acc, direction: SgmDirection, P1: float,
                         P2: float, Pout: float, accumulate: bool = True,
                         carry: torch.Tensor | None = None, i0: int = 0,
                         H_img: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of K2s, on any device: returns the carry
    out."""
    adj, cout = direction_shard_adj(cv.float(), direction, P1, P2, Pout,
                                    carry=carry, i0=i0, H_img=H_img)
    acc.add_(adj) if accumulate else acc.copy_(adj)
    return cout


def sgm_shard_pass(cv: torch.Tensor, acc: torch.Tensor,
                   direction: SgmDirection, P1: float, P2: float,
                   Pout: float, accumulate: bool = True,
                   carry: torch.Tensor | None = None, i0: int = 0,
                   H_img: int | None = None) -> torch.Tensor:
    """`sgm_pass` for a vertical or diagonal direction on rows [i0, i0 + H)
    of an image ``H_img`` rows high (whole-image columns, so the Pout test
    needs no offset): the lines continue from ``carry`` (W, D) float32,
    the previous shard's post-step carries of its last scan row (None:
    zeros, the line start).  Adds into ``acc`` in place and returns the
    carries of this shard's last scan row (W, D)."""
    H, W, D = cv.shape
    H_img = i0 + H if H_img is None else H_img
    if direction.knight or direction.step[0] == 0:
        raise ValueError(f"sgm_shard_pass: {direction.name} is not a "
                         "vertical or diagonal direction")
    if not (0 <= i0 and i0 + H <= H_img):
        raise ValueError("sgm_shard_pass: rows [i0, i0 + H) inside H_img")
    if cv.device.type == "cpu":
        return sgm_shard_pass_plain(cv, acc, direction, P1, P2, Pout,
                                    accumulate, carry, i0, H_img)
    _check_cuda(cv, acc, "sgm_shard_pass")
    _check_carries(carry, (W, D), cv.device, "sgm_shard_pass")
    cout = torch.empty((W, D), dtype=torch.float32, device=cv.device)
    sgm_shard_pass.layout = _pass_launch(cv, acc, carry, cout, [direction],
                                         P1, P2, Pout, accumulate, 0, W, i0,
                                         H_img)
    count("launches.sgm_shard_pass")
    return cout


sgm_shard_pass.layout = None  # the last launch's `PassLayout`, as sgm_pass's


# ---------------------------------------------------------------------------
# K2k: the knight-move directions, one volume each
# ---------------------------------------------------------------------------

def _knight_lane(cv, direction: SgmDirection, P1: float, P2: float,
                 Pout: float, carries: torch.Tensor | None = None,
                 s0: int = 0, N_img: int | None = None, col0: int = 0,
                 W_pout: int | None = None):
    """One knight direction's adjustment p0 + p1 over rows [s0, s0 + N)
    of ``N_img`` along its primary axis, in the TPU kernels' lane form
    (`_knight_row`, `libstevi_tpu/ops/sgm_pallas_dhw.py:107`).  Per seed
    phase one carry for each lateral position, shifted one position on the
    steps a line of that phase drifts; phase 0 weighs the corner line
    (u == t // 2) twice, phase 1 holds lines only where u <= (t - 1) // 2.
    Returns (p0 + p1 in ``cv``'s layout, the carries out (2, lateral, D))."""
    (v0, h0), (v1, h1) = direction.steps
    vert = v0 == v1
    x = cv.float() if vert else cv.float().transpose(0, 1)
    N, X, D = x.shape
    N_img = s0 + N if N_img is None else N_img
    col0, W_pout = _pout_args(cv, col0, W_pout)
    pstep, drift = (v0, h1) if vert else (h0, v1)
    t0 = s0 if pstep > 0 else N_img - s0 - N
    dev = cv.device
    dd = torch.arange(D, device=dev)
    lat = torch.arange(X, device=dev)
    u = (lat if drift > 0 else X - 1 - lat)[:, None]
    if vert:                       # lateral positions are image columns
        pout_lat = torch.where(col0 + lat[:, None] + dd >= W_pout, Pout, 0.0)
    zrow = x.new_zeros((1, D))
    carry = [x.new_zeros((X, D)), x.new_zeros((X, D))]
    if carries is not None:
        carry = [carries[0].float(), carries[1].float()]
    adj = [torch.empty_like(x), torch.empty_like(x)]
    for k in range(N):
        p = k if pstep > 0 else N - 1 - k
        t = t0 + k
        pout = (pout_lat if vert else
                torch.where(col0 + p + dd >= W_pout, Pout, 0.0)[None])
        for ph in (0, 1):
            c = carry[ph]
            if t % 2 == ph:        # a line of this phase drifts into step t
                c = (torch.cat([zrow, c[:-1]]) if drift > 0
                     else torch.cat([c[1:], zrow]))
            cur, a = _dp_step(c, x[p], pout, P1, P2)
            if ph == 0:
                adj[0][p] = a * (1.0 + (u == t // 2).float())
                carry[0] = cur
            else:
                live = u <= (t - 1) // 2
                adj[1][p] = torch.where(live, a, 0.0)
                carry[1] = torch.where(live, cur, 0.0)
    vol = adj[0] + adj[1]
    return (vol if vert else vol.transpose(0, 1)), torch.stack(carry)


def _knight_out(cv, directions, out, what: str) -> torch.Tensor:
    """``out``, or a new (n, H, W, D) float32 stack, checked."""
    if not directions or not all(d.knight for d in directions):
        raise ValueError(f"{what} takes one or more knight directions")
    shape = (len(directions),) + tuple(cv.shape)
    if out is None:
        return torch.empty(shape, dtype=torch.float32, device=cv.device)
    if (tuple(out.shape) != shape or out.dtype != torch.float32
            or out.device != cv.device or not out.is_contiguous()):
        raise ValueError(f"{what}: out must be contiguous float32 of shape "
                         f"{shape} on cv's device")
    return out


def knight_volumes_plain(cv, directions, P1: float, P2: float, Pout: float,
                         col0: int = 0, W_pout: int | None = None,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of `knight_volumes`, on any device: each
    direction's p0 + p1 in the lane form (`_knight_lane`)."""
    out = _knight_out(cv, directions, out, "knight_volumes")
    for d, v in zip(directions, out):
        v.copy_(_knight_lane(cv, d, P1, P2, Pout, col0=col0,
                             W_pout=W_pout)[0])
    return out


def knight_volumes(cv: torch.Tensor, directions, P1: float, P2: float,
                   Pout: float, col0: int = 0, W_pout: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Each of up to 8 knight directions' adjustment in a volume of its
    own, (n, H, W, D) float32 (into ``out`` if given): TWO K2k launches for
    all n, one a seed phase, whose grid's second axis picks the direction.
    Phase 0 has a line at every pixel and writes each volume whole (no
    zero fill); phase 1 adds its lines' adjustment.  Each volume is p0 + p1
    of its direction, so adding the volumes to an accumulator one after
    another gives acc + (p0 + p1) per direction, the JAX XLA path's order
    (`sgm.sgm_cost_volume`).  The same bits on every run (no atomics).
    ``col0`` and ``W_pout`` as in `sgm_pass`."""
    cv = kernel_volume(cv)
    out = _knight_out(cv, directions, out, "knight_volumes")
    if cv.device.type == "cpu":
        return knight_volumes_plain(cv, directions, P1, P2, Pout, col0,
                                    W_pout, out)
    _check_cuda(cv, out[0], "knight_volumes")
    col0, W_pout = _pout_args(cv, col0, W_pout)
    _knight_launch(cv, out, None, None, directions, P1, P2, Pout, col0,
                   W_pout, 0, 0)
    count("launches.knight_volumes", 2)
    return out


def _knight_launch(cv, vol, cin, cout, directions, P1, P2, Pout, col0,
                   W_pout, s0, N_img):
    """Both seed phases of ``directions`` into ``vol`` (volume y for
    direction y): phase 0 writes, then phase 1 adds.  ``cin`` / ``cout``
    (one direction only) hold phase 0's carries, then phase 1's; N_img = 0
    takes each direction's own extent."""
    steps = [s for d in directions
             for s in (d.steps[0][0], d.steps[1][0], d.steps[0][1],
                       d.steps[1][1])]
    steps = (ctypes.c_int * len(steps))(*steps)
    H, W, D = cv.shape
    # past the any-D ring (`ring_fits`, phase 1's), each line's carries in
    # global memory: fewer than H + W lines a direction
    elt = cv.element_size()
    spill = (torch.empty(len(directions) * (H + W) * _r16(8 * D),
                         dtype=torch.uint8, device=cv.device)
             if D > MAX_D and not ring_fits(D, elt, 1) else None)
    lib = _build.load("sgm_scan")
    with torch.cuda.device(cv.device):
        stream = torch.cuda.current_stream().cuda_stream
        for phase in (0, 1):
            err = lib.sgm_knight_launch(
                cv.data_ptr(), int(cv.dtype == torch.bfloat16),
                vol.data_ptr(), _ptr(cin[phase] if cin is not None else None),
                _ptr(cout[phase] if cout is not None else None), _ptr(spill),
                len(directions), ctypes.addressof(steps), H, W, D, phase, P1,
                P2, Pout, col0, W_pout, s0, N_img, stream)
            _build.check(lib, err, "sgm_knight_launch")


def add_knight_volumes(cv: torch.Tensor, acc: torch.Tensor, directions,
                       P1: float, P2: float, Pout: float, col0: int = 0,
                       W_pout: int | None = None,
                       one_launch: bool | None = None) -> torch.Tensor:
    """Add the knight directions' adjustments into ``acc`` IN PLACE, one
    direction after another (acc + (p0 + p1) per direction), and return
    ``acc``.  Where their volumes fit (`_one_launch`), `knight_volumes`
    runs them all in two launches; else one direction at a time into one
    scratch volume (two launches a direction, the same bits, one volume of
    memory).  ``one_launch`` forces the form."""
    cv = kernel_volume(cv)
    if one_launch is None:
        one_launch = _one_launch(cv, len(directions))
    if one_launch:
        for v in knight_volumes(cv, directions, P1, P2, Pout, col0, W_pout):
            acc.add_(v)
        return acc
    scratch = torch.empty((1,) + tuple(cv.shape), dtype=torch.float32,
                          device=cv.device)
    for d in directions:
        acc.add_(knight_volumes(cv, [d], P1, P2, Pout, col0, W_pout,
                                scratch)[0])
    return acc


# ---------------------------------------------------------------------------
# K2s: one knight direction on one row (or column) shard
# ---------------------------------------------------------------------------

def sgm_knight_shard_pass_plain(cv, acc, direction: SgmDirection,
                                P1: float, P2: float, Pout: float,
                                carries: torch.Tensor | None = None,
                                s0: int = 0, N_img: int | None = None,
                                col0: int = 0,
                                W_pout: int | None = None) -> torch.Tensor:
    """The plain PyTorch version of K2s for a knight direction, on any
    device: adds the lane form's p0 + p1 (`_knight_lane`) into ``acc`` once,
    as the kernel's path does, and returns the carries out (2, lateral,
    D)."""
    vol, cout = _knight_lane(cv, direction, P1, P2, Pout, carries, s0, N_img,
                             col0, W_pout)
    acc.add_(vol)
    return cout


def sgm_knight_shard_pass(cv: torch.Tensor, acc: torch.Tensor,
                          direction: SgmDirection, P1: float, P2: float,
                          Pout: float, carries: torch.Tensor | None = None,
                          s0: int = 0, N_img: int | None = None,
                          col0: int = 0,
                          W_pout: int | None = None) -> torch.Tensor:
    """One knight direction on one shard: scan rows [s0, s0 + N) of
    ``N_img`` along the direction's primary axis (image rows for the
    down/up knights, which run on row shards; image columns for the
    left/right knights, which run on column shards, where ``col0`` is the
    shard's first image column and ``W_pout`` the image width).
    ``carries`` (2, lateral, D) float32 hold the previous shard's post-step
    carries of its last scan row for each seed phase (lateral: W for row
    shards, H for column shards; None: zeros, the line start).  The two
    K2k launches write the shard's volume p0 + p1, which is added into
    ``acc`` in place once; returns this shard's carries out."""
    if not direction.knight:
        raise ValueError(f"{direction.name} is not a knight-move direction")
    H, W, D = cv.shape
    vert = direction.steps[0][0] != 0
    N, X = (H, W) if vert else (W, H)
    N_img = s0 + N if N_img is None else N_img
    if not (0 <= s0 and s0 + N <= N_img):
        raise ValueError("sgm_knight_shard_pass: [s0, s0 + N) inside N_img")
    if cv.device.type == "cpu":
        return sgm_knight_shard_pass_plain(cv, acc, direction, P1, P2, Pout,
                                           carries, s0, N_img, col0, W_pout)
    _check_cuda(cv, acc, "sgm_knight_shard_pass")
    _check_carries(carries, (2, X, D), cv.device, "sgm_knight_shard_pass")
    col0, W_pout = _pout_args(cv, col0, W_pout)
    vol = torch.empty((1,) + tuple(cv.shape), dtype=torch.float32,
                      device=cv.device)
    cout = torch.zeros((2, X, D), dtype=torch.float32, device=cv.device)
    _knight_launch(cv, vol, carries, cout, [direction], P1, P2, Pout, col0,
                   W_pout, s0, N_img)
    count("launches.sgm_knight_shard_pass", 2)
    acc.add_(vol[0])
    return cout


# ---------------------------------------------------------------------------
# K3: right-to-left direction + WTA + band + subpixel
# ---------------------------------------------------------------------------

class WtaLayout(NamedTuple):
    """How a K3 launch lays out a row's block (`wta_layout`)."""
    reduce_warps: int   # R: the block is a scan warp and R reduce warps
    stages: int         # S: a reduce warp's ring of pixels' vectors
    scan_pixels: int    # P: pixels a scan chunk (one bulk copy)
    scan_chunks: int    # SC: chunks in the scan warp's ring
    adj_slots: int      # A: the adj ring between the scan and reduce warps
    smem: int           # dynamic shared memory a block
    rows_sm: int        # rows (blocks) an SM is planned to hold at once


def _wta_reduce_warps(budget: int, scan: int, warp: int, rows: int) -> int:
    return min((budget - scan) // warp, WTA_REDUCE, WTA_WARPS_SM // rows - 1)


def wta_layout(D: int, elt: int = 4, n_acc: int = 1, H: int = 1,
               sms: int = H100_SMS) -> WtaLayout:
    """The layout of a K3 launch over an (H, W, D) volume of ``elt``-byte
    entries and ``n_acc`` f32 acc volumes on ``sms`` SMs: `wta_layout` in
    csrc/sgm_scan.cu.  One image row a block.  Each row an SM is planned
    to hold at once gets an equal share of SMEM_SM (all of SMEM_MAX where
    one reduce warp of two stages needs it).  The scan warp stages
    WTA_CHUNKS chunks of P = WTA_CHUNK // (D elt) pixels' cost vectors; a
    reduce warp takes two stages of a pixel's cost and acc covers, its
    32 K floats of C and two adj slots, and a row takes as many as its
    share holds, up to WTA_REDUCE and to WTA_WARPS_SM warps an SM; what is
    left deepens the reduce rings, up to RING stages.  An SM plans the
    count of rows n whose rows end soonest: ceil(H / (n sms)) waves, one
    after another, each WTA_PACE / R times as long as its scan warp alone
    where a row has R < WTA_PACE reduce warps (the fewest rows among
    equals).  A pure function of its arguments.  Nothing in the port
    calls it: the launcher computes the layout itself and reports it
    (`sgm_wta.layout`); this twin lets tests/test_torch_k3_layout.py check
    the layout for every shape on the CPU."""
    if not 1 <= D <= MAX_D or not 1 <= n_acc <= MAX_ACC:
        raise ValueError(f"wta_layout: 1 <= D <= {MAX_D}, "
                         f"1 <= n_acc <= {MAX_ACC}")
    vec = 128 * -(-D // 32)
    stage = _r16(D * elt + 15) + n_acc * _r16(4 * D + 15)
    P = max(1, WTA_CHUNK // (D * elt))
    scan = WTA_CHUNKS * _r16(P * D * elt + 15)
    warp = 2 * stage + 3 * vec

    def share(rows):
        b = int(SMEM_SM / rows)
        return SMEM_MAX if b > SMEM_MAX or scan + warp > b else b

    def waves_and_pace(rows):
        return (-(-H // (rows * sms)),
                min(_wta_reduce_warps(share(rows), scan, warp, rows),
                    WTA_PACE))

    rows, (waves, pace) = 1, waves_and_pace(1)
    for n in range(2, WTA_WARPS_SM // 2 + 1):
        if scan + warp > SMEM_SM / n:
            break
        w, p = waves_and_pace(n)
        if w * pace < waves * p:    # fewer waves over their pace
            rows, waves, pace = n, w, p
    budget = share(rows)
    R = _wta_reduce_warps(budget, scan, warp, rows)
    S = min(RING, (budget - scan - R * 3 * vec) // (R * stage))
    return WtaLayout(R, S, P, WTA_CHUNKS, 2 * R,
                     scan + 2 * R * vec + R * (S * stage + vec), rows)


def _acc_sum(acc: torch.Tensor) -> torch.Tensor:
    """An (H, W, D) accumulator, or the in-order sum of an (n, H, W, D)
    stack of adjustment volumes, (((a_0 + a_1) + a_2) + ...): the volume
    that K2 launches accumulating one after another leave."""
    if acc.ndim == 3:
        return acc
    total = acc[0]
    for a in acc[1:]:
        total = total + a
    return total


def sgm_wta_plain(cv, acc, P1: float, P2: float, Pout: float, r: int,
                  h_radius: int, v_radius: int, refine: bool):
    """The plain PyTorch version of K3, on any device: returns (idx int32,
    bands (H, W, 2r+1) float32, disp or None)."""
    from .refinement import InterpolationKernel, refine_disp_cost_interpolation
    cvf = cv.float()
    C = (_acc_sum(acc) + direction_adj(cvf, SgmDirection.RIGHT2LEFT, P1, P2,
                                       Pout) + cvf)
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
    the 2r+1 band and (``refine``) the parabola subpixel.  ``acc`` is one
    (H, W, D) volume or an (n, H, W, D) stack of up to 15 of them (one a
    direction, `direction_volumes` and `knight_volumes`), which K3 sums in
    order as it reads them (`_acc_sum`).  Returns (idx (H, W) int32, bands (H, W, 2r+1)
    float32, disp (H, W) float32 or None)."""
    if cv.device.type == "cpu":
        return sgm_wta_plain(cv, acc, P1, P2, Pout, r, h_radius, v_radius,
                             refine)
    stack = acc if acc.ndim == 4 else acc[None]
    if cv.shape[-1] > MAX_D:
        # K3 keeps ceil(D / 32) <= 10 values a lane in registers;
        # `sgm.sgm_route` sends wider ranges to K4b / K4d
        raise NotImplementedError(f"sgm_wta: 1 <= D <= {MAX_D}")
    if not stack.is_contiguous() or not 1 <= stack.shape[0] <= MAX_ACC:
        raise ValueError(f"sgm_wta: acc must be contiguous, 1 to {MAX_ACC} "
                         f"volumes")
    if r < 0 or (refine and r < 1):
        raise ValueError("sgm_wta: band radius r >= 0, and >= 1 to refine")
    for a in stack:
        _check_cuda(cv, a, "sgm_wta")
    H, W, D = cv.shape
    idx = torch.empty((H, W), dtype=torch.int32, device=cv.device)
    bands = torch.empty((H, W, 2 * r + 1), dtype=torch.float32,
                        device=cv.device)
    disp = (torch.empty((H, W), dtype=torch.float32, device=cv.device)
            if refine else None)
    used = (ctypes.c_int * 8)()
    lib = _build.load("sgm_scan")
    with torch.cuda.device(cv.device):
        err = lib.sgm_wta_launch(
            cv.data_ptr(), int(cv.dtype == torch.bfloat16), stack.data_ptr(),
            stack.shape[0], idx.data_ptr(), bands.data_ptr(),
            disp.data_ptr() if refine else None, H, W, D, P1, P2, Pout, r,
            h_radius, v_radius, ctypes.addressof(used),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "sgm_wta_launch")
    count("launches.sgm_wta")
    sgm_wta.layout = WtaLayout(*used[:7])
    sgm_wta.resident = used[7]
    return idx, bands, disp


sgm_wta.layout = None  # the last launch's `WtaLayout`, as it reports it
sgm_wta.resident = None  # the blocks of it an SM can hold, as the card says


# ---------------------------------------------------------------------------
# Composites
# ---------------------------------------------------------------------------

def sgm_accumulate(cv: torch.Tensor, directions, P1: float, P2: float,
                   Pout: float, col0: int = 0, W_pout: int | None = None,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """Sum of the given directions' adjustments: one K2 launch for each
    principal direction, into one accumulator in their order (``out`` if
    given, float32 of ``cv``'s shape), then the knight directions' volumes
    (`add_knight_volumes`) added one after another, acc + (p0 + p1)
    each."""
    cv = kernel_volume(cv)
    if out is not None and (out.shape != cv.shape
                            or out.dtype != torch.float32):
        raise ValueError("sgm_accumulate: out must be float32 of cv's shape")
    acc = (torch.empty(cv.shape, dtype=torch.float32, device=cv.device)
           if out is None else out)
    principal = [d for d in directions if not d.knight]
    knights = [d for d in directions if d.knight]
    for k, direction in enumerate(principal):
        sgm_pass(cv, acc, direction, P1, P2, Pout, k > 0, col0, W_pout)
    if not principal:
        acc.zero_()
    if knights:
        add_knight_volumes(cv, acc, knights, P1, P2, Pout, col0, W_pout)
    return acc


def direction_volumes(cv: torch.Tensor, directions, P1: float, P2: float,
                      Pout: float, out: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Each of up to 7 principal directions' adjustment in a volume of its
    own, (n, H, W, D) float32 (into ``out`` if given): ONE K2 launch, whose
    grid's second axis picks the direction, so the directions' lines fill
    the card together (one direction has fewer lines than the card has
    schedulers up to 480x640, and few a scheduler beyond).  `_acc_sum` of
    the stack is `sgm_accumulate`'s volume bit for bit (the same
    adjustments, added in the same order)."""
    cv = kernel_volume(cv)
    if any(d.knight for d in directions):
        raise ValueError("direction_volumes takes principal directions")
    shape = (len(directions),) + tuple(cv.shape)
    adj = (torch.empty(shape, dtype=torch.float32, device=cv.device)
           if out is None else out)
    if tuple(adj.shape) != shape or not adj.is_contiguous():
        raise ValueError(f"direction_volumes: out must be contiguous {shape}")
    if cv.device.type == "cpu":
        for d, a in zip(directions, adj):
            sgm_pass_plain(cv, a, d, P1, P2, Pout, accumulate=False)
        return adj
    _check_cuda(cv, adj[0], "direction_volumes")
    H, W, _ = cv.shape
    _pass_launch(cv, adj, None, None, directions, P1, P2, Pout, False, 0, W,
                 0, H)
    count("launches.direction_volumes")
    return adj


def one_launch_fits(stack_bytes: int, free_bytes: int) -> bool:
    """Whether a stack of direction volumes (``stack_bytes`` in all) is
    taken over one accumulator: where it takes at most half of the
    ``free_bytes`` the device has left.  `sgm_wta_fused` then runs
    `direction_volumes` (one K2 launch, a volume a direction; with 16
    directions also `knight_volumes`) and K3 sums the stack, and
    `add_knight_volumes` runs all its directions in one pair of launches.
    Both forms give the same bits; with K3 after it the one launch was the
    faster form from 480x640 to 2160x3840 on an H100 (`chip_smoke.k2_forms`,
    PERF.md), so memory alone decides."""
    return 2 * stack_bytes <= free_bytes


def _one_launch(cv: torch.Tensor, n_volumes: int) -> bool:
    """`one_launch_fits` for ``n_volumes`` float32 volumes of ``cv``'s
    shape on its card; False on the CPU."""
    if cv.device.type != "cuda":
        return False
    free, _ = torch.cuda.mem_get_info(cv.device)
    # the caching allocator's reserved but unused blocks are free to it
    free += (torch.cuda.memory_reserved(cv.device)
             - torch.cuda.memory_allocated(cv.device))
    return one_launch_fits(n_volumes * cv.numel() * 4, free)


def sgm_wta_fused(cv: torch.Tensor, P1: float, P2: float, Pout: float,
                  n_directions: int, r: int, h_radius: int, v_radius: int,
                  refine: bool, acc: torch.Tensor | None = None):
    """SGM over a whole-image COST volume + WTA + band (+ subpixel): K2 for
    every principal direction but RIGHT2LEFT (16 directions: and K2k for
    the knight directions), then K3.  Where `one_launch_fits` (the volumes
    fit), K2 runs once into a volume a direction (`direction_volumes`), the
    knights into theirs (`knight_volumes`, two launches), and K3 sums the
    stack (up to 15 volumes) in order; else the K2 launches accumulate into
    one volume, one after another, and the knight volumes are added after
    them (`sgm_accumulate`): the same bits.  A preallocated ``acc`` (float32,
    contiguous) takes the place of K2's buffer and decides the form: an
    (n_directions - 1, H, W, D) stack the one launch, an (H, W, D) volume
    the accumulator.  The choice counts in ``form.k2_one_launch`` or
    ``form.k2_accumulate``.  Returns what `sgm_wta` returns."""
    cv = kernel_volume(cv)
    dirs = [d for d in directions_for(n_directions)
            if d is not SgmDirection.RIGHT2LEFT]
    stack = (len(dirs),) + tuple(cv.shape)
    if acc is not None and tuple(acc.shape) not in (stack, tuple(cv.shape)):
        raise ValueError(f"sgm_wta_fused: acc of shape {stack} or "
                         f"{tuple(cv.shape)}")
    with span("stevi.route"):
        one_launch = (_one_launch(cv, len(dirs)) if acc is None
                      else acc.ndim == 4)
    count("form.k2_one_launch" if one_launch else "form.k2_accumulate")
    with span("stevi.k2"):
        if one_launch:
            principal = [d for d in dirs if not d.knight]
            knights = [d for d in dirs if d.knight]
            if acc is None:
                acc = torch.empty(stack, dtype=torch.float32,
                                  device=cv.device)
            direction_volumes(cv, principal, P1, P2, Pout,
                              acc[:len(principal)])
            if knights:
                knight_volumes(cv, knights, P1, P2, Pout,
                               out=acc[len(principal):])
        else:
            acc = sgm_accumulate(cv, dirs, P1, P2, Pout, out=acc)
    with span("stevi.k3"):
        return sgm_wta(cv, acc, P1, P2, Pout, r, h_radius, v_radius, refine)
