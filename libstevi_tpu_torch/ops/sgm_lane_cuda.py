"""K4a, K4b, K4c and K4d: the lane-layout SGM kernels (`csrc/sgm_lane.cu`),
the port of `libstevi_tpu/ops/sgm_pallas.py`.

These carry single-device SGM past K3's register limit (D <= 320): the
carries live in shared memory and, where a block's shared memory does not
hold them (K4d's one-column chunk past D = 11622, the WTA column scan past
14460), in a global area of the block's own (`chunk_layout`,
`cols_spills`), so the route takes any D.  (K2 and K2s take D past 320
too, one warp a line; the distributed K2s engine uses them there.)
- K4a `shift_rows` (`_shift_rows`): the per-row window copy, and `shear` /
  `unshear` on it (`pallas_shear` / `pallas_unshear`).
- K4b `fused_rows_pass`, `fused_cols_pass`, `fused_cols_wta`
  (`_fused_rows_kernel`, `_fused_cols_kernel`, `_make_fused_cols_wta`),
  driven by `fused_adj` (`sgm_fused_adj`): the vertical direction and both
  diagonal families in one sweep down and one up, then the two column
  scans, the last one optionally fused with the tie-last WTA and the band
  and, with 16 directions, summing the 8 knight volumes as it reads them
  (``knights``).  `fused_adj` returns None when `fused_fits` says the
  full-width carries do not fit on chip (the GPU form of
  `sgm_fused_adj`'s VMEM test); inside that rule `row_layout` sizes the
  row sweep's TMA ring and its split of D over warps, and `cols_layout`
  the column scans' (and puts their carries in global memory past a
  block's shared memory).
- K4c `fused_rows_shard_pass` (`sgm_rows_shard_pass`): K4b's row sweep on
  one row shard of a distributed image, with 1 or 3 carries in and out, the
  shard's global first row and the global height; its column half
  (`sgm_cols_shard_pass`) is `fused_cols_pass` on the shard's block.
  `parallel.sgm_dist.distributed_sgm_fused` relays it.
- K4d `chunked_sweep` (`_chunked_rows_kernel` / `_chunked_pass`, chained
  over the chunks by `sgm_chunked_adj`), driven by `chunked_adj`: one
  launch a sweep, every W-chunk a block of one grid, each chunk waiting
  only on its upstream neighbour's boundary carry of the previous row (a
  one-way wavefront, chunks taken by ticket in the flow's order);
  `chunk_width` fills the card, and `chunk_layout` puts a block's carries
  in global memory where a one-column chunk's do not fit its shared
  memory.  Its plain version `chunked_sweep_plain` chains
  `chunked_pass_plain`, the per-chunk form of `_chunked_pass`.

The volumes are (H, W, D) float32 regions; ``col0`` is the image column of
the region's first column and ``W_pout`` the image width, for the Pout test
``j + d >= W``.  The DP step is `_fused_step` (no isfinite guards; the TPU
padded d with +inf, here d = -1 and d = D read +inf), and every sum runs in
the TPU kernels' order, so a kernel and its plain version agree to the bit.
Each wrapper launches its kernel for CUDA tensors (counting the launch) and
runs its plain version (`*_plain`) for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import _build

SMEM_BLOCK = 232448      # bytes of shared memory one block can opt into (H100)
SMEM_SM = 233472         # bytes of shared memory an SM holds
H100_SMS = 132           # streaming multiprocessors of an H100 SXM
ROW_WARPS = 24           # most warps of a row-sweep block (csrc/sgm_lane.cu)
RING = 8                 # most stages of a TMA ring
COLS_WARPS = 4           # warps a column-scan line (parts of D)
MAX_KNIGHTS = 8          # knight volumes a column scan sums
_INF = float("inf")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _r16(x: int) -> int:
    return -(-x // 16) * 16


# ---------------------------------------------------------------------------
# Fit rules
# ---------------------------------------------------------------------------

def fused_fits(W: int, D: int, n_directions: int, budget: int | None = None,
               n_sm: int = H100_SMS) -> bool:
    """Whether K4b's rows pass holds a region of width W on chip: one block
    per SM owns ceil(W / n_sm) columns and keeps 2 buffers (row parity) of
    3 carries (1 for 4 directions) of D floats each for every column, plus
    the two neighbour-block carries it reads (8 directions), in at most
    ``budget`` bytes of shared memory (default: one block's 227 KiB)."""
    budget = SMEM_BLOCK if budget is None else budget
    n_car = 3 if n_directions >= 8 else 1
    halo = 2 if n_directions >= 8 else 0
    return (2 * n_car * _ceil_div(W, n_sm) + halo) * D * 4 <= budget


class RowLayout(NamedTuple):
    """How a K4b / K4c row sweep lays out one block (`row_layout`)."""
    ncols: int       # columns a block
    parts: int       # warps a column (G), each a run of 32-wide d-slices
    stages: int      # TMA ring stages (S; 0: direct loads)
    stage_acc: bool  # the ring stages acc beside cv (else acc is loaded)
    mins: bool       # the parts' minima kept beside the carries
    smem: int        # bytes of shared memory a block


def _area(ncols: int, D: int, n_car: int, n_halo: int, parts: int,
          mins: bool) -> int:
    """The bytes of a row-sweep block's area: ``ncols`` columns' carries (2
    buffers of ``n_car`` families, D floats each), ``n_halo`` staged
    neighbour carries (D + 2 (parts - 1) floats each) and, with ``mins``,
    the parts' minima.  `csrc/sgm_lane.cu`'s `row_layout` sums the same
    sizes."""
    return 4 * (2 * n_car * ncols * D + n_halo * (D + 2 * (parts - 1))
                + (2 * n_car * ncols * parts if mins else 0))


def _block_layout(ncols: int, D: int, n_car: int, n_halo: int,
                  accumulate: bool, budget: int, g: int) -> RowLayout | None:
    """A K4b / K4c row-sweep block whose area (`_area`) fits ``budget``
    bytes: a column's D is split over ``parts`` warps (whole 32-wide
    slices each), whose minima go beside the carries, the first that fits
    of: ``g`` parts, one part, and one part without the minima (the kernel
    then finds them by a loop); the ring takes what is left: the deepest
    of 2 to RING stages of cv and acc slabs, else of cv slabs alone (acc
    then loaded directly), else one cv stage, else none (direct loads).
    None where not even the carries fit."""

    def total(b, stages, stage_acc):
        slot = _r16(4 * ncols * D + 15)
        return (_r16(b) + _r16(8 * stages)
                + stages * slot * (2 if stage_acc else 1))

    fits = [(p, m) for p, m in ((g, True), (1, True), (1, False))
            if _area(ncols, D, n_car, n_halo, p, m) <= budget]
    if not fits:
        return None
    parts, mins = fits[0]
    b = _area(ncols, D, n_car, n_halo, parts, mins)
    for stage_acc, least in (((True, 2),) if accumulate else ()) + \
            ((False, 2), (False, 1)):
        s = next((s for s in range(RING, least - 1, -1)
                  if total(b, s, stage_acc) <= budget), 0)
        if s:
            return RowLayout(ncols, parts, s, stage_acc, mins,
                             total(b, s, stage_acc))
    return RowLayout(ncols, parts, 0, False, mins, b)


def row_layout(W: int, D: int, n_directions: int, accumulate: bool,
               budget: int | None = None,
               n_sm: int = H100_SMS) -> RowLayout | None:
    """The layout of a K4b / K4c row sweep over a region of width W (one
    block per SM, ceil(W / n_sm) columns each, `_block_layout`), or None
    where `fused_fits` refuses it (the same rule; this only spends what the
    carries leave of ``budget``, default one block's 227 KiB).  A pure
    function of its arguments."""
    if not fused_fits(W, D, n_directions, budget, n_sm):
        return None
    diag = n_directions >= 8
    ncols, slices = _ceil_div(W, n_sm), _ceil_div(D, 32)
    # as many parts as the block's ROW_WARPS warps give each column
    g = max(1, min(slices, ROW_WARPS // ncols))
    g = _ceil_div(slices, _ceil_div(slices, g))     # no empty part
    return _block_layout(ncols, D, 3 if diag else 1, 2 if diag else 0,
                         accumulate, SMEM_BLOCK if budget is None else budget,
                         g)


def chunk_width(D: int, n_directions: int = 8, W: int | None = None,
                n_sm: int = H100_SMS) -> int:
    """K4d's chunk width: the most columns whose carries (2 buffers of the
    vertical and, with 8 or 16 directions, the diagonal family, D floats a
    column) and one staged boundary carry fit one block's shared memory,
    and, given the region's width W, at most ceil(W / n_sm), so that the
    chunks fill the card: 30 at 3840 wide and D = 384, 128 chunks.  Where
    not even one column fits (D past 11622 with the diagonal, 29056
    without), the carries go to global memory (`chunk_layout`) and the
    chunks take ceil(W / n_sm) columns (1 without W).  A pure function of
    its arguments; the result's bits do not depend on it."""
    n_car, halo = (2, 1) if n_directions >= 8 else (1, 0)
    cw = (SMEM_BLOCK // (4 * D) - halo) // (2 * n_car)
    fill = _ceil_div(W, n_sm) if W is not None else None
    if cw < 1:
        return fill or 1
    return min(cw, fill) if fill is not None else cw


class ChunkLayout(NamedTuple):
    """How a K4d sweep lays out one block (`chunk_layout`)."""
    ncols: int       # columns a block
    parts: int       # warps a column (G), each a run of 32-wide d-slices
    mins: bool       # the parts' minima kept beside the carries
    area: int        # bytes of the block's carries, halo and minima
    spill: bool      # the area lies in global memory, not shared memory


def chunk_layout(D: int, cw: int, with_vertical: bool,
                 with_diag: bool) -> ChunkLayout:
    """The layout of one K4d sweep's block: ``cw`` columns of one or two
    families (the vertical, the diagonal) and one staged upstream carry
    (`_area`).  The parts balance the ROW_WARPS warps: the fewest that
    minimise the units a warp runs a row times a unit's slices, plus about
    one slice of a unit's own work (its minima): 4 at 5 columns and D =
    384, 3 at 30 (where one part would leave 6 warps two whole columns).
    The area takes the first that fits one block's shared memory of those
    parts, one part, and one part without the minima; where none fits, it
    keeps the balanced parts with their minima in global memory
    (``spill``).  A pure function of its arguments."""
    slices = _ceil_div(D, 32)
    g = min((g for g in range(1, min(slices, ROW_WARPS) + 1)
             if (g - 1) * _ceil_div(slices, g) < slices),    # no empty part
            key=lambda g: (_ceil_div(cw * g, ROW_WARPS)
                           * (_ceil_div(slices, g) + 1), g))
    n_car, n_halo = int(with_vertical) + int(with_diag), int(with_diag)
    for parts, mins in ((g, True), (1, True), (1, False)):
        area = _area(cw, D, n_car, n_halo, parts, mins)
        if area <= SMEM_BLOCK:
            return ChunkLayout(cw, parts, mins, area, False)
    return ChunkLayout(cw, g, True, _area(cw, D, n_car, n_halo, g, True),
                       True)


class ColsLayout(NamedTuple):
    """How a K4b column scan lays out one block (`cols_layout`)."""
    parts: int       # warps a line (G), each a run of 32-wide d-slices
    stages: int      # TMA ring stages (S; 0: direct loads)
    smem: int        # bytes of shared memory a block


def _cols_parts(D: int) -> int:
    slices = _ceil_div(D, 32)
    g = min(slices, COLS_WARPS)
    return _ceil_div(slices, _ceil_div(slices, g))     # no empty part


def cols_area(D: int, wta: bool) -> int:
    """The bytes of a K4b column scan's area a line: the two carries, with
    ``wta`` two C vectors, then the parts' minima.  `csrc/sgm_lane.cu`'s
    `cols_area` sums the same sizes."""
    n = 4 if wta else 2
    return _r16(4 * n * D) + 4 * n * _cols_parts(D)


def cols_spills(D: int, wta: bool) -> bool:
    """Whether a column scan's area passes one block's budget less the
    static barriers (the WTA scan past D = 14460, the other past 28924):
    it then lies in global memory, one area a line, and the scan loads
    directly.  A pure function of its arguments."""
    return cols_area(D, wta) > SMEM_BLOCK - 1024


def cols_layout(H: int, D: int, n_knights: int, wta: bool,
                n_sm: int = H100_SMS) -> ColsLayout:
    """The layout of a K4b column scan: one block a line (H lines), its D
    split over up to COLS_WARPS warps, its area (`cols_area`) and a ring
    whose stages each hold one pixel's cv, acc and ``n_knights`` knight
    D-vectors.  As K2's ring (`csrc/sgm_scan.cu`): as deep as the card's
    shared memory spread over all lines allows, 2 to RING, then shallower
    where a block's bytes pass its budget; 0 (direct loads) where not even
    one stage fits.  Where the area lies in global memory (`cols_spills`)
    the block takes no shared memory and no ring.  A pure function of its
    arguments."""
    g = _cols_parts(D)
    if cols_spills(D, wta):
        return ColsLayout(g, 0, 0)
    stage = (2 + n_knights) * _r16(4 * D + 15)
    area = cols_area(D, wta)
    limit = SMEM_BLOCK - 1024                # less the static barriers
    per_line = 0.9 * SMEM_SM * n_sm / max(H, 1)
    s = min(RING, max(2, int((per_line - area) // stage)))
    while s and s * stage + area > limit:
        s -= 1
    return ColsLayout(g, s, s * stage + area)


def _sms(t: torch.Tensor) -> int:
    if t.is_cuda:
        return torch.cuda.get_device_properties(t.device).multi_processor_count
    return H100_SMS


def _check_cuda(what: str, *ts) -> None:
    dev = ts[0].device
    for t in ts:
        if t is None:
            continue
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{what}: every tensor on one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: contiguous float32 tensors")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _pout_row(W, D, col0, W_pout, Pout, device):
    """(W, D): Pout where col0 + j + d >= W_pout, else 0."""
    j = col0 + torch.arange(W, device=device)[:, None]
    d = torch.arange(D, device=device)
    return torch.where(j + d >= W_pout, Pout, 0.0)


def _step(prev, base, pout, P1, P2):
    """`_fused_step` on (..., D): (cur, adj); prev[-1], prev[D] are +inf."""
    m = prev.amin(-1, keepdim=True)
    inf = torch.full_like(prev[..., :1], _INF)
    left = torch.cat([inf, prev[..., :-1]], -1)
    right = torch.cat([prev[..., 1:], inf], -1)
    agg = torch.minimum(torch.minimum(prev, m + P2),
                        torch.minimum(left, right) + P1)
    adj = agg - m + pout
    return base + adj, adj


# ---------------------------------------------------------------------------
# K4a: per-row shifted window copy
# ---------------------------------------------------------------------------

def _starts(H, base, slope, smax, device):
    i = torch.arange(H, device=device)
    return (base + slope * i).clamp(0, smax)


def shift_rows_plain(x: torch.Tensor, W_out: int, base: int,
                     slope: int) -> torch.Tensor:
    """The plain version of K4a: slicing row by row."""
    H, W_in, _ = x.shape
    s = _starts(H, base, slope, W_in - W_out, "cpu").tolist()
    return torch.stack([x[i, s[i]:s[i] + W_out] for i in range(H)])


def shift_rows(x: torch.Tensor, W_out: int, base: int,
               slope: int) -> torch.Tensor:
    """out[i, c, :] = x[i, clamp(base + slope * i, 0, W_in - W_out) + c, :]
    for an (H, W_in, Dp) float32 volume."""
    H, W_in, Dp = x.shape
    if W_out > W_in:
        raise ValueError("shift_rows: W_out <= W_in")
    if x.device.type == "cpu":
        return shift_rows_plain(x, W_out, base, slope)
    _check_cuda("shift_rows", x)
    out = torch.empty((H, W_out, Dp), dtype=torch.float32, device=x.device)
    lib = _build.load("sgm_lane")
    with torch.cuda.device(x.device):
        err = lib.shift_rows_launch(x.data_ptr(), out.data_ptr(), H, W_in,
                                    W_out, Dp, base, slope, _stream())
    _build.check(lib, err, "shift_rows_launch")
    shift_rows.launches += 1
    return out


shift_rows.launches = 0


def shear(cv: torch.Tensor, neg: bool) -> torch.Tensor:
    """Diagonal shear of an (H, W, Dp) volume to (H, W + H - 1, Dp): column
    c holds the down-right (c = j + H-1 - i) or, with ``neg``, the
    down-left (c = i + j) diagonal; +inf off the image."""
    H = cv.shape[0]
    x = torch.nn.functional.pad(cv, (0, 0, H - 1, H), value=_INF)
    Wd = cv.shape[1] + H - 1
    return shift_rows(x, Wd, H - 1, -1) if neg else shift_rows(x, Wd, 0, 1)


def unshear(S: torch.Tensor, W: int, neg: bool) -> torch.Tensor:
    """The inverse of `shear` on the image columns."""
    H = S.shape[0]
    return shift_rows(S, W, 0, 1) if neg else shift_rows(S, W, H - 1, -1)


# ---------------------------------------------------------------------------
# K4b: fused row sweeps, column scans, column scan + WTA
# ---------------------------------------------------------------------------

def fused_rows_shard_pass_plain(cv, acc, carries, i0: int, H_img: int,
                                reverse: bool, diag: bool, col0: int,
                                W_pout: int, P1: float, P2: float,
                                Pout: float):
    """The plain version of K4b's rows pass (K4c with ``carries``): returns
    (the new adj volume, the carries out).  ``acc`` None means zeros;
    ``carries`` (1 or 3, W, D) None means zero line starts."""
    H, W, D = cv.shape
    pout = _pout_row(W, D, col0, W_pout, Pout, cv.device)
    out = torch.empty_like(cv)
    zrow = cv.new_zeros((1, D))
    c_v = cv.new_zeros((W, D))
    c_p = c_n = c_v
    if carries is not None:
        c_v = carries[0]
        if diag:
            c_p, c_n = carries[1], carries[2]
    cols = torch.arange(W, device=cv.device)[:, None]
    for i in (range(H - 1, -1, -1) if reverse else range(H)):
        ig = i0 + i
        base = cv[i]
        total = acc[i] if acc is not None else torch.zeros_like(base)
        c_v, adj = _step(c_v, base, pout, P1, P2)
        total = total + adj
        if diag:
            shift = (torch.cat([c_p[1:], zrow]) if reverse
                     else torch.cat([zrow, c_p[:-1]]))
            c_p, adj = _step(shift, base, pout, P1, P2)
            cj = W - H_img + ig if reverse else ig
            total = total + adj * (1.0 + (cols == cj).float())
            shift = (torch.cat([zrow, c_n[:-1]]) if reverse
                     else torch.cat([c_n[1:], zrow]))
            c_n, adj = _step(shift, base, pout, P1, P2)
            cj = H_img - 1 - ig if reverse else W - 1 - ig
            total = total + adj * (1.0 + (cols == cj).float())
        out[i] = total
    return out, torch.stack([c_v, c_p, c_n] if diag else [c_v])


def fused_rows_pass_plain(cv, acc, reverse: bool, diag: bool, col0: int,
                          W_pout: int, P1: float, P2: float,
                          Pout: float) -> torch.Tensor:
    """The plain version of K4b's rows pass: returns the new adj volume
    (``acc`` plus this sweep's directions; ``acc`` None means zeros)."""
    return fused_rows_shard_pass_plain(cv, acc, None, 0, cv.shape[0],
                                       reverse, diag, col0, W_pout, P1, P2,
                                       Pout)[0]


def _rows_launch(cv, acc, carries, i0, H_img, reverse, diag, col0, W_pout,
                 P1, P2, Pout, what, carries_out, budget=None):
    """Launch K4b's rows kernel (K4c with carries or an offset) with the
    `row_layout` of its geometry (``budget`` caps the shared memory it
    spends): returns (out, the carries out, or None without
    ``carries_out``)."""
    _check_cuda(what, cv, acc, carries)
    H, W, D = cv.shape
    n_sm = _sms(cv)
    n_dirs = 8 if diag else 4
    if not fused_fits(W, D, n_dirs, n_sm=n_sm):
        raise NotImplementedError(f"{what}: the carries do not fit "
                                  "(fused_fits); use chunked_adj")
    lay = row_layout(W, D, n_dirs, acc is not None,
                     min(SMEM_BLOCK, budget or SMEM_BLOCK), n_sm)
    if lay is None:
        raise ValueError(f"{what}: budget below the carries' bytes")
    n_car = 3 if diag else 1
    if carries is not None and carries.shape != (n_car, W, D):
        raise ValueError(f"{what}: carries of shape ({n_car}, W, D)")
    if not (0 <= i0 and i0 + H <= H_img):
        raise ValueError(f"{what}: rows [i0, i0 + H) inside H_img")
    out = acc if acc is not None else torch.empty_like(cv)
    # the edge carries (2 parities, 2 families, W, D), then their parts'
    # minima (2, 2, W, parts); the neighbour-sync counters, one a block,
    # zeroed for every launch
    edge = torch.empty(4 * W * (D + lay.parts) if diag else 1,
                       dtype=torch.float32, device=cv.device)
    flags = torch.zeros(_ceil_div(W, lay.ncols) if diag else 1,
                        dtype=torch.int32, device=cv.device)
    couts = (torch.empty((n_car, W, D), dtype=torch.float32,
                         device=cv.device) if carries_out else None)
    lib = _build.load("sgm_lane")
    with torch.cuda.device(cv.device):
        err = lib.fused_rows_launch(
            cv.data_ptr(), acc.data_ptr() if acc is not None else None,
            out.data_ptr(), edge.data_ptr(), flags.data_ptr(),
            carries.data_ptr() if carries is not None else None,
            couts.data_ptr() if couts is not None else None, H, W, D,
            lay.ncols, lay.parts, lay.stages, int(lay.stage_acc),
            int(lay.mins), col0, W_pout, P1, P2, Pout, int(reverse),
            int(diag), i0, H_img, _stream())
    _build.check(lib, err, "fused_rows_launch")
    return out, couts


def fused_rows_pass(cv: torch.Tensor, acc: torch.Tensor | None,
                    reverse: bool, diag: bool, col0: int, W_pout: int,
                    P1: float, P2: float, Pout: float,
                    budget: int | None = None) -> torch.Tensor:
    """One sweep down (up with ``reverse``) carrying the vertical direction
    and, with ``diag``, both diagonal families.  With ``acc`` the sweep adds
    into it IN PLACE and returns it; without, it returns a new volume.
    ``budget`` caps the kernel's shared memory (`row_layout`)."""
    if cv.device.type == "cpu":
        return fused_rows_pass_plain(cv, acc, reverse, diag, col0, W_pout,
                                     P1, P2, Pout)
    out, _ = _rows_launch(cv, acc, None, 0, cv.shape[0], reverse, diag, col0,
                          W_pout, P1, P2, Pout, "fused_rows_pass", False,
                          budget)
    fused_rows_pass.launches += 1
    return out


fused_rows_pass.launches = 0


def fused_rows_shard_pass(cv: torch.Tensor, acc: torch.Tensor | None,
                          carries: torch.Tensor | None, i0: int, H_img: int,
                          reverse: bool, diag: bool, col0: int, W_pout: int,
                          P1: float, P2: float, Pout: float,
                          budget: int | None = None):
    """K4c: `fused_rows_pass` on rows [i0, i0 + H) of an image ``H_img``
    rows high.  ``carries`` (1 or 3 with ``diag``, W, D) are the previous
    shard's post-step carries of its last scan row (vertical, then the
    down-right and down-left diagonal families; None: zero line starts).
    Returns (the adj volume, as `fused_rows_pass`; the carries of this
    shard's last scan row)."""
    if cv.device.type == "cpu":
        return fused_rows_shard_pass_plain(cv, acc, carries, i0, H_img,
                                           reverse, diag, col0, W_pout, P1,
                                           P2, Pout)
    out = _rows_launch(cv, acc, carries, i0, H_img, reverse, diag, col0,
                       W_pout, P1, P2, Pout, "fused_rows_shard_pass", True,
                       budget)
    fused_rows_shard_pass.launches += 1
    return out


fused_rows_shard_pass.launches = 0


def _knight_sum(acc_j, knights, j):
    """acc[:, j] plus the knight volumes' column j, in their order."""
    if knights is not None:
        for k in knights:
            acc_j = acc_j + k[:, j]
    return acc_j


def fused_cols_pass_plain(cv, acc, reverse: bool, col0: int, W_pout: int,
                          P1: float, P2: float, Pout: float,
                          knights=None) -> torch.Tensor:
    """The plain version of K4b's column scan (adds into ``acc`` in place,
    after the ``knights`` volumes, acc + k_0 + k_1 + ... in order)."""
    H, W, D = cv.shape
    pout = _pout_row(W, D, col0, W_pout, Pout, cv.device)
    carry = cv.new_zeros((H, D))
    for j in (range(W - 1, -1, -1) if reverse else range(W)):
        carry, adj = _step(carry, cv[:, j], pout[j], P1, P2)
        acc[:, j] = _knight_sum(acc[:, j], knights, j) + adj
    return acc


def _check_knights(what, cv, knights):
    if knights is None:
        return 0
    if (knights.ndim != 4 or tuple(knights.shape[1:]) != tuple(cv.shape)
            or not 1 <= knights.shape[0] <= MAX_KNIGHTS):
        raise ValueError(f"{what}: knights (1 to {MAX_KNIGHTS}, H, W, D)")
    _check_cuda(what, cv, knights)
    return knights.shape[0]


def _cols_launch(cv, acc, knights, out, idx, bands, reverse, r, col0,
                 W_pout, P1, P2, Pout, what):
    n_k = _check_knights(what, cv, knights)
    H, W, D = cv.shape
    wta = idx is not None
    lay = cols_layout(H, D, n_k, wta, _sms(cv))
    # past a block's shared memory, each line's area in global memory
    spill = (torch.empty(H * _r16(cols_area(D, wta)), dtype=torch.uint8,
                         device=cv.device) if cols_spills(D, wta) else None)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    lib = _build.load("sgm_lane")
    with torch.cuda.device(cv.device):
        err = lib.fused_cols_launch(
            cv.data_ptr(), acc.data_ptr(), ptr(knights), n_k, ptr(out),
            ptr(idx), ptr(bands), ptr(spill), H, W, D, col0, W_pout, P1, P2,
            Pout,
            int(reverse), r, int(idx is not None), lay.parts, lay.stages,
            _stream())
    _build.check(lib, err, "fused_cols_launch")


def fused_cols_pass(cv: torch.Tensor, acc: torch.Tensor, reverse: bool,
                    col0: int, W_pout: int, P1: float, P2: float,
                    Pout: float, knights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """LEFT2RIGHT (RIGHT2LEFT with ``reverse``): adds the direction's
    adjustment into ``acc`` IN PLACE and returns it.  ``knights``, an
    (n <= 8, H, W, D) stack, is summed into ``acc`` first, in order, as
    the scan reads it: the bits of n in-place adds before the scan."""
    if cv.device.type == "cpu":
        return fused_cols_pass_plain(cv, acc, reverse, col0, W_pout, P1, P2,
                                     Pout, knights)
    _check_cuda("fused_cols_pass", cv, acc)
    _cols_launch(cv, acc, knights, acc, None, None, reverse, 0, col0, W_pout,
                 P1, P2, Pout, "fused_cols_pass")
    fused_cols_pass.launches += 1
    return acc


fused_cols_pass.launches = 0


def fused_cols_wta_plain(cv, acc, r: int, col0: int, W_pout: int, P1: float,
                         P2: float, Pout: float, knights=None):
    """The plain version of K4b's WTA column scan: (idx, bands)."""
    H, W, D = cv.shape
    pout = _pout_row(W, D, col0, W_pout, Pout, cv.device)
    dd = torch.arange(D, device=cv.device)
    idx = torch.empty((H, W), dtype=torch.int32, device=cv.device)
    bands = cv.new_empty((H, W, 2 * r + 1))
    carry = cv.new_zeros((H, D))
    for j in range(W - 1, -1, -1):
        base = cv[:, j]
        carry, adj = _step(carry, base, pout[j], P1, P2)
        C = _knight_sum(acc[:, j], knights, j) + adj + base
        m = C.amin(-1, keepdim=True)
        best = torch.where(C == m, dd, -1).amax(-1)
        idx[:, j] = best.int()
        Cp = torch.nn.functional.pad(C, (r, r), value=_INF)
        for k in range(2 * r + 1):
            bands[:, j, k] = (m[:, 0] if k == r else
                              torch.gather(Cp, 1, (best + k)[:, None])[:, 0])
    return idx, bands


def fused_cols_wta(cv: torch.Tensor, acc: torch.Tensor, r: int, col0: int,
                   W_pout: int, P1: float, P2: float, Pout: float,
                   knights: torch.Tensor | None = None):
    """RIGHT2LEFT fused with C = acc + adj + cv, the tie-last argmin and
    the band C[idx - r .. idx + r] (+inf outside [0, D); the centre slot is
    the minimum).  ``knights`` as in `fused_cols_pass`: C = ((acc + k_0 +
    ... + k_{n-1}) + adj) + cv.  Returns (idx (H, W) int32, bands (H, W,
    2r+1))."""
    if r < 0:
        raise ValueError("fused_cols_wta: r >= 0")
    if cv.device.type == "cpu":
        return fused_cols_wta_plain(cv, acc, r, col0, W_pout, P1, P2, Pout,
                                    knights)
    _check_cuda("fused_cols_wta", cv, acc)
    H, W, D = cv.shape
    idx = torch.empty((H, W), dtype=torch.int32, device=cv.device)
    bands = torch.empty((H, W, 2 * r + 1), dtype=torch.float32,
                        device=cv.device)
    _cols_launch(cv, acc, knights, None, idx, bands, True, r, col0, W_pout,
                 P1, P2, Pout, "fused_cols_wta")
    fused_cols_wta.launches += 1
    return idx, bands


fused_cols_wta.launches = 0


def _region_f32(region: torch.Tensor) -> torch.Tensor:
    return region.float().contiguous()


def fused_adj(region: torch.Tensor, col0: int, W_pout: int, P1: float,
              P2: float, Pout: float, n_directions: int,
              budget: int | None = None, wta_radius: int | None = None,
              separate: bool = False, one_launch: bool | None = None):
    """All principal-direction adjustments of an (H, W, D) region through
    K4b: down, up (adding onto down's output, or with ``separate`` into a
    volume of its own, added at the end), then the two column scans; 16
    directions add the knight directions (K2k, `_knight_stack`) before the
    last column scan.  With ``wta_radius`` the last scan is
    `fused_cols_wta` and the result is (idx, bands).  Returns None when
    `fused_fits` refuses the width (``budget`` overrides its shared-memory
    budget, and caps the row sweeps', `row_layout`).  ``one_launch``
    forces the knights' form (`_knight_stack`)."""
    if n_directions not in (4, 8, 16):
        raise ValueError("fused_adj takes 4, 8 or 16 directions")
    if separate and wta_radius is not None:
        raise ValueError("fused_adj: separate accumulation has no WTA pass")
    H, W, D = region.shape
    if not fused_fits(W, D, n_directions, budget, _sms(region)):
        return None
    cv = _region_f32(region)
    P1, P2, Pout = float(P1), float(P2), float(Pout)
    diag = n_directions >= 8
    kw = dict(col0=col0, W_pout=W_pout, P1=P1, P2=P2, Pout=Pout)
    adj = fused_rows_pass(cv, None, False, diag, budget=budget, **kw)
    if separate:
        adj_up = fused_rows_pass(cv, None, True, diag, budget=budget, **kw)
    else:
        adj = fused_rows_pass(cv, adj, True, diag, budget=budget, **kw)
    adj = fused_cols_pass(cv, adj, False, **kw)
    knights = _knight_stack(cv, adj, n_directions, one_launch, **kw)
    if wta_radius is not None:
        return fused_cols_wta(cv, adj, wta_radius, knights=knights, **kw)
    adj = fused_cols_pass(cv, adj, True, knights=knights, **kw)
    return adj + adj_up if separate else adj


def _knight_stack(cv, adj, n_directions, one_launch, col0, W_pout, P1, P2,
                  Pout):
    """The eight knight directions of 16-direction SGM (K2k, its any-D
    instance past D = 320), in `_KNIGHT_DIRS` order, for the last column
    scan: where their 8 volumes fit (`sgm_cuda._one_launch`, or
    ``one_launch``), the stack of volumes (two launches), which the scan
    sums into ``adj`` as it reads it; else None, after adding them into
    ``adj`` in place one direction at a time through one scratch volume
    (`add_knight_volumes`).  Both leave the same bits.  None for 4 and 8
    directions."""
    if n_directions < 16:
        return None
    from .sgm import _KNIGHT_DIRS
    from .sgm_cuda import _one_launch, add_knight_volumes, knight_volumes
    if one_launch is None:
        one_launch = _one_launch(cv, len(_KNIGHT_DIRS))
    if one_launch:
        return knight_volumes(cv, _KNIGHT_DIRS, P1, P2, Pout, col0, W_pout)
    add_knight_volumes(cv, adj, _KNIGHT_DIRS, P1, P2, Pout, col0, W_pout,
                       one_launch=False)
    return None


# ---------------------------------------------------------------------------
# K4d: W-chunked row sweeps with an edge-history relay
# ---------------------------------------------------------------------------

def chunked_pass_plain(cv, adj, hist, c0: int, Wc: int, *, col0: int,
                       W_pout: int, P1: float, P2: float, Pout: float,
                       reverse: bool, shift_down: bool, corner_c0: int,
                       corner_slope: int, with_vertical: bool,
                       with_diag: bool, accumulate: bool) -> torch.Tensor:
    """One W-chunk of a K4d sweep, the form of `_chunked_pass` that
    `chunked_sweep_plain` chains: writes (or adds, with ``accumulate``)
    columns [c0, c0 + Wc) of ``adj`` in place and returns the history out
    (the boundary column's post-row carries, or ``hist`` without the
    diagonal)."""
    H, W, D = cv.shape
    pout = _pout_row(Wc, D, col0 + c0, W_pout, Pout, cv.device)
    cols = torch.arange(Wc, device=cv.device)[:, None]
    c_v = c_d = cv.new_zeros((Wc, D))
    hout = torch.empty_like(hist)
    for i in (range(H - 1, -1, -1) if reverse else range(H)):
        base = cv[i, c0:c0 + Wc]
        total = (adj[i, c0:c0 + Wc] if accumulate
                 else torch.zeros_like(base))
        if with_vertical:
            c_v, a = _step(c_v, base, pout, P1, P2)
            total = total + a
        if with_diag:
            hrow = hist[i:i + 1]
            shift = (torch.cat([hrow, c_d[:-1]]) if shift_down
                     else torch.cat([c_d[1:], hrow]))
            c_d, a = _step(shift, base, pout, P1, P2)
            hout[i] = c_d[Wc - 1] if shift_down else c_d[0]
            cj = corner_c0 + corner_slope * i - c0
            total = total + a * (1.0 + (cols == cj).float())
        else:
            hout[i] = hist[i]
        adj[i, c0:c0 + Wc] = total
    return hout


def chunked_sweep_plain(cv, adj, *, cw: int, col0: int, W_pout: int,
                        P1: float, P2: float, Pout: float, reverse: bool,
                        shift_down: bool, corner_c0: int, corner_slope: int,
                        with_vertical: bool, with_diag: bool,
                        accumulate: bool) -> torch.Tensor:
    """The plain version of K4d: `chunked_pass_plain` chained over the
    chunks of ``cw`` columns in the flow's order (left to right with
    ``shift_down``, else right to left), each chunk taking its upstream
    neighbour's boundary carries of the previous scan row (a zero row at
    the first), as `sgm_chunked_adj` chains `_chunked_pass`.  Writes (adds,
    with ``accumulate``) ``adj`` in place and returns it."""
    H, W, D = cv.shape
    n_w = _ceil_div(W, cw)
    hist = cv.new_zeros((H, D))
    zrow = cv.new_zeros((1, D))
    for w in (range(n_w) if shift_down else range(n_w - 1, -1, -1)):
        c0 = w * cw
        hout = chunked_pass_plain(
            cv, adj, hist, c0, min(cw, W - c0), col0=col0, W_pout=W_pout,
            P1=P1, P2=P2, Pout=Pout, reverse=reverse, shift_down=shift_down,
            corner_c0=corner_c0, corner_slope=corner_slope,
            with_vertical=with_vertical, with_diag=with_diag,
            accumulate=accumulate)
        # the consumer at row i takes the producer's carry after row i - 1
        # (i + 1 on reverse sweeps); the zero row starts a line
        hist = (torch.cat([hout[1:], zrow]) if reverse
                else torch.cat([zrow, hout[:-1]]))
    return adj


def chunked_sweep(cv: torch.Tensor, adj: torch.Tensor, *, cw: int,
                  col0: int, W_pout: int, P1: float, P2: float, Pout: float,
                  reverse: bool, shift_down: bool, corner_c0: int,
                  corner_slope: int, with_vertical: bool, with_diag: bool,
                  accumulate: bool) -> torch.Tensor:
    """One row sweep over all rows and all W-chunks of ``cw`` columns (K4d,
    one launch): the vertical direction (``with_vertical``) and one
    diagonal family (``with_diag``; ``shift_down``: the carry moves to
    higher columns, else lower), the doubled corner line at region column
    corner_c0 + corner_slope * i.  Writes (adds, with ``accumulate``)
    ``adj`` IN PLACE and returns it; the bits are those of
    `chunked_sweep_plain` at any ``cw``, whether the block's carries lie
    in shared or in global memory (`chunk_layout`)."""
    kw = dict(col0=col0, W_pout=W_pout, P1=float(P1), P2=float(P2),
              Pout=float(Pout), reverse=reverse, shift_down=shift_down,
              corner_c0=corner_c0, corner_slope=corner_slope,
              with_vertical=with_vertical, with_diag=with_diag,
              accumulate=accumulate)
    if cv.device.type == "cpu":
        return chunked_sweep_plain(cv, adj, cw=cw, **kw)
    _check_cuda("chunked_sweep", cv, adj)
    H, W, D = cv.shape
    if adj.shape != cv.shape or not 1 <= cw <= W:
        raise ValueError("chunked_sweep: adj of cv's shape, 1 <= cw <= W")
    if not (with_vertical or with_diag):
        raise ValueError("chunked_sweep: a vertical or a diagonal family")
    lay = chunk_layout(D, cw, with_vertical, with_diag)
    n_w = _ceil_div(W, cw)
    # every row's boundary carries, then their parts' minima; the chunks'
    # row counters and the ticket, zeroed for every launch; past a block's
    # shared memory, each block's area
    hist = (torch.empty(n_w * H * (D + lay.parts), dtype=torch.float32,
                        device=cv.device) if with_diag else None)
    flags = torch.zeros(n_w + 1, dtype=torch.int32, device=cv.device)
    spill = (torch.empty(n_w * _r16(lay.area), dtype=torch.uint8,
                         device=cv.device) if lay.spill else None)
    lib = _build.load("sgm_lane")
    with torch.cuda.device(cv.device):
        err = lib.chunked_sweep_launch(
            cv.data_ptr(), adj.data_ptr() if accumulate else None,
            adj.data_ptr(), hist.data_ptr() if with_diag else None,
            flags.data_ptr(), spill.data_ptr() if lay.spill else None, H, W,
            D, cw, lay.parts, int(lay.mins), col0, W_pout, kw["P1"],
            kw["P2"], kw["Pout"], int(reverse), int(shift_down), corner_c0,
            corner_slope, int(with_vertical), int(with_diag), _stream())
    _build.check(lib, err, "chunked_sweep_launch")
    chunked_sweep.launches += 1
    return adj


chunked_sweep.launches = 0


def chunk_sweeps(H: int, W: int, n_directions: int) -> dict:
    """`sgm_chunked_adj`'s table of K4d's sweeps over an H x W region, in
    their order: kind -> `chunked_sweep`'s reverse, shift_down, corner line
    (region column corner_c0 + corner_slope * i), with_vertical and
    with_diag.  The verticals ride the two left-to-right sweeps (SE, NE);
    8 and 16 directions add SW and NW; 4 directions carry no diagonal."""
    diag = n_directions >= 8

    def sweep(reverse, shift_down, c0, slope, vertical):
        return dict(reverse=reverse, shift_down=shift_down, corner_c0=c0,
                    corner_slope=slope, with_vertical=vertical,
                    with_diag=diag)
    # carry shift, chunk order, doubled corner line j = c0 + slope * i:
    #   SE fwd  down  L->R  j = i          NE rev  down  L->R  j = H-1-i
    #   SW fwd  up    R->L  j = W-1-i      NW rev  up    R->L  j = i + W-H
    out = {"SE": sweep(False, True, 0, 1, True),
           "NE": sweep(True, True, H - 1, -1, True)}
    if diag:
        out.update(SW=sweep(False, False, W - 1, -1, False),
                   NW=sweep(True, False, W - H, 1, False))
    return out


def chunked_adj(region: torch.Tensor, col0: int, W_pout: int, P1: float,
                P2: float, Pout: float, n_directions: int,
                cw: int | None = None, wta_radius: int | None = None):
    """All principal-direction adjustments of an (H, W, D) region through
    K4d, one launch for each of the four sweeps of `sgm_chunked_adj`'s
    table (two for 4 directions), and K4b's two column scans (16
    directions: the knight directions before the last, as `fused_adj`).
    With ``wta_radius`` the last scan is `fused_cols_wta` and the result is
    (idx, bands).  ``cw`` forces the chunk width (default `chunk_width` for
    the region's width); the bits do not depend on it."""
    if n_directions not in (4, 8, 16):
        raise ValueError("chunked_adj takes 4, 8 or 16 directions")
    cv = _region_f32(region)
    H, W, D = cv.shape
    cw = (chunk_width(D, n_directions, W, _sms(cv)) if cw is None
          else min(W, cw))
    kw = dict(col0=col0, W_pout=W_pout, P1=float(P1), P2=float(P2),
              Pout=float(Pout))
    adj = torch.empty_like(cv)
    for k, sweep in enumerate(chunk_sweeps(H, W, n_directions).values()):
        # the first sweep writes, the later ones add
        chunked_sweep(cv, adj, cw=cw, accumulate=k > 0, **sweep, **kw)
    adj = fused_cols_pass(cv, adj, False, **kw)
    knights = _knight_stack(cv, adj, n_directions, None, **kw)
    if wta_radius is not None:
        return fused_cols_wta(cv, adj, wta_radius, knights=knights, **kw)
    return fused_cols_pass(cv, adj, True, knights=knights, **kw)
