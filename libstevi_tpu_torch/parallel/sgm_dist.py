"""Distributed SGM over a row-sharded cost volume (counterpart of
`libstevi_tpu/parallel/sgm_dist.py`).

The volume is a list of row shards in image order, each an (H_loc, W, D)
tensor on its own device (`mesh.make_stereo_mesh` may repeat a device).
Horizontal scanlines are rows, so each shard computes them alone.  A
vertical, diagonal or down/up knight line crosses shard boundaries: its DP
carry (one D-vector per column) is relayed shard to shard (`carry_relay`),
and each shard runs its pass when the relay reaches it.  The relay is exact,
so the result equals the single-device one; it serialises those passes
across shards, as the JAX package's `ppermute` relay does.

Each shard runs the directions in the single-device order
(`ops.sgm_cuda.sgm_accumulate`: `directions_for` order, each principal
pass adding into one accumulator, then each knight direction's p0 + p1
added once; `sgm_lane_cuda.fused_adj`: down, up, the left to right column
scan, the knights, then the right to left one), so a
distributed volume equals the single-device route's bit for bit.  Engines:

  * `distributed_sgm_fused_dhw` (4, 8 or 16 directions, any D): K2 for the
    horizontal directions, K2s relayed for the others
    (`sgm_cuda.sgm_shard_pass`, `sgm_knight_shard_pass`).  The left/right
    knights drift one row every two columns, so they cross row shards in
    mid-line; they run after an all-to-all to column shards, where they
    relay along columns (`_column_knight_stage`).  The port's knight parity
    is a run-time integer, so odd shard heights and column counts need no
    padding (the JAX package pads W to even per-shard widths and traces
    the parity for odd heights).  The name is the JAX function's; the port
    has no DHW layout.
  * `distributed_sgm` (4 directions): the same engine.
  * `distributed_sgm_fused` (4, 8 or 16 directions, any D): K4c relayed
    down and up (`sgm_lane_cuda.fused_rows_shard_pass`), then K4b's column
    scans on each shard; 16 directions add the knights before the last
    column scan, the down/up ones relayed over the row shards and the
    left/right ones over column shards, both through K2s.
  * `distributed_sgm_routed`: the single-device rule of `ops.sgm.sgm_route`,
    used by the pipelines of `parallel.stereo`: D <= 320 (or P2 < P1, on
    the plain dense-penalty passes) the K2s engine, D > 320 K4c where its
    carries fit (`sgm_lane_cuda.fused_fits`), else the K2s engine, which
    takes any D.

Every function takes and returns lists of shards; the result is float32.
"""

from __future__ import annotations

import torch

from ..ops import sgm_lane_cuda as lane
from ..ops.sgm import _KNIGHT_DIRS, directions_for, sgm_route
from ..ops.sgm_cuda import (kernel_volume, sgm_knight_shard_pass,
                            sgm_knight_shard_pass_plain, sgm_pass,
                            sgm_pass_plain, sgm_shard_pass,
                            sgm_shard_pass_plain)


def carry_relay(devices, run_pass, reverse: bool = False):
    """One relay over ``len(devices)`` shards: shard k runs ``run_pass(k,
    carries)`` at step k (n - 1 - k with ``reverse``) and returns its
    carries out, which move to the next shard's device.  The first shard
    gets None (zero line starts)."""
    n = len(devices)
    carries = None
    for k in (range(n - 1, -1, -1) if reverse else range(n)):
        if carries is not None:
            carries = carries.to(devices[k])
        carries = run_pass(k, carries)


def _row_offsets(shards):
    """(first global row of each shard, the image height)."""
    i0s, h = [], 0
    for x in shards:
        i0s.append(h)
        h += x.shape[0]
    return i0s, h


def _check_shards(shards):
    if not shards:
        raise ValueError("no shards")
    W, D = shards[0].shape[1:]
    if any(x.ndim != 3 or x.shape[1:] != (W, D) for x in shards):
        raise ValueError("row shards of one (W, D) volume")


def distributed_sgm_fused_dhw(shards, P1: float, P2: float,
                              Pout: float = 100.0,
                              n_directions: int = 8) -> list:
    """4-, 8- or 16-direction SGM over row shards: K2 for the horizontal
    directions, K2s relayed for the vertical, diagonal and knight ones (the
    plain versions for CPU tensors, and on either device for P2 < P1, as
    `ops.sgm.sgm_route` runs that case).  Equals the single-device
    `sgm_cost_volume` of the stacked volume (zero margins), bit for bit on
    the same device."""
    _check_shards(shards)
    P1, P2, Pout = float(P1), float(P2), float(Pout)
    dense = P2 < P1
    shard_pass = sgm_shard_pass_plain if dense else sgm_shard_pass
    knight_pass = sgm_knight_shard_pass_plain if dense else sgm_knight_shard_pass
    h_pass = sgm_pass_plain if dense else sgm_pass
    cvs = [kernel_volume(x) for x in shards]
    devs = [x.device for x in cvs]
    i0s, H_img = _row_offsets(cvs)
    accs = [torch.empty(x.shape, dtype=torch.float32, device=x.device)
            for x in cvs]
    # `directions_for` lists the knights after the principal directions
    principal = [d for d in directions_for(n_directions) if not d.knight]
    for k, d in enumerate(principal):
        if d.step[0] == 0:
            for m in range(len(cvs)):
                h_pass(cvs[m], accs[m], d, P1, P2, Pout, k > 0)
        else:
            def run(m, carry, d=d, k=k):
                return shard_pass(cvs[m], accs[m], d, P1, P2, Pout, k > 0,
                                  carry, i0s[m], H_img)
            carry_relay(devs, run, reverse=d.step[0] < 0)
    if n_directions >= 16:
        accs = _knight_stage(cvs, accs, P1, P2, Pout, knight_pass)
    return [x.float() + a for x, a in zip(cvs, accs)]


def distributed_sgm(shards, P1: float, P2: float,
                    Pout: float = 100.0) -> list:
    """4-direction SGM over row shards (the JAX package's `distributed_sgm`):
    K2 for the horizontal directions, K2s relayed for the vertical ones."""
    return distributed_sgm_fused_dhw(shards, P1, P2, Pout, n_directions=4)


def _column_split(W: int, n: int):
    """Balanced column ranges [j0, j1) of n column shards (empty ones
    dropped)."""
    sizes = [W // n + (1 if m < W % n else 0) for m in range(n)]
    out, j = [], 0
    for s in sizes:
        if s:
            out.append((j, j + s))
        j += s
    return out


def _column_knight_stage(cvs, accs, dirs, P1, P2, Pout, knight_pass):
    """The left/right knight directions: reshard the volume and the
    accumulator from row shards to column shards (an all-to-all: column
    shard m gathers columns [j0, j1) of every row shard onto row shard m's
    device), relay each direction across the column shards (carries: one
    D-vector per image row and seed phase; the shard's first image column
    gives the Pout test and the drift parity), and reshard the accumulator
    back."""
    devs = [x.device for x in cvs]
    i0s, H = _row_offsets(cvs)
    W = cvs[0].shape[1]
    cols = _column_split(W, len(cvs))
    col_devs = devs[:len(cols)]

    def to_cols(xs):
        return [torch.cat([x[:, j0:j1].to(dev) for x in xs])
                for (j0, j1), dev in zip(cols, col_devs)]

    cv_c, acc_c = to_cols(cvs), to_cols(accs)
    for d in dirs:
        def run(m, carries, d=d):
            j0 = cols[m][0]
            return knight_pass(cv_c[m], acc_c[m], d, P1, P2, Pout, carries,
                               j0, W, col0=j0, W_pout=W)
        carry_relay(col_devs, run, reverse=d.steps[0][1] < 0)
    return [torch.cat([a[i0:i0 + x.shape[0]].to(dev) for a in acc_c], dim=1)
            for x, i0, dev in zip(cvs, i0s, devs)]


def distributed_sgm_fused(shards, P1: float, P2: float, Pout: float = 100.0,
                          n_directions: int = 8) -> list:
    """4-, 8- or 16-direction SGM over row shards on the lane-layout
    kernels, any D: K4c down (relayed from the first shard) and up (relayed
    from the last), each carrying the vertical and both diagonal
    directions, then K4b's column scans on each shard; 16 directions add
    the knight directions (K2s) before the last column scan, as `fused_adj`
    adds them.  Equals the single-device lane route (`sgm_lane_cuda.
    fused_adj`) bit for bit on the same device."""
    _check_shards(shards)
    directions_for(n_directions)
    P1, P2, Pout = float(P1), float(P2), float(Pout)
    diag = n_directions >= 8
    cvs = [x.float().contiguous() for x in shards]
    devs = [x.device for x in cvs]
    i0s, H_img = _row_offsets(cvs)
    W = cvs[0].shape[1]
    kw = dict(col0=0, W_pout=W, P1=P1, P2=P2, Pout=Pout)
    adj = [None] * len(cvs)

    def sweep(reverse):
        def run(m, carries):
            adj[m], couts = lane.fused_rows_shard_pass(
                cvs[m], adj[m], carries, i0s[m], H_img, reverse, diag, **kw)
            return couts
        carry_relay(devs, run, reverse=reverse)

    sweep(False)
    sweep(True)
    for m, x in enumerate(cvs):
        lane.fused_cols_pass(x, adj[m], False, **kw)
    if n_directions >= 16:
        adj = _knight_stage(cvs, adj, P1, P2, Pout, sgm_knight_shard_pass)
    for m, x in enumerate(cvs):
        lane.fused_cols_pass(x, adj[m], True, **kw)
    return [x + a for x, a in zip(cvs, adj)]


def _knight_stage(cvs, accs, P1, P2, Pout, knight_pass):
    """The eight knight directions in `_KNIGHT_DIRS` order, added into the
    row shards' accumulators ``accs``: the down/up knights relayed over the
    row shards, then the left/right ones over column shards
    (`_column_knight_stage`).  Returns the accumulators."""
    devs = [x.device for x in cvs]
    i0s, H_img = _row_offsets(cvs)
    for d in _KNIGHT_DIRS:
        if d.steps[0][0] == 0:
            continue

        def run(m, carries, d=d):
            return knight_pass(cvs[m], accs[m], d, P1, P2, Pout, carries,
                               i0s[m], H_img)
        carry_relay(devs, run, reverse=d.steps[0][0] < 0)
    return _column_knight_stage(
        cvs, accs, [d for d in _KNIGHT_DIRS if d.steps[0][0] == 0], P1, P2,
        Pout, knight_pass)


def distributed_sgm_routed(shards, P1: float, P2: float, Pout: float = 100.0,
                           n_directions: int = 8) -> list:
    """The engine of the distributed pipelines, chosen by the single-device
    rule (`ops.sgm.sgm_route`): the K2s engine where the single device runs
    K2/K2k (or the plain dense-penalty passes), K4c where it runs the lane
    route and K4c's carries fit (`sgm_lane_cuda.fused_fits`, as
    `fused_adj` decides on one device), else the K2s engine, which takes
    any D."""
    _check_shards(shards)
    W, D = shards[0].shape[1:]
    route = sgm_route(D, n_directions, P1, P2, shards[0].is_cuda)
    if route == "lane" and lane.fused_fits(W, D, n_directions,
                                           n_sm=lane._sms(shards[0])):
        return distributed_sgm_fused(shards, P1, P2, Pout, n_directions)
    return distributed_sgm_fused_dhw(shards, P1, P2, Pout, n_directions)
