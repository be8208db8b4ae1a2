"""Semi-global matching as cost-volume smoothing (counterpart of
`libstevi_tpu/ops/sgm.py`, 4, 8 and 16 directions).

Reference parity: `correlation/sgm.h` — scanline directions as step-pair
traits (:57-155), the per-line DP recurrence with P1 (|delta d| = 1), P2
(|delta d| > 1), Pout (disparity index pointing out of the image:
``j + d >= W``), min-normalization by the previous pixel's best cost, and
per-direction accumulation ``sgm_cv += L_dir - cv_base`` (:298-404).  Line
starts follow `addDirectionalCost` (:329-355), so the diagonal line that
starts at the image corner is enumerated from both start edges and counts
twice.  The two documented deviations of the JAX package from the reference
(`libstevi_tpu/ops/sgm.py:14-22`: reverse lines start at the last in-bounds
pixel; the Cost-strategy inner loop uses the correct recurrence) are kept.

The plain PyTorch versions here walk each direction the way the TPU's
streaming kernels do: vertical and diagonal directions loop over image rows
with a (W, D) carry (a diagonal carry shifts one column per row, a zero
shifted in is a line start), horizontal directions loop over columns with
an (H, D) carry — O(H + W) vectorised steps per direction.  The eight
knight-move directions of the 16-direction set alternate two step vectors
(`sgm.h:112-155`); their lines come from `_build_lines` and run through
`_cost_mode_pass` (gather, scan along the lines, scatter-add), as in the
JAX package.  Which engine runs a configuration is `sgm_route`'s choice,
made from the configuration alone, as the JAX package chooses between its
Pallas kernels and its XLA groups (`libstevi_tpu/ops/sgm.py:333-352, 387`):
- P2 < P1: the plain steps with the dense D x D penalty, on either device
  (the O(D) min-shift of the kernels is exact only for P2 >= P1);
- D <= 320: K2, K2k and K3 on a CUDA tensor (`sgm_cuda.py`), their plain
  versions on the CPU;
- D > 320: the lane route, K4b (`sgm_lane_cuda.fused_adj`), and K4d
  (`chunked_adj`) where `fused_adj` returns None because its carries do
  not fit on chip, and their plain versions on the CPU; with 16
  directions the knight directions run through K2k's any-D instance
  (`sgm_cuda.knight_volumes`), as the JAX package runs them through
  `_cost_mode_pass` beside `_pallas_adj` (`libstevi_tpu/ops/sgm.py:387-414`).
  The lane route takes any D, as the JAX package's XLA path does: past a
  block's shared memory each of its kernels keeps its carries in a global
  area of its own (K4d past D = 11622, the WTA column scan past 14460,
  K2k's knights past 9640).
Every route adds a knight direction's adjustment to the principal sum once,
in `_KNIGHT_DIRS` order, as the JAX XLA path does.
"""

from __future__ import annotations

import enum
from functools import lru_cache

import numpy as np
import torch

from ..core.types import ExtractionStrategy, MATCH_TRAITS
from ..core.margins import Margins
from ..utils.profiling import count, span


class SgmDirection(enum.Enum):
    """(vertical step pair, horizontal step pair); traversal alternates the
    two entries (`sgm.h:214-216`: step c uses index c % 2)."""

    UP2DOWN = ((1, 1), (0, 0))
    DOWN2UP = ((-1, -1), (0, 0))
    LEFT2RIGHT = ((0, 0), (1, 1))
    RIGHT2LEFT = ((0, 0), (-1, -1))
    UPLEFT2DOWNRIGHT = ((1, 1), (1, 1))
    DOWNRIGHT2UPLEFT = ((-1, -1), (-1, -1))
    UPRIGHT2DOWNLEFT = ((1, 1), (-1, -1))
    DOWNLEFT2UPRIGHT = ((-1, -1), (1, 1))
    UPLEFT2RIGHT = ((0, 1), (1, 1))
    DOWNRIGHT2LEFT = ((0, -1), (-1, -1))
    UPRIGHT2LEFT = ((0, 1), (-1, -1))
    DOWNLEFT2RIGHT = ((0, -1), (1, 1))
    UPLEFT2DOWN = ((1, 1), (0, 1))
    DOWNRIGHT2UP = ((-1, -1), (0, -1))
    UPRIGHT2DOWN = ((1, 1), (0, -1))
    DOWNLEFT2UP = ((-1, -1), (0, 1))

    @property
    def step(self) -> tuple[int, int]:
        """(di, dj) of a principal (non-knight) direction."""
        (v0, v1), (h0, h1) = self.value
        if v0 != v1 or h0 != h1:
            raise ValueError(f"{self.name} is a knight-move direction: "
                             "use .steps")
        return v0, h0

    @property
    def steps(self) -> tuple[tuple[int, int], tuple[int, int]]:
        """The two (di, dj) steps a line alternates: step c of a line is
        ``steps[c % 2]``.  Both are equal for a principal direction."""
        (v0, v1), (h0, h1) = self.value
        return (v0, h0), (v1, h1)

    @property
    def knight(self) -> bool:
        s0, s1 = self.steps
        return s0 != s1


_KNIGHT_DIRS = [SgmDirection.UPLEFT2DOWN, SgmDirection.DOWNRIGHT2UP,
                SgmDirection.UPRIGHT2DOWN, SgmDirection.DOWNLEFT2UP,
                SgmDirection.UPLEFT2RIGHT, SgmDirection.DOWNRIGHT2LEFT,
                SgmDirection.UPRIGHT2LEFT, SgmDirection.DOWNLEFT2RIGHT]


def directions_for(n_directions: int):
    if n_directions not in (4, 8, 16):
        raise ValueError("SGM operates with 4, 8 or 16 directions")
    dirs = [SgmDirection.UP2DOWN, SgmDirection.DOWN2UP,
            SgmDirection.LEFT2RIGHT, SgmDirection.RIGHT2LEFT]
    if n_directions >= 8:
        dirs += [SgmDirection.UPLEFT2DOWNRIGHT, SgmDirection.DOWNRIGHT2UPLEFT,
                 SgmDirection.UPRIGHT2DOWNLEFT, SgmDirection.DOWNLEFT2UPRIGHT]
    if n_directions >= 16:
        dirs += _KNIGHT_DIRS
    return dirs


# ---------------------------------------------------------------------------
# Plain DP
# ---------------------------------------------------------------------------

def _dp_step(prev: torch.Tensor, base: torch.Tensor, pout: torch.Tensor,
             P1: float, P2: float):
    """One DP step of the cost-mode recurrence on (..., D) lines
    (`sgm.h:230-300`; the JAX `_line_recurrence` op for op).  ``pout`` holds
    Pout where the disparity leaves the image and 0 elsewhere.  Returns
    (cur, adj) with cur = base + adj the new carry."""
    inf = float("inf")
    prevf = torch.where(torch.isfinite(prev), prev, inf)
    m = prevf.amin(-1, keepdim=True)
    if P2 >= P1:
        pad = torch.full_like(prevf[..., :1], inf)
        left = torch.cat([pad, prevf[..., :-1]], -1)
        right = torch.cat([prevf[..., 1:], pad], -1)
        agg = torch.minimum(torch.minimum(prevf, m + P2),
                            torch.minimum(left + P1, right + P1))
    else:
        # dense penalty matrix: the O(D) min-shift is exact only if P2 >= P1
        dd = torch.arange(prev.shape[-1], device=prev.device)
        delta = (dd[:, None] - dd[None, :]).abs()
        pen = torch.where(delta == 1, P1, torch.where(delta > 1, P2, 0.0))
        agg = (prevf[..., None, :] + pen).amin(-1)
    agg = agg + pout
    adj = torch.where(torch.isfinite(agg) & torch.isfinite(m), agg - m, 0.0)
    return base + adj, adj


def direction_adj(cv: torch.Tensor, direction: SgmDirection, P1: float,
                  P2: float, Pout: float, col0: int = 0,
                  W_pout: int | None = None) -> torch.Tensor:
    """One principal direction's adjustment ``L_dir - cv`` over an
    (H, W, D) float32 region, the corner line counted twice.  ``col0`` is
    the image column of the region's first column and ``W_pout`` the image
    width (default ``col0 + W``), for the Pout test ``j + d >= W``
    (non-zero margins)."""
    return direction_shard_adj(cv, direction, P1, P2, Pout, col0, W_pout)[0]


def direction_shard_adj(cv: torch.Tensor, direction: SgmDirection,
                        P1: float, P2: float, Pout: float, col0: int = 0,
                        W_pout: int | None = None,
                        carry: torch.Tensor | None = None, i0: int = 0,
                        H_img: int | None = None):
    """`direction_adj` on rows [i0, i0 + H) of an image ``H_img`` rows
    high (default: the whole image): a vertical or diagonal direction
    starts from ``carry`` (W, D), the previous shard's post-step carries of
    its last scan row (None: zeros, the line start), and the corner line
    keys on the global row.  Returns (adj, the carry after the last scan
    row); horizontal directions take no carry and return None for it."""
    H, W, D = cv.shape
    W_pout = col0 + W if W_pout is None else W_pout
    H_img = i0 + H if H_img is None else H_img
    di, dj = direction.step
    dd = torch.arange(D, device=cv.device)
    adj = torch.empty_like(cv)
    if di == 0:                        # horizontal: scan columns
        if carry is not None:
            raise ValueError("a horizontal direction takes no row carry")
        carry = cv.new_zeros((H, D))
        for j in (range(W) if dj > 0 else range(W - 1, -1, -1)):
            pout = torch.where(col0 + j + dd >= W_pout, Pout, 0.0)
            carry, adj[:, j] = _dp_step(carry, cv[:, j], pout, P1, P2)
        return adj, None
    jj = col0 + torch.arange(W, device=cv.device)
    pout = torch.where(jj[:, None] + dd >= W_pout, Pout, 0.0)
    carry = cv.new_zeros((W, D)) if carry is None else carry.float()
    zero = cv.new_zeros((1, D))
    je = 0 if dj > 0 else W - 1
    for i in (range(H) if di > 0 else range(H - 1, -1, -1)):
        if dj > 0:                     # (i, j) continues the line of (i - di, j - 1)
            carry = torch.cat([zero, carry[:-1]])
        elif dj < 0:                   # ... of (i - di, j + 1)
            carry = torch.cat([carry[1:], zero])
        carry, adj[i] = _dp_step(carry, cv[i], pout, P1, P2)
        if dj != 0:
            # the line from the corner start is enumerated from both edges:
            # it passes global row ig at column je + dj * (steps from the
            # global start row)
            ig = i0 + i
            cj = je + dj * (ig if di > 0 else H_img - 1 - ig)
            if 0 <= cj < W:
                adj[i, cj] = adj[i, cj] * 2.0
    return adj, carry


@lru_cache(maxsize=32)  # bounded: maps are O((H+W)*line_len) per key
def _build_lines(H: int, W: int, margins: tuple, direction: SgmDirection):
    """Static (lines, steps) index maps for one direction, following
    `addDirectionalCost`'s start enumeration (`sgm.h:329-355`): numpy
    (ii, jj, active) of shape (lines, max length), padded steps repeating a
    line's last pixel.  The JAX package's `_build_lines`, verbatim."""
    ml, mt, mr, mb = margins
    sv, sh = direction.value
    starts = []
    if sh != (0, 0):
        sj = ml if (sh[0] >= 0 and sh[1] >= 0) else W - mr - 1
        for si in range(mt, H - mb):
            starts.append((si, sj))
    if sv != (0, 0):
        si = mt if (sv[0] >= 0 and sv[1] >= 0) else H - mb - 1
        for sj in range(ml, W - mr):
            starts.append((si, sj))

    lines = []
    max_len = 0
    for (si, sj) in starts:
        i, j, c = si, sj, 0
        coords = []
        while mt <= i < H - mb and ml <= j < W - mr:
            coords.append((i, j))
            i += sv[c % 2]
            j += sh[c % 2]
            c += 1
        if coords:
            lines.append(coords)
            max_len = max(max_len, len(coords))

    L = len(lines)
    ii = np.zeros((L, max_len), np.int32)
    jj = np.zeros((L, max_len), np.int32)
    active = np.zeros((L, max_len), bool)
    for k, coords in enumerate(lines):
        n = len(coords)
        arr = np.asarray(coords, np.int32)
        ii[k, :n] = arr[:, 0]
        jj[k, :n] = arr[:, 1]
        active[k, :n] = True
        ii[k, n:] = arr[-1, 0]
        jj[k, n:] = arr[-1, 1]
    return ii, jj, active


def _cost_mode_pass(cv: torch.Tensor, ii, jj, active, P1: float, P2: float,
                    Pout: float, col0: int = 0,
                    W_pout: int | None = None) -> torch.Tensor:
    """One direction's adjustment over an (H, W, D) float32 volume from its
    line maps: gather the lines, run `_dp_step` along them, scatter-add
    back (a pixel on two lines, or on the corner line enumerated twice,
    gets both contributions).  ``col0`` and ``W_pout`` as in
    `direction_adj`."""
    H, W, D = cv.shape
    W_pout = col0 + W if W_pout is None else W_pout
    ii_t = torch.from_numpy(ii).long().to(cv.device)
    jj_t = torch.from_numpy(jj).long().to(cv.device)
    act = torch.from_numpy(active).to(cv.device)
    lines = cv[ii_t, jj_t]                                   # (L, T, D)
    L, T = ii_t.shape
    dd = torch.arange(D, device=cv.device)
    carry = cv.new_zeros((L, D))
    adjs = torch.empty_like(lines)
    for t in range(T):
        pout = torch.where(col0 + jj_t[:, t, None] + dd >= W_pout, Pout, 0.0)
        cur, adj = _dp_step(carry, lines[:, t], pout, P1, P2)
        v = act[:, t, None]
        carry = torch.where(v, cur, 0.0)
        adjs[:, t] = torch.where(v, adj, 0.0)
    out = cv.new_zeros((H, W, D))
    return out.index_put_((ii_t.reshape(-1), jj_t.reshape(-1)),
                          adjs.reshape(L * T, D), accumulate=True)


def knight_adj(cv: torch.Tensor, direction: SgmDirection, P1: float,
               P2: float, Pout: float, col0: int = 0,
               W_pout: int | None = None) -> torch.Tensor:
    """One knight direction's adjustment over an (H, W, D) float32 region;
    ``col0`` and ``W_pout`` as in `direction_adj`."""
    H, W, _ = cv.shape
    ii, jj, active = _build_lines(H, W, (0, 0, 0, 0), direction)
    if ii.size == 0:
        return torch.zeros_like(cv)
    return _cost_mode_pass(cv, ii, jj, active, P1, P2, Pout, col0, W_pout)


def _grouped_adj(region, P1, P2, Pout, n_directions, col0, W_pout):
    """Sum of the direction adjustments, grouped as the JAX XLA path sums
    them (horizontal pair + vertical pair, then the diagonal pairs)."""
    def a(d):
        return direction_adj(region, d, P1, P2, Pout, col0, W_pout)
    S = SgmDirection
    adj = ((a(S.LEFT2RIGHT) + a(S.RIGHT2LEFT))
           + (a(S.UP2DOWN) + a(S.DOWN2UP)))
    if n_directions >= 8:
        adj = adj + ((a(S.UPLEFT2DOWNRIGHT) + a(S.DOWNRIGHT2UPLEFT))
                     + (a(S.UPRIGHT2DOWNLEFT) + a(S.DOWNLEFT2UPRIGHT)))
    return adj


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def sgm_route(D: int, n_directions: int, P1: float, P2: float,
              cuda: bool) -> str:
    """The engine that runs the principal directions of an SGM call (see
    the module docstring): 'dense' (P2 < P1, plain torch ops on either
    device, no kernel), 'scan' (K2/K2k/K3, or their plain versions on the
    CPU) or 'lane' (K4b, else K4d: `_lane_adj`; with 16 directions, K2k's
    any-D instance for the knights; any D, each kernel's carries in global
    memory past a block's shared memory).  The choice comes from the
    configuration alone and is the same on both devices; ``cuda`` is kept
    for the callers' symmetry."""
    from .sgm_cuda import MAX_D
    if n_directions not in (4, 8, 16):
        raise ValueError("SGM operates with 4, 8 or 16 directions")
    if P2 < P1:
        return "dense"
    return "scan" if D <= MAX_D else "lane"


def _lane_adj(region, col0, W_pout, P1, P2, Pout, n_directions,
              wta_radius=None):
    """K4b, and K4d where `fused_adj` refuses the width (as
    `_pallas_adj` takes `sgm_fused_adj`, then `sgm_chunked_adj`); with 16
    directions both run the knight directions (K2k) before their last
    column scan, which sums their 8 volumes where they fit (else they are
    added in place first: the same bits).  With ``wta_radius`` the last
    scan is the WTA scan and the result is (idx, bands).  The form counts
    in ``form.lane_fused`` or ``form.lane_chunked``."""
    from .sgm_lane_cuda import chunked_adj, fused_adj
    res = fused_adj(region, col0, W_pout, P1, P2, Pout, n_directions,
                    wta_radius=wta_radius)
    count("form.lane_chunked" if res is None else "form.lane_fused")
    if res is None:
        res = chunked_adj(region, col0, W_pout, P1, P2, Pout, n_directions,
                          wta_radius=wta_radius)
    return res


def _region(cv: torch.Tensor, margins: Margins) -> torch.Tensor:
    H, W = cv.shape[:2]
    return cv[margins.top:H - margins.bottom, margins.left:W - margins.right]


def sgm_cost_volume(cv: torch.Tensor, P1: float, P2: float,
                    margins: Margins = Margins(), Pout: float = 100.0,
                    n_directions: int = 8,
                    strategy: ExtractionStrategy = ExtractionStrategy.COST
                    ) -> torch.Tensor:
    """Aggregate an (H, W, D) cost volume along 4/8/16 scanline directions
    (`sgmCostVolume`, `sgm.h:361-404`) inside ``margins``; the volume
    outside them is returned unchanged.  Returns float32.  SCORE volumes
    run the cost-mode engine on the negated volume.  On a CUDA tensor the
    region runs contiguous through one K2 launch per principal direction
    and the knight directions' volumes (two K2k launches), added after them
    one by one (`sgm_cuda.sgm_accumulate`), and is padded back.  On the
    CPU the sums follow the JAX XLA path: the principal directions
    grouped, then each knight pass in `_KNIGHT_DIRS` order, each padded to
    the full volume.  At D > 320 both devices run `sgm_lane_cuda`'s K4b or
    K4d route (16 directions: with the knight passes of K2k's any-D
    instance), and P2 < P1 the plain dense-penalty steps (`sgm_route`)."""
    if n_directions not in (4, 8, 16):
        raise ValueError("SGM operates with 4, 8 or 16 directions")
    if strategy is ExtractionStrategy.SCORE:
        return -sgm_cost_volume(-cv, P1, P2, margins, Pout, n_directions,
                                ExtractionStrategy.COST)
    P1, P2, Pout = float(P1), float(P2), float(Pout)
    H, W, D = cv.shape
    ml, mt, mr, mb = margins.left, margins.top, margins.right, margins.bottom
    region = _region(cv, margins)
    if region.shape[0] == 0 or region.shape[1] == 0:
        return cv.float()

    def pad(adj):
        return torch.nn.functional.pad(adj, (0, 0, ml, mr, mt, mb))

    route = sgm_route(D, n_directions, P1, P2, cv.is_cuda)
    if route == "scan" and cv.is_cuda:
        from .sgm_cuda import sgm_accumulate
        adj = sgm_accumulate(region, directions_for(n_directions), P1, P2,
                             Pout, ml, W)
        return cv.float() + pad(adj)
    if route == "lane":
        return cv.float() + pad(_lane_adj(region, ml, W, P1, P2, Pout,
                                          n_directions))
    region = region.float()
    sgm = cv.float() + pad(_grouped_adj(region, P1, P2, Pout, n_directions,
                                        ml, W))
    if n_directions >= 16:
        for direction in _KNIGHT_DIRS:
            sgm = sgm + pad(knight_adj(region, direction, P1, P2, Pout, ml, W))
    return sgm


def _tcv_from_bands(idx, bands, H, W, D, h_radius, v_radius, r):
    """Assemble the SAME-mode truncated cost volume from the fused WTA
    kernel's (idx, bands) maps: out-of-range / margin-clipped slots go
    NaN, matching `truncated_cost_volume` (`correlation_base.h:582-674`)."""
    from .cost_volume import same_slot_valid
    from ..core.types import disp_dtype
    slots = [torch.where(same_slot_valid(idx + (k - r), H, W, D, h_radius,
                                         v_radius), bands[..., k],
                         float("nan"))
             for k in range(2 * r + 1)]
    return idx.to(disp_dtype), torch.stack(slots, dim=-1)


def wta_bands(C: torch.Tensor, r: int):
    """Tie-last argmin of an (H, W, D) COST volume and the band
    C[idx - r .. idx + r] (+inf outside [0, D)): what K3 emits."""
    from .cost_volume import extract_selected_index
    idx = extract_selected_index(C, ExtractionStrategy.COST)
    Cp = torch.nn.functional.pad(C, (r, r), value=float("inf"))
    bands = torch.stack([torch.gather(Cp, -1, (idx.long() + k)[..., None])[..., 0]
                         for k in range(2 * r + 1)], dim=-1)
    return idx, bands


def sgm_wta_truncated(cv: torch.Tensor, P1: float, P2: float,
                      margins: Margins = Margins(), Pout: float = 100.0,
                      n_directions: int = 8,
                      strategy: ExtractionStrategy = ExtractionStrategy.COST,
                      h_radius: int = 0, v_radius: int = 0,
                      cost_vol_radius: int = 1):
    """The chain ``sgm_cost_volume`` -> ``extract_selected_index`` ->
    ``truncated_cost_volume`` (SAME mode).  Returns ``(selected_index,
    truncated_cv)``; the truncated volume is in COST orientation (for SCORE
    inputs it holds the negated SGM scores).  Without margins the WTA and
    the band come out of the last SGM pass: on a CUDA tensor at D <= 320,
    K2 and K2k launches, then K3; on the lane route (both devices), the
    WTA column scan `fused_cols_wta` after K4b's or K4d's sweeps (16
    directions: the WTA scan sums the knight volumes as it reads them, or
    they are added to its accumulator first).  Elsewhere (margins, P2 <
    P1) both devices run the chain itself, as the JAX package does
    (`libstevi_tpu/ops/sgm.py:571-600`).  The route (`sgm_route`) counts
    in ``route.<route>``."""
    route = sgm_route(cv.shape[-1], n_directions, P1, P2, cv.is_cuda)
    count("route." + route)
    return _wta_truncated(route, cv, P1, P2, margins, Pout, n_directions,
                          strategy, h_radius, v_radius, cost_vol_radius)


def _wta_truncated(route, cv, P1, P2, margins, Pout, n_directions, strategy,
                   h_radius, v_radius, cost_vol_radius):
    """`sgm_wta_truncated` on the route `sgm_route` gave."""
    from .cost_volume import extract_selected_index, truncated_cost_volume
    H, W, D = cv.shape
    r = cost_vol_radius
    if margins == Margins() and H and W:
        res = None
        if (route == "scan" and cv.is_cuda) or route == "lane":
            vol = cv if strategy is ExtractionStrategy.COST else -cv
            P = (float(P1), float(P2), float(Pout))
            if route == "scan":
                from .sgm_cuda import sgm_wta_fused
                res = sgm_wta_fused(vol, *P, n_directions, r, h_radius,
                                    v_radius, refine=False)[:2]
            else:
                res = _lane_adj(vol, 0, W, *P, n_directions, wta_radius=r)
        if res is not None:
            with span("stevi.bands"):
                return _tcv_from_bands(res[0], res[1], H, W, D, h_radius,
                                       v_radius, r)
    sgm = sgm_cost_volume(cv, P1, P2, margins, Pout, n_directions, strategy)
    idx = extract_selected_index(sgm, strategy)
    vol = sgm if strategy is ExtractionStrategy.COST else -sgm
    tcv = truncated_cost_volume(vol, idx, h_radius, v_radius, r)
    return idx, tcv


def _k1_dtype(cv_dtype, n_directions: int):
    """The dtype K1 stores the volume in: bfloat16 where asked, except
    with 16 directions (the JAX package's TPU rule), else float32."""
    if cv_dtype == torch.bfloat16 and n_directions < 16:
        return torch.bfloat16
    return torch.float32


def dense_sgm_buffers(img_l: torch.Tensor, disp_width: int,
                      n_directions: int = 8, cv_dtype=torch.float32) -> dict:
    """``volume`` and ``k2`` for `dense_sgm_stereo` on the K1 + scan route:
    K1's (H, W, D) volume and K2's buffer, a float32 volume for each
    direction but the last where `sgm_cuda._one_launch` fits them (its one
    ``cudaMemGetInfo``, with the volume allocated, as in an eager frame),
    else one float32 accumulator.  They are the tensors live at an eager
    frame's peak."""
    from .sgm_cuda import _one_launch
    H, W = img_l.shape
    shape = (H, W, int(disp_width))
    volume = torch.empty(shape, dtype=_k1_dtype(cv_dtype, n_directions),
                         device=img_l.device)
    n = n_directions - 1
    stack = (n,) if _one_launch(volume, n) else ()
    return {"volume": volume,
            "k2": torch.empty(stack + shape, dtype=torch.float32,
                              device=img_l.device)}


def dense_sgm_stereo(func, img_l: torch.Tensor, img_r: torch.Tensor,
                     h_radius: int, v_radius: int, disp_width: int,
                     P1: float, P2: float, *, Pout: float = 100.0,
                     n_directions: int = 8, cost_vol_radius: int = 1,
                     refine_kernel=None, cv_dtype=torch.float32,
                     volume: torch.Tensor | None = None,
                     k2: torch.Tensor | None = None):
    """Dense SGM stereo end-to-end: cost volume -> 4/8/16-direction SGM ->
    tie-last WTA -> truncated band -> optional cost-based subpixel (the
    dense hot loop of `examples/stereo-match/main.cpp:234-258`).

    For a dot-family cost on gray images with P2 >= P1 and D <= 320 this
    runs the kernel path K1 -> K2 (every principal direction but the last:
    one launch, a volume each, where they fit, else a launch each) -> K2k
    (16 directions: two launches, a volume each) -> K3 (the last direction
    fused with the in-order sum of those volumes, WTA, band and, for
    PARABOLA, the subpixel).  At D > 320 it runs K1 (one launch) ->
    ``sgm_wta_truncated`` (K4b's or K4d's sweeps, then K4b's column scans
    ending in the WTA scan; K2k for 16 directions) -> refinement in torch.
    CENSUS on gray images takes the same path with the census kernel
    (`census_cuda.census_cv`: the words, then the Hamming volume) in K1's
    place.  Other costs, multichannel images and P2 < P1 take the JAX
    package's general route: ``unfold_based_cost_volume`` (the box route,
    or unfold with K5 where `aggregate_cost` launches it, the census
    kernel for CENSUS on CUDA and the shifted-compare loop for Hamming)
    -> ``sgm_wta_truncated`` -> refinement.  On the CPU every
    kernel wrapper runs its plain version.  16 directions at D > 320 add
    the knight passes (K2k's any-D instance) to the lane route.  The
    volume is stored in ``cv_dtype`` (float32 or
    bfloat16) and the DP runs in float32; a bfloat16 request with 16
    directions builds a float32 volume, the JAX package's TPU rule
    (`libstevi_tpu/ops/sgm.py:477-478`).

    ``volume`` and ``k2`` (`dense_sgm_buffers`) are preallocated tensors
    that K1 (or the census kernel) and K2 write in place of their own on
    the K1 or census + scan route (the same bits; other routes refuse
    them): a caller that holds them, as a captured CUDA graph does, keeps
    the frame's peak allocated.

    The call is the span ``stevi.dense_sgm_stereo`` (`utils.profiling.span`),
    with its stages' spans inside: ``stevi.k1`` (or ``stevi.census``),
    ``stevi.route``, ``stevi.k2`` and ``stevi.k3`` (scan) or ``stevi.k4d``
    and ``stevi.k4b`` (lane), ``stevi.bands``, ``stevi.refine``; its route
    counts in ``route.<route>``.

    Returns ``(disp, idx, tcv)``: refined disparity (H, W) float32 (equal
    to ``idx`` when ``refine_kernel`` is None), the raw WTA index map, and
    the truncated cost volume (COST orientation)."""
    with span("stevi.dense_sgm_stereo"):
        from .cost_volume import kernel_cost_volume, volume_kernel
        from .refinement import (InterpolationKernel,
                                 refine_disp_cost_interpolation)
        strategy = MATCH_TRAITS[func].strategy
        H, W = img_l.shape[:2]
        D = int(disp_width)
        r = cost_vol_radius
        if n_directions >= 16:
            cv_dtype = torch.float32
        route = sgm_route(D, n_directions, P1, P2, img_l.is_cuda)
        count("route." + route)
        picked = None if route == "dense" else volume_kernel(
            func, img_l, D, cv_dtype=_k1_dtype(cv_dtype, n_directions))
        if (volume is not None or k2 is not None) and not (
                picked is not None and route == "scan"):
            raise ValueError("dense_sgm_stereo: volume and k2 serve the "
                             "K1 + scan route (or the census kernel's) "
                             "only")

        if picked is not None:
            cv = kernel_cost_volume(
                picked[0], func, img_l, img_r, h_radius, v_radius, D,
                _k1_dtype(cv_dtype, n_directions),
                negate=strategy is ExtractionStrategy.SCORE, out=volume)
            if route == "scan":
                from .sgm_cuda import sgm_wta_fused
                fuse_refine = (refine_kernel is InterpolationKernel.PARABOLA
                               and r >= 1)
                idx, bands, disp = sgm_wta_fused(cv, float(P1), float(P2),
                                                 float(Pout), n_directions, r,
                                                 h_radius, v_radius,
                                                 fuse_refine, acc=k2)
                with span("stevi.bands"):
                    idx, tcv = _tcv_from_bands(idx, bands, H, W, D,
                                               h_radius, v_radius, r)
                if fuse_refine:
                    return disp, idx, tcv
            else:
                idx, tcv = _wta_truncated(
                    route, cv, P1, P2, Margins(), Pout, n_directions,
                    ExtractionStrategy.COST, h_radius, v_radius, r)
        else:
            from .cost_volume import unfold_based_cost_volume
            cv = unfold_based_cost_volume(func, img_l, img_r, h_radius,
                                          v_radius, D, cv_dtype=cv_dtype)
            idx, tcv = _wta_truncated(
                route, cv, P1, P2, Margins(), Pout, n_directions, strategy,
                h_radius, v_radius, r)
        if refine_kernel is None:
            return idx.float(), idx, tcv
        with span("stevi.refine"):
            disp = refine_disp_cost_interpolation(refine_kernel, tcv, idx)
        return disp, idx, tcv
