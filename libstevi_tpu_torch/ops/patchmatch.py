"""PatchMatch stereo (1-D) and image-flow (2-D) correspondence search,
counterpart of `libstevi_tpu/ops/patchmatch.py`.

Reference parity: `correlation/patchmatch.h` — `randomDispInit` (:58 uniform
init over the search range), `patchMatchTestCost` (:168; ties ACCEPT the
candidate), `patchMatchPropagate` (:373: per-iteration direction cycling
over the four diagonal sweeps, row scans then column scans, each sequential
along its axis and parallel across lines), `patchMatchSearch` (:234:
nRandomSearch uniform candidates scaled toward the current solution by
(k+1)/(nSearch+1), forced off the current value), `patchMatchImpl` (:450).

Two backends, as in the JAX package:
  * 'cv' (`_patch_match_stereo_cv`): the reference's CACHED on-demand volume
    semantics (`on_demand_cost_volume.h:330`): the dense cost volume is
    built once and propagation runs as sweeps (K6) and candidate probes (K7)
    over it (`patchmatch_cuda`);
  * 'scan' (cacheless): costs recomputed per evaluation from normalized
    feature volumes; sweeps are Python loops carrying the updated line.
Both accept ties and reject invalid candidates before comparison
(`patchmatch.h:199-218`).  Candidates come from a `torch.Generator` (or an
injected ``draw``), so parity with the JAX package is statistical (the
same convergence quality), not bitwise, unless both replay one stream.
2-D PatchMatch (`patch_match_flow`) is cacheless: its sweeps are Python
loops of torch ops carrying the updated line, as they are `lax.scan`s in
the JAX package, on either device.
"""

from __future__ import annotations

import torch

from ..core.types import (MatchingFunction, MATCH_TRAITS, ExtractionStrategy,
                          disp_dtype)
from ..core.search import SearchOffset1, SearchOffset2
from .matching import feature_comparison
from .patchmatch_cuda import (probe, scaled_candidate as _scaled_candidate,
                              search_probe, sweep)

_INF = float("inf")


def _better(traits, cand_cost, cur_cost):
    """Candidate acceptance: ties accept (`patchmatch.h:210-218`)."""
    if traits.strategy is ExtractionStrategy.SCORE:
        return cand_cost >= cur_cost
    return cand_cost <= cur_cost


def _drawer(generator: torch.Generator | None, device):
    """``draw(shape, low, high)``: int32 uniform draws in [low, high) from
    ``generator`` (a fresh one seeded 0 when None) on ``device``."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(0)

    def draw(shape, low, high):
        return torch.randint(low, high, tuple(shape), generator=generator,
                             device=device, dtype=torch.int32)
    return draw


class _StereoEval:
    """cost(i, j, d) = compare(source[i, j], target[i, j + d]); invalid
    target positions evaluate to None in the reference (candidate rejected)
    — here a worst-cost sentinel.  Lookups are exact gathers (the JAX
    package's one-hot matmul is a TPU device)."""

    def __init__(self, func, source_fv, target_fv):
        self.func = func
        self.traits = MATCH_TRAITS[func]
        self.source = source_fv
        self.target = target_fv
        self.worst = (_INF if self.traits.strategy is ExtractionStrategy.COST
                      else -_INF)

    def cost_cols(self, j: int, d_col: torch.Tensor) -> torch.Tensor:
        """Costs for one column j of source pixels with per-row disparities
        d_col (H,)."""
        H, W, _ = self.target.shape
        tgt_j = j + d_col
        inb = (tgt_j >= 0) & (tgt_j < W)
        tj = tgt_j.clamp(0, W - 1).long()
        tgt = self.target[torch.arange(H, device=tj.device), tj]   # (H, F)
        c = feature_comparison(self.func, self.source[:, j, :], tgt)
        return torch.where(inb, c, self.worst)

    def cost_row(self, i: int, d_row: torch.Tensor) -> torch.Tensor:
        """Costs for one row i of source pixels with per-column disparities
        d_row (W,)."""
        W = self.target.shape[1]
        tgt_j = torch.arange(W, device=d_row.device) + d_row
        inb = (tgt_j >= 0) & (tgt_j < W)
        tgt = self.target[i][tgt_j.clamp(0, W - 1).long()]          # (W, F)
        c = feature_comparison(self.func, self.source[i], tgt)
        return torch.where(inb, c, self.worst)

    def cost_field(self, d: torch.Tensor) -> torch.Tensor:
        """Costs for a full (H, W) disparity field."""
        H, W, F = self.target.shape
        tgt_j = torch.arange(W, device=d.device)[None, :] + d
        inb = (tgt_j >= 0) & (tgt_j < W)
        tj = tgt_j.clamp(0, W - 1).long()
        tgt = torch.gather(self.target, 1, tj[..., None].expand(H, W, F))
        c = feature_comparison(self.func, self.source, tgt)
        return torch.where(inb, c, self.worst)


def _row_sweep(ev: _StereoEval, disp, cost, forward: bool):
    """Sequential propagation along columns, all rows in parallel: pixel
    (i, j) tests the (already updated) disparity of (i, j -+ 1)."""
    W = disp.shape[1]
    disp, cost = disp.clone(), cost.clone()
    changes = torch.zeros((), dtype=torch.int64, device=disp.device)
    for j in (range(1, W) if forward else range(W - 2, -1, -1)):
        prev_d = disp[:, j - 1 if forward else j + 1]
        cand_cost = ev.cost_cols(j, prev_d)
        accept = _better(ev.traits, cand_cost, cost[:, j])
        disp[:, j] = torch.where(accept, prev_d, disp[:, j])
        cost[:, j] = torch.where(accept, cand_cost, cost[:, j])
        changes += accept.sum()
    return disp, cost, changes


def _col_sweep(ev: _StereoEval, disp, cost, forward: bool):
    """Sequential propagation along rows, all columns in parallel."""
    H = disp.shape[0]
    disp, cost = disp.clone(), cost.clone()
    changes = torch.zeros((), dtype=torch.int64, device=disp.device)
    for i in (range(1, H) if forward else range(H - 2, -1, -1)):
        prev_d = disp[i - 1 if forward else i + 1]
        cand_cost = ev.cost_row(i, prev_d)
        accept = _better(ev.traits, cand_cost, cost[i])
        disp[i] = torch.where(accept, prev_d, disp[i])
        cost[i] = torch.where(accept, cand_cost, cost[i])
        changes += accept.sum()
    return disp, cost, changes


def _random_search(ev: _StereoEval, disp, cost, search: SearchOffset1,
                   n_random: int, draw):
    """Geometric-decay random probes (`patchMatchSearch`,
    `patchmatch.h:234-366`)."""
    for k in range(n_random):
        cand = _scaled_candidate(draw(disp.shape, search.lower,
                                      search.upper + 1), disp, k, n_random)
        cand_cost = ev.cost_field(cand)
        # the +1 nudge (and geometric rounding) can leave the search range:
        # reject out-of-range candidates before the tie-accepting compare
        in_rng = (cand >= search.lower) & (cand <= search.upper)
        cand_cost = torch.where(in_rng, cand_cost, ev.worst)
        accept = in_rng & _better(ev.traits, cand_cost, cost)
        disp = torch.where(accept, cand, disp)
        cost = torch.where(accept, cand_cost, cost)
    return disp, cost


# the four diagonal sweep direction pairs, cycled per iteration
# (`utils/propagation_direction.h:27-90`): (row forward?, col forward?)
_SWEEP_DIRS = [(True, True), (False, True), (True, False), (False, False)]


def cost_oriented_volume(func: MatchingFunction, cv: torch.Tensor,
                         lower: int) -> torch.Tensor:
    """The (H, W, D) float32 volume K6 and K7 read: ``cv`` for COST
    functions, ``-cv`` for SCORE ones, +inf where the target column
    j + lower + d lies outside [0, W)."""
    W, D = cv.shape[1], cv.shape[2]
    costc = cv.float()
    if MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE:
        costc = -costc
    tgt = (torch.arange(W, device=cv.device)[:, None] + lower
           + torch.arange(D, device=cv.device)[None, :])
    return torch.where((tgt >= 0) & (tgt < W), costc, _INF).contiguous()


def _patch_match_stereo_cv(func, source_fv, target_fv, search: SearchOffset1,
                           n_iter: int, n_random: int,
                           generator: torch.Generator | None = None,
                           cv: torch.Tensor | None = None, draw=None):
    """CV-backed path: the reference's *cached* on-demand volume semantics
    (`on_demand_cost_volume.h:330`): costs computed once, sweeps by K6,
    init and random search by K7.  ``cv`` is a precomputed (H, W, D)
    volume over ``search`` (else it is aggregated from the feature
    volumes); ``draw(shape, low, high)`` replaces the generator's uniform
    int32 draws (it lets a test replay another candidate stream)."""
    from .cost_volume import aggregate_cost
    if cv is None:
        # aggregate_cost's RIGHT_TO_LEFT roles: fv_r = source, fv_l = target
        cv = aggregate_cost(func, target_fv, source_fv, search)
    H, W = cv.shape[:2]
    lower, upper = search.lower, search.upper
    if draw is None:
        draw = _drawer(generator, cv.device)
    costc = cost_oriented_volume(func, cv, lower)

    disp = draw((H, W), lower, upper + 1)
    # init: probe against +inf adopts each pixel's own (finite) cost
    disp, cost = probe(costc, disp, disp,
                       torch.full((H, W), _INF, device=cv.device), lower)
    for it in range(n_iter):
        row_fwd, col_fwd = _SWEEP_DIRS[it % 4]
        disp, cost = sweep(costc, disp, cost, lower, 1, not row_fwd)
        disp, cost = sweep(costc, disp, cost, lower, 0, not col_fwd)
        if n_random:
            # all candidate fields are formed from the pre-probe disparity
            # and tried in order in one K7 launch, as the JAX package does;
            # the kernel scales the raw draws itself
            draws = [draw((H, W), lower, upper + 1) for _ in range(n_random)]
            disp, cost = search_probe(costc, torch.stack(draws), disp, cost,
                                      lower, n_random)
    return disp.to(disp_dtype)


def patch_match_stereo(func: MatchingFunction, source_fv: torch.Tensor,
                       target_fv: torch.Tensor, search: SearchOffset1,
                       n_iter: int = 5, n_random: int = 4,
                       generator: torch.Generator | None = None,
                       backend: str = "auto") -> torch.Tensor:
    """1-D PatchMatch: returns the (H, W) int32 disparity field
    (index-space, target at ``j + d``).  Feature volumes must be normalized
    for ``func`` (`cachelessPatchMatch`, `patchmatch.h:561`).

    ``backend``: 'cv' (alias 'pallas': the volume is aggregated once, then
    K6/K7), 'scan' (alias 'xla': cacheless loops), 'auto' (scan: for
    feature-volume inputs the aggregation dominates)."""
    backend = {"auto": "scan", "pallas": "cv", "xla": "scan"}.get(backend,
                                                                  backend)
    if backend == "cv":
        return _patch_match_stereo_cv(func, source_fv, target_fv, search,
                                      n_iter, n_random, generator)
    if backend != "scan":
        raise ValueError(f"backend {backend!r}: 'auto', 'cv' or 'scan'")
    ev = _StereoEval(func, source_fv, target_fv)
    H, W, _ = source_fv.shape
    draw = _drawer(generator, source_fv.device)

    disp = draw((H, W), search.lower, search.upper + 1)
    cost = ev.cost_field(disp)
    for it in range(n_iter):
        row_fwd, col_fwd = _SWEEP_DIRS[it % 4]
        disp, cost, _ = _row_sweep(ev, disp, cost, row_fwd)
        disp, cost, _ = _col_sweep(ev, disp, cost, col_fwd)
        disp, cost = _random_search(ev, disp, cost, search, n_random, draw)
    return disp


class _FlowEval:
    """cost(i, j, (di, dj)) = compare(source[i, j], target[i+di, j+dj]),
    the worst cost where the target lies outside the image."""

    def __init__(self, func, source_fv, target_fv):
        self.func = func
        self.traits = MATCH_TRAITS[func]
        self.source = source_fv
        self.target = target_fv
        self.worst = (_INF if self.traits.strategy is ExtractionStrategy.COST
                      else -_INF)

    def costs(self, src, ti, tj):
        """compare(src, target[ti, tj]) over any shape of positions."""
        H, W = self.target.shape[:2]
        inb = (ti >= 0) & (ti < H) & (tj >= 0) & (tj < W)
        tgt = self.target[ti.clamp(0, H - 1).long(), tj.clamp(0, W - 1).long()]
        return torch.where(inb, feature_comparison(self.func, src, tgt),
                           self.worst)

    def cost_field(self, flow: torch.Tensor) -> torch.Tensor:
        H, W = flow.shape[:2]
        ii = torch.arange(H, dtype=torch.int32, device=flow.device)[:, None]
        jj = torch.arange(W, dtype=torch.int32, device=flow.device)[None, :]
        return self.costs(self.source, ii + flow[..., 0], jj + flow[..., 1])


def _flow_row_sweep(ev: _FlowEval, flow, cost, forward: bool):
    """Sequential propagation along columns, all rows in parallel: pixel
    (i, j) tests the (already updated) flow of (i, j -+ 1)."""
    H, W = cost.shape
    ii = torch.arange(H, dtype=torch.int32, device=flow.device)
    for j in (range(1, W) if forward else range(W - 2, -1, -1)):
        cand = flow[:, j - 1 if forward else j + 1]           # (H, 2)
        cc = ev.costs(ev.source[:, j], ii + cand[:, 0], j + cand[:, 1])
        accept = _better(ev.traits, cc, cost[:, j])
        flow[:, j] = torch.where(accept[:, None], cand, flow[:, j])
        cost[:, j] = torch.where(accept, cc, cost[:, j])


def _flow_col_sweep(ev: _FlowEval, flow, cost, forward: bool):
    """Sequential propagation along rows, all columns in parallel."""
    H, W = cost.shape
    jj = torch.arange(W, dtype=torch.int32, device=flow.device)
    for i in (range(1, H) if forward else range(H - 2, -1, -1)):
        cand = flow[i - 1 if forward else i + 1]              # (W, 2)
        cc = ev.costs(ev.source[i], i + cand[:, 0], jj + cand[:, 1])
        accept = _better(ev.traits, cc, cost[i])
        flow[i] = torch.where(accept[:, None], cand, flow[i])
        cost[i] = torch.where(accept, cc, cost[i])


def _draw_flow(draw, shape, search: SearchOffset2) -> torch.Tensor:
    """(H, W, 2) int32 uniform flow candidates over ``search``: the row
    offsets drawn first, then the column offsets."""
    return torch.stack([draw(shape, search.lower0, search.upper0 + 1),
                        draw(shape, search.lower1, search.upper1 + 1)], -1)


def patch_match_flow(func: MatchingFunction, source_fv: torch.Tensor,
                     target_fv: torch.Tensor, search: SearchOffset2,
                     n_iter: int = 5, n_random: int = 4,
                     generator: torch.Generator | None = None,
                     draw=None) -> torch.Tensor:
    """2-D PatchMatch (image flow, `patchMatch` with searchSpaceDim == 2):
    returns the (H, W, 2) int32 flow field (di, dj).  Propagation sweeps
    (rows, then columns, their directions cycled per iteration) and the
    scaled random search mirror the 1-D variant with 2-D candidates.
    ``draw(shape, low, high)`` replaces the generator's uniform int32
    draws (it lets a test replay another candidate stream): two a
    candidate field, its row offsets first."""
    ev = _FlowEval(func, source_fv, target_fv)
    H, W, _ = source_fv.shape
    if draw is None:
        draw = _drawer(generator, source_fv.device)

    flow = _draw_flow(draw, (H, W), search).to(disp_dtype)
    cost = ev.cost_field(flow)
    for it in range(n_iter):
        row_fwd, col_fwd = _SWEEP_DIRS[it % 4]
        _flow_row_sweep(ev, flow, cost, row_fwd)
        _flow_col_sweep(ev, flow, cost, col_fwd)
        for k in range(n_random):
            cand = _draw_flow(draw, (H, W), search).to(disp_dtype)
            # scaled toward the current flow; `//` floors negative values,
            # as jnp's does
            cand = flow + ((cand - flow) * (k + 1)) // (n_random + 1)
            same = torch.all(cand == flow, dim=-1, keepdim=True)
            cand = torch.where(same, flow + 1, cand)
            in_rng = ((cand[..., 0] >= search.lower0)
                      & (cand[..., 0] <= search.upper0)
                      & (cand[..., 1] >= search.lower1)
                      & (cand[..., 1] <= search.upper1))
            cc = torch.where(in_rng, ev.cost_field(cand), ev.worst)
            accept = in_rng & _better(ev.traits, cc, cost)
            flow = torch.where(accept[..., None], cand, flow)
            cost = torch.where(accept, cc, cost)
    return flow


def patch_match(func: MatchingFunction, img_or_fv_l, img_or_fv_r,
                search: SearchOffset1, h_radius: int | None = None,
                v_radius: int | None = None, n_iter: int = 5,
                n_random: int = 4,
                generator: torch.Generator | None = None) -> torch.Tensor:
    """Convenience wrapper from raw images (`patchMatch`,
    `patchmatch.h:497`): RIGHT_TO_LEFT roles (source = right).

    On CUDA tensors, with window radii and a box-decomposable cost, the
    volume comes from the box route (K1 for the dot family) and the CV path
    runs, as the JAX package does on the TPU; otherwise unfold + normalize
    + `patch_match_stereo`."""
    from .box_backend import supports_box
    from .cost_volume import normalize_feature_volume, unfold_based_cost_volume
    from .unfold import unfold
    if h_radius is not None and img_or_fv_l.is_cuda and supports_box(func):
        cv = unfold_based_cost_volume(func, img_or_fv_l, img_or_fv_r,
                                      h_radius, v_radius, search)
        return _patch_match_stereo_cv(func, None, None, search, n_iter,
                                      n_random, generator, cv=cv)
    if h_radius is not None:
        fv_l = normalize_feature_volume(func, unfold(h_radius, v_radius,
                                                     img_or_fv_l))
        fv_r = normalize_feature_volume(func, unfold(h_radius, v_radius,
                                                     img_or_fv_r))
    else:
        fv_l, fv_r = img_or_fv_l, img_or_fv_r
    return patch_match_stereo(func, fv_r, fv_l, search, n_iter, n_random,
                              generator)
