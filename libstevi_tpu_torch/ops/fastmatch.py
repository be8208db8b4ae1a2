"""Fast approximate scanline matching (counterpart of
`libstevi_tpu/ops/fastmatch.py`).

Reference parity: `correlation/fast_approximate_matching.h` —
`fastmatch` (:105-246): NO dense cost volume is ever built.  Each row
starts with a full search (`fullDispAtIdx`, :44); every following pixel
evaluates only THREE candidates (the previous pixel's disparity and its
+-1 neighbours, costs computed on demand from the feature volumes,
strictly-better replacement in the order 0, -1, +1 per
`optimalDispAndCost`, `matching_costs.h:724`); after two consecutive
jumps the pixel falls back to a full search.  `previous_jumped` starts
True, so a jump at the second column re-searches immediately.

Rows run in parallel; the column sweep is a loop carrying (disparity,
jumped) per row.  A column runs its full search only where some row needs
it (a host check, as the JAX package's `lax.cond`), so the work stays
proportional to (3 + research_rate * D).

Documented deviation (the JAX package's): `fullDispAtIdx` (:58) scans d in
[lower, upper) — an exclusive upper bound that makes the top disparity
reachable only by +1 propagation; the inclusive range is searched.
"""

from __future__ import annotations

import torch

from ..core.types import (MatchingFunction, MATCH_TRAITS, ExtractionStrategy,
                          disp_dtype)
from ..core.search import SearchOffset1
from .matching import feature_comparison


def fastmatch(func: MatchingFunction, source_fv: torch.Tensor,
              target_fv: torch.Tensor, search: SearchOffset1 | int
              ) -> torch.Tensor:
    """(H, W, F) source/target feature volumes -> (H, W) int32 disparities
    (search offsets, possibly negative) with the propagate-or-research
    policy.  Feature volumes must already be normalized per the matching
    function's traits (as the reference's on-demand volume does
    internally)."""
    if not isinstance(search, SearchOffset1):
        search = SearchOffset1(0, int(search) - 1)
    H, W, _ = source_fv.shape
    lo, hi = search.lower, search.upper
    dev = source_fv.device
    is_score = MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE
    bad = float("-inf") if is_score else float("inf")
    rows = torch.arange(H, device=dev)
    ds = torch.arange(search.count, dtype=torch.int32, device=dev) + lo

    def cost_at(j, d_vec):
        """Costs of per-row disparity candidates d_vec (H,) at column j."""
        tj = j + d_vec
        ok = (tj >= 0) & (tj < W) & (d_vec >= lo) & (d_vec <= hi)
        feats = target_fv[rows, tj.clamp(0, W - 1).long()]
        return torch.where(ok, feature_comparison(func, source_fv[:, j],
                                                  feats), bad)

    def full_search(j):
        """(H,) best disparity of column j over the whole range (the first
        optimum, as jnp's argmin / argmax)."""
        tj = j + ds[None, :]                                  # (1, D)
        ok = (tj >= 0) & (tj < W)
        feats = target_fv[rows[:, None], tj.clamp(0, W - 1).long()]
        c = torch.where(ok, feature_comparison(
            func, source_fv[:, j][:, None, :], feats), bad)
        arg = torch.argmax(c, 1) if is_score else torch.argmin(c, 1)
        return (arg + lo).to(torch.int32)

    def better(a, b):
        return a > b if is_score else a < b

    out = torch.empty((H, W), dtype=torch.int32, device=dev)
    d_prev = out[:, 0] = full_search(0)
    prev_jumped = torch.ones(H, dtype=torch.bool, device=dev)
    for j in range(1, W):
        d_cur, c_cur = d_prev, cost_at(j, d_prev)
        for delta in (-1, 1):                       # order: 0, -1, +1
            cand = d_prev + delta
            cc = cost_at(j, cand)
            take = better(cc, c_cur)
            d_cur = torch.where(take, cand, d_cur)
            c_cur = torch.where(take, cc, c_cur)
        jumped = d_cur != d_prev
        research = jumped & prev_jumped
        if bool(research.any()):
            d_cur = torch.where(research, full_search(j), d_cur)
        out[:, j] = d_cur
        d_prev, prev_jumped = d_cur, jumped
    return out.to(disp_dtype)


def fastmatch_from_cv(func: MatchingFunction,
                      cv: torch.Tensor) -> torch.Tensor:
    """Propagate-or-research over a PRECOMPUTED (H, W, D) cost volume
    (a diagnostic variant; the reference's fastmatch never builds one —
    use `fastmatch` for the on-demand path).  Returns disparity
    indices."""
    H, W, D = cv.shape
    is_score = MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE
    vals = (-cv if is_score else cv).float()
    full_arg = torch.argmin(vals, dim=-1).to(torch.int32)   # (H, W)
    offs = torch.tensor([0, -1, 1], dtype=torch.int32, device=cv.device)

    out = torch.empty((H, W), dtype=torch.int32, device=cv.device)
    d_prev = out[:, 0] = full_arg[:, 0]
    prev_jumped = torch.ones(H, dtype=torch.bool, device=cv.device)
    for j in range(1, W):
        cand = d_prev[:, None] + offs                       # (H, 3)
        ok = (cand >= 0) & (cand < D)
        cc = torch.gather(vals[:, j], 1, cand.clamp(0, D - 1).long())
        cc = torch.where(ok, cc, float("inf"))
        best = torch.argmin(cc, dim=-1)
        d_prop = torch.gather(cand, 1, best[:, None])[:, 0]
        jumped = d_prop != d_prev
        d_new = torch.where(jumped & prev_jumped, full_arg[:, j], d_prop)
        out[:, j] = d_new
        d_prev, prev_jumped = d_new, jumped
    return out.to(disp_dtype)
