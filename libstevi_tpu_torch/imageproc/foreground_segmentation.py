"""Global foreground/background segmentation via graph cut (counterpart
of `libstevi_tpu/imageproc/foreground_segmentation.py`).

Reference parity: `imageProcessing/foregroundSegmentation.h` — `MaskInfo`
(Foreground=1/Background=0, :159), `SmoothingMaskCostPolicy` (:246: constant
switch cost between 4-neighbors), `GuidedMaskCostPolicy` (:277: switch cost
modulated by guide similarity down to a minimum), `buildGraph` (:485:
per-pixel terminal edges from the (H, W, 2) cost array + pairwise submodular
edges), `getGlobalRefinedMask` (:751: min cut -> mask), and
`hierarchicalGlobalRefinedMask` (:844: coarse-to-fine with only the
boundary band re-optimized at each level).

Design, as in the JAX package: the graph is built with numpy and cut on
the host through `graphs.flow` (the native float-capacity solver) —
graph cuts are pointer-chasing by nature.  The costs may be numpy arrays
or tensors (copied to the host); the hierarchical variant's band
dilations run through the port's `morphology.dilation` on the costs'
device.  The masks are numpy arrays.
"""

from __future__ import annotations

import enum

import numpy as np


class MaskInfo(enum.IntEnum):
    BACKGROUND = 0
    FOREGROUND = 1


def _host(x) -> np.ndarray:
    """A numpy copy of an array or a tensor on any device."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _grid_edges(H, W, weights_h, weights_v):
    """Pairwise 4-neighborhood edges with per-edge weights (both
    directions, as graph-cut smoothing terms are symmetric)."""
    idx = np.arange(H * W).reshape(H, W)
    eu, ev, ew = [], [], []
    # horizontal neighbors
    eu.append(idx[:, :-1].ravel()); ev.append(idx[:, 1:].ravel())
    ew.append(weights_h.ravel())
    eu.append(idx[:, 1:].ravel()); ev.append(idx[:, :-1].ravel())
    ew.append(weights_h.ravel())
    # vertical neighbors
    eu.append(idx[:-1, :].ravel()); ev.append(idx[1:, :].ravel())
    ew.append(weights_v.ravel())
    eu.append(idx[1:, :].ravel()); ev.append(idx[:-1, :].ravel())
    ew.append(weights_v.ravel())
    return (np.concatenate(eu), np.concatenate(ev), np.concatenate(ew))


def get_global_refined_mask(cost: np.ndarray, switch_cost: float,
                            guide: np.ndarray | None = None,
                            min_switch_cost: float = 0.0,
                            guide_sigma: float = 0.1) -> np.ndarray:
    """cost: (H, W, 2) with [..., 0] = cost of labeling Background and
    [..., 1] = cost of labeling Foreground; returns (H, W) MaskInfo.

    With a guide image, the pairwise cost follows `GuidedMaskCostPolicy`
    (`foregroundSegmentation.h:277-340`): delta = per-channel SUM of
    absolute guide differences, weight = (max_d - delta)/(max_d - min_d)
    normalized by the global min/max over all 4-neighbor pairs, and
    cost = min_switch + (switch - min_switch) * weight.  (``guide_sigma``
    is accepted for back-compat and unused — the reference's law is the
    globally-normalized linear ramp, not a Gaussian.)
    """
    from ..graphs.flow import max_flow_min_cut

    cost = _host(cost).astype(np.float64)
    H, W, _ = cost.shape
    n = H * W
    source, target = n, n + 1

    # terminal edges: source->pixel with the cost of labeling BACKGROUND
    # (cut when the pixel goes background), pixel->sink with the FOREGROUND
    # labeling cost.  Only the per-pixel DIFFERENCE matters for the cut,
    # so shift both by their minimum instead of clipping at zero —
    # clipping destroys the relative preference for negative costs
    # (e.g. log-likelihood ratios; `addLinearCost` semantics,
    # `foregroundSegmentation.h:355-389`).
    shift = np.minimum(cost[..., 0], cost[..., 1]).ravel()
    w_bg = cost[..., 0].ravel() - shift
    w_fg = cost[..., 1].ravel() - shift

    if guide is not None:
        g = _host(guide).astype(np.float64)
        if g.ndim == 2:
            g = g[..., None]
        dh = np.abs(g[:, 1:] - g[:, :-1]).sum(-1)   # channel SUM (:322)
        dv = np.abs(g[1:, :] - g[:-1, :]).sum(-1)
        dmin = min(dh.min(), dv.min())
        dmax = max(dh.max(), dv.max())
        rng = max(dmax - dmin, 1e-12)
        lo = min(switch_cost, min_switch_cost)
        hi = max(switch_cost, min_switch_cost)
        wh = lo + (hi - lo) * (dmax - dh) / rng
        wv = lo + (hi - lo) * (dmax - dv) / rng
    else:
        wh = np.full((H, W - 1), switch_cost)
        wv = np.full((H - 1, W), switch_cost)

    eu, ev, ew = _grid_edges(H, W, wh, wv)
    pix = np.arange(n)
    edges = np.concatenate([
        np.stack([np.full(n, source), pix], 1),
        np.stack([pix, np.full(n, target)], 1),
        np.stack([eu, ev], 1)])
    caps = np.concatenate([w_bg, w_fg, ew])

    res = max_flow_min_cut(n + 2, edges, caps, source, target)
    # a source-side pixel cuts its pixel->sink edge and pays w_fg, i.e. it
    # takes the Foreground label; a sink-side pixel cuts source->pixel and
    # pays w_bg (Background) — the min cut is the minimum-energy labeling
    mask = res.source_side[:n].reshape(H, W)
    return np.where(mask, MaskInfo.FOREGROUND, MaskInfo.BACKGROUND)


def hierarchical_global_refined_mask(costs, switch_cost: float,
                                     guides=None, band: int = 2
                                     ) -> np.ndarray:
    """Coarse-to-fine refinement (`hierarchicalGlobalRefinedMask`, :844):
    solve the coarsest level globally, then at each finer level re-optimize
    only a band around the upsampled boundary (other pixels keep their
    upsampled labels by pinning them with large terminal costs).

    `costs` is a list of (H_l, W_l, 2) arrays or tensors, coarsest FIRST;
    the band dilations run on the first cost's device (the CPU for
    arrays).
    """
    import torch

    from .morphology import dilation

    device = costs[0].device if isinstance(costs[0], torch.Tensor) else "cpu"
    mask = None
    for level, cost in enumerate(costs):
        guide = None if guides is None else guides[level]
        cost = _host(cost)
        H, W, _ = cost.shape
        if mask is None:
            mask = get_global_refined_mask(cost, switch_cost, guide)
            continue
        # upsample previous mask to this level
        up = np.kron(mask, np.ones((2, 2), mask.dtype))[:H, :W]
        if up.shape != (H, W):
            up = np.pad(up, ((0, H - up.shape[0]), (0, W - up.shape[1])),
                        mode="edge")
        # boundary band
        m = torch.from_numpy(up.astype(np.float32)).to(device)
        grown = dilation(m, radius=band)
        shrunk = -dilation(-m, radius=band)
        boundary = (grown != shrunk).cpu().numpy()
        mask = _refine_band(cost.astype(np.float64), up, boundary,
                            switch_cost, guide)
    return mask


def _refine_band(cost, up, boundary, switch_cost, guide):
    """Re-optimize only the boundary band (`getPartialGlobalRefinedMask`
    semantics): a subgraph over band pixels with the pinned neighbors'
    pairwise costs folded into the band pixels' terminal costs — exact,
    and without the huge pin capacities that would quantize the real
    costs away under max_flow's integer scaling."""
    from ..graphs.flow import max_flow_min_cut

    H, W, _ = cost.shape
    if not boundary.any():
        return up.copy()
    node = np.full((H, W), -1, np.int64)
    ys, xs = np.nonzero(boundary)
    nb = len(ys)
    node[ys, xs] = np.arange(nb)

    if guide is not None:
        g = _host(guide).astype(np.float64)
        if g.ndim == 2:
            g = g[..., None]
        dh = np.abs(g[:, 1:] - g[:, :-1]).sum(-1)
        dv = np.abs(g[1:, :] - g[:-1, :]).sum(-1)
        dmin = min(dh.min(), dv.min())
        dmax = max(dh.max(), dv.max())
        rng = max(dmax - dmin, 1e-12)
        wh = (dmax - dh) / rng * switch_cost
        wv = (dmax - dv) / rng * switch_cost
    else:
        wh = np.full((H, W - 1), switch_cost)
        wv = np.full((H - 1, W), switch_cost)

    shiftv = np.minimum(cost[..., 0], cost[..., 1])
    w_bg = (cost[..., 0] - shiftv)[ys, xs]
    w_fg = (cost[..., 1] - shiftv)[ys, xs]

    eu, ev, ew = [], [], []
    for (dy, dx, wmap) in ((0, 1, wh), (1, 0, wv)):
        ay, ax = ys, xs
        byy, bxx = ys + dy, xs + dx
        ok = (byy < H) & (bxx < W)
        ay, ax, byy, bxx = ay[ok], ax[ok], byy[ok], bxx[ok]
        wpair = wmap[ay, ax] if dy == 0 else wmap[ay, ax]
        na, nbr = node[ay, ax], node[byy, bxx]
        both = nbr >= 0
        # band-band edges (both directions)
        eu += [na[both], nbr[both]]
        ev += [nbr[both], na[both]]
        ew += [wpair[both], wpair[both]]
        # band-pinned edges fold into the band pixel's terminal cost:
        # labeling it opposite the pinned neighbor cuts the pair edge
        pin = ~both
        pfg = pin & (up[byy, bxx] == MaskInfo.FOREGROUND)
        pbg = pin & (up[byy, bxx] == MaskInfo.BACKGROUND)
        np.add.at(w_bg, na[pfg], wpair[pfg])
        np.add.at(w_fg, na[pbg], wpair[pbg])
        # and the mirrored orientation (pinned pixel first)
        oy, ox = ys - dy, xs - dx
        ok2 = (oy >= 0) & (ox >= 0)
        oy, ox = oy[ok2], ox[ok2]
        cy, cx = ys[ok2], xs[ok2]
        pin2 = node[oy, ox] < 0
        w2 = wmap[oy, ox]
        p2fg = pin2 & (up[oy, ox] == MaskInfo.FOREGROUND)
        p2bg = pin2 & (up[oy, ox] == MaskInfo.BACKGROUND)
        np.add.at(w_bg, node[cy, cx][p2fg], w2[p2fg])
        np.add.at(w_fg, node[cy, cx][p2bg], w2[p2bg])

    source, target = nb, nb + 1
    pix = np.arange(nb)
    edges = np.concatenate([
        np.stack([np.full(nb, source), pix], 1),
        np.stack([pix, np.full(nb, target)], 1),
        np.stack([np.concatenate(eu), np.concatenate(ev)], 1)])
    caps = np.concatenate([w_bg, w_fg, np.concatenate(ew)])
    res = max_flow_min_cut(nb + 2, edges, caps, source, target)
    out = up.copy()
    out[ys, xs] = np.where(res.source_side[:nb], MaskInfo.FOREGROUND,
                           MaskInfo.BACKGROUND)
    return out
