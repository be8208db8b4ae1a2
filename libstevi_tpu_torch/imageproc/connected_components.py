"""Connected-component labeling and per-cluster statistics (counterpart of
`libstevi_tpu/imageproc/connected_components.py`).

Reference parity: `imageProcessing/connectedComponents.h:40-416` — N-d
component labeling over a boolean mask with a chosen contiguity (Queen /
Rook, `utils/contiguity.h:26-143`) plus per-cluster stats (size, centroid,
bounding axes, mean value).

Label propagation as the JAX package runs it: every foreground pixel
starts with its flat index, and a sweep gives each the minimum label of
itself and its neighbours; at the fixed point a label is the flat index
of its component's first row-major pixel.  The sweeps run in blocks of
`SWEEPS_PER_READ` with one host read of the "changed" flag a block (a
read a sweep would sync the device every sweep).  Labels only decrease,
so a block that changes nothing ends at the fixed point, and sweeps past
it change nothing: the labels are the JAX package's, also under
``max_iters`` (the last block is cut to the cap).  The sweeps run are kept
on ``connected_components.sweeps``.  `relabel_consecutive` and
`cluster_stats` are the JAX package's host numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

SWEEPS_PER_READ = 16

_OFFSETS = {
    "queen": [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1),
              (1, -1), (1, 0), (1, 1)],
    "rook": [(-1, 0), (0, -1), (0, 1), (1, 0)],
    "bishop": [(-1, -1), (-1, 1), (1, -1), (1, 1)],
}


def fixed_point(step, state: torch.Tensor, cap: int):
    """``step`` applied until ``state`` stops changing or ``cap`` steps
    ran, in blocks of `SWEEPS_PER_READ` steps between host reads (``step``
    must be monotone, so an unchanged block is the fixed point).  Returns
    (state, steps run)."""
    it = 0
    while it < cap:
        start = state
        n = min(SWEEPS_PER_READ, cap - it)
        for _ in range(n):
            state = step(state)
        it += n
        if bool((state == start).all()):
            break
    return state, it


def connected_components(mask: torch.Tensor, contiguity: str = "queen",
                         max_iters: int | None = None) -> torch.Tensor:
    """Label foreground pixels of a 2-D bool mask; background gets -1.
    Labels are the flat index of each component's first (row-major) pixel,
    relabeled to consecutive ints by `relabel_consecutive` if needed."""
    if contiguity not in _OFFSETS:
        raise ValueError(contiguity)
    H, W = mask.shape
    m = mask.bool()
    big = H * W
    init = torch.where(m, torch.arange(big, dtype=torch.int32,
                                       device=m.device).view(H, W), big)

    def sweep(labels):
        p = F.pad(labels, (1, 1, 1, 1), value=big)
        best = labels
        for di, dj in _OFFSETS[contiguity]:
            best = torch.minimum(best, p[1 + di:1 + di + H, 1 + dj:1 + dj + W])
        return torch.where(m, best, big)

    labels, connected_components.sweeps = fixed_point(
        sweep, init, H * W if max_iters is None else max_iters)
    return torch.where(m, labels, -1)


connected_components.sweeps = 0


def relabel_consecutive(labels):
    """Host-side relabeling to consecutive component ids (0..k-1) — one
    vectorized searchsorted pass."""
    lab = labels.cpu().numpy() if isinstance(labels, torch.Tensor) \
        else np.asarray(labels)
    uniq = np.unique(lab[lab >= 0])
    out = np.full(lab.shape, -1, np.int32)
    fg = lab >= 0
    out[fg] = np.searchsorted(uniq, lab[fg]).astype(np.int32)
    return out, len(uniq)


def cluster_stats(labels, values=None):
    """Per-cluster size, centroid, mean value and bbox
    (`connectedComponents.h` cluster statistics) — one vectorized
    bincount pass over the label map."""
    lab, k = relabel_consecutive(labels)
    fg = lab >= 0
    ids = lab[fg]
    iy, ix = np.nonzero(fg)
    sizes = np.bincount(ids, minlength=k)
    cy = np.bincount(ids, weights=iy, minlength=k) / sizes
    cx = np.bincount(ids, weights=ix, minlength=k) / sizes
    if values is not None:
        v = values.cpu().numpy() if isinstance(values, torch.Tensor) \
            else np.asarray(values)
        mv = np.bincount(ids, weights=v[fg], minlength=k) / sizes
    big = np.iinfo(np.int64).max
    y0 = np.full(k, big); x0 = np.full(k, big)
    y1 = np.full(k, -1); x1 = np.full(k, -1)
    np.minimum.at(y0, ids, iy); np.minimum.at(x0, ids, ix)
    np.maximum.at(y1, ids, iy); np.maximum.at(x1, ids, ix)
    return [{"size": int(sizes[c]),
             "centroid": (float(cy[c]), float(cx[c])),
             "mean": float(mv[c]) if values is not None else None,
             "bbox": (int(y0[c]), int(x0[c]), int(y1[c]), int(x1[c]))}
            for c in range(k)]
