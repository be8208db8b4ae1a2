"""Hexagonal RGB fiducial target detection (counterpart of
`libstevi_tpu/imageproc/targets.py`).

Reference parity: `imageProcessing/hexagonalRGBTargetsDetection.h` —
`detectHexTargets` (:233-500): a target is SIX colored dots on hexagon
corners; exactly one carries the main color (the reference dot, Blue by
default) and the other five encode bits through the positive/negative
colors (Red/Green).  Detection:

  * candidate pixels: min(R,G,B) <= threshold_min OR
    max-min >= threshold_diff (:262-275);
  * Queen connected components, filtered by area in [min_area, max_area]
    and by minor/major scatter-axis ratio (:283-307,
    `connectedComponents.h:293` sqrt-eigenvalue axes);
  * greedy hexagon assembly: each unused cluster grabs its 5 nearest
    unused neighbours; the set must fit an ellipse
    (a x^2 + b xy + c y^2 = 1 least squares on centered centroids, max
    |residual| <= hex_rel_res_threshold, c >= (b/2)^2) and span less
    than rel_max_hex_diameter of the image (:340-384);
  * cluster colors from gained channel means; exactly one main-color dot
    (:396-430);
  * sub-pixel refinement by `clusterBlurryCentroid` (:63-196): the
    cluster mask is dilated, pixels weighted by 1 - (color distance to
    the cluster mean) / max distance, positions averaged;
  * orientation: dots sorted by angle from the main dot, inverted
    trigonometric direction to match image coordinates (:434-466).

The pixel stages (thresholds, connected components) run on the image's
device; the per-cluster geometric assembly is the JAX package's host
numpy loop (tens of clusters), its stable argsorts included.  Deviation
(the JAX package's): `clusterBlurryCentroid`'s dilation loop (:131-146)
overwrites the output cell per neighbour so only the (+1,+1) offset
survives; this applies a true 8-neighbour dilation (the intent).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .connected_components import connected_components, relabel_consecutive

RED, GREEN, BLUE = 0, 1, 2


@dataclass
class HexTargetPosition:
    """`HexRgbTarget::HexTargetPosition` (:53-60): reference-dot position
    plus the five encoding dots in angular order, with their
    positive-color flags.  Positions are (row, col)."""

    pos_ref_dot: np.ndarray          # (2,)
    dots_positives: np.ndarray       # (5,) bool
    dots_positions: np.ndarray       # (5, 2)

    # compatibility accessors for the round-1 API
    @property
    def center(self):
        pts = np.vstack([self.pos_ref_dot[None], self.dots_positions])
        return tuple(pts.mean(0))

    @property
    def corners(self):
        return np.vstack([self.pos_ref_dot[None], self.dots_positions])


def cluster_blurry_centroid(img: np.ndarray, cluster_mask: np.ndarray,
                            dilation_radius: int = 3) -> np.ndarray:
    """Sub-pixel blob center for a blurry colored dot
    (`hexagonalRGBTargetsDetection.h:63-196`): mean color over the core
    mask, mask dilated ``dilation_radius`` times, pixels weighted by
    1 - colordist/maxdist, weighted position mean."""
    iy, ix = np.nonzero(cluster_mask)
    mean = img[iy, ix].astype(np.float64).mean(0)

    ext = cluster_mask.copy()
    for _ in range(dilation_radius):
        grown = ext.copy()
        grown[1:] |= ext[:-1]
        grown[:-1] |= ext[1:]
        grown[:, 1:] |= ext[:, :-1]
        grown[:, :-1] |= ext[:, 1:]
        grown[1:, 1:] |= ext[:-1, :-1]
        grown[1:, :-1] |= ext[:-1, 1:]
        grown[:-1, 1:] |= ext[1:, :-1]
        grown[:-1, :-1] |= ext[1:, 1:]
        ext = grown

    ey, ex = np.nonzero(ext)
    d = np.linalg.norm(img[ey, ex].astype(np.float64) - mean, axis=1)
    dmax = d.max()
    w = 1.0 - d / dmax if dmax > 0 else np.ones_like(d)
    ws = w.sum()
    return np.stack([(w * ey).sum() / ws, (w * ex).sum() / ws])


def detect_hex_targets(image, threshold_min: float = 0.3,
                       threshold_diff: float = 0.3,
                       min_area: int = 10, max_area: int = 800,
                       minor_major_axis_ratio: float = 0.6,
                       rel_max_hex_diameter: float = 0.2,
                       red_gain: float = 1.0, green_gain: float = 1.0,
                       blue_gain: float = 1.0,
                       hex_rel_res_threshold: float = 0.1,
                       main_color: int = BLUE, positive_color: int = RED,
                       negative_color: int = GREEN
                       ) -> list[HexTargetPosition]:
    """Detect hexagonal RGB targets in an (H, W, 3) image
    (`detectHexTargets`, :233).  Returns one `HexTargetPosition` per
    validated hexagon."""
    if len({main_color, positive_color, negative_color}) != 3:
        raise ValueError("main, positive and negative colors must differ")
    x = torch.as_tensor(image).float()
    H, W, C = x.shape
    if C != 3:
        raise ValueError("an (H, W, 3) image is required")

    mn = x.amin(-1)
    mx = x.amax(-1)
    selected = (mn <= threshold_min) | (mx - mn >= threshold_diff)

    lab, k = relabel_consecutive(
        connected_components(selected, contiguity="queen"))
    img = x.cpu().numpy()

    gains = np.asarray([red_gain, green_gain, blue_gain], np.float32)

    # one argsort pass gathers every component's pixel indices — the
    # per-label `lab == c` full-image rescan is O(k*H*W) and a noisy
    # image yields thousands of components
    flat_order = np.argsort(lab.ravel(), kind="stable")
    starts = np.searchsorted(lab.ravel()[flat_order], np.arange(k + 1))

    cents, idxs, colors = [], [], []
    for c in range(k):
        span = flat_order[starts[c]:starts[c + 1]]
        area = len(span)
        if area < min_area or area > max_area:
            continue
        iy, ix = np.divmod(span, W)
        pts = np.stack([iy, ix]).astype(np.float64)
        ctr = pts.mean(1)
        centered = pts - ctr[:, None]
        # sqrt-eigenvalue minor/major axes of the (unnormalized) scatter
        # matrix (`connectedComponents.h:293-363`)
        evals = np.linalg.eigvalsh(centered @ centered.T)
        minor, major = np.sqrt(np.maximum(evals, 0.0))
        if minor < minor_major_axis_ratio * major:
            continue
        mean_rgb = img[iy, ix].mean(0) * gains
        cents.append(ctr)
        idxs.append((iy, ix))
        colors.append(int(np.argmax(mean_rgb)))

    n = len(cents)
    if n < 6:
        return []
    cents = np.asarray(cents)

    used = np.zeros(n, bool)
    ret = []
    for si in range(n):
        if used[si]:
            continue
        d = np.linalg.norm(cents - cents[si], axis=1)
        d[used] = np.inf
        order = np.argsort(d, kind="stable")
        six = order[:6]                       # includes si (distance 0)
        if not np.isfinite(d[six]).all():
            continue
        if d[six[5]] > rel_max_hex_diameter * max(H, W):
            continue

        center = cents[six].mean(0)
        c0 = cents[six] - center
        A = np.stack([c0[:, 0] ** 2, c0[:, 0] * c0[:, 1],
                      c0[:, 1] ** 2], 1)
        params, *_ = np.linalg.lstsq(A, np.ones(6), rcond=None)
        res = A @ params - 1.0
        if np.abs(res).max() > hex_rel_res_threshold:
            continue
        # ellipse test for a x^2 + b xy + c y^2 = 1: discriminant
        # b^2 - 4ac < 0 with a > 0 (`hexagonalRGBTargetsDetection.h:377`);
        # checking c against b^2/4 alone also accepts parallel-line and
        # hyperbolic conics (e.g. two rows of three dots)
        a_c, b_c, c_c = params
        if b_c * b_c - 4.0 * a_c * c_c >= 0.0 or a_c <= 0.0:
            continue

        cols = [colors[i] for i in six]
        mains = [i for i, c in enumerate(cols) if c == main_color]
        if len(mains) != 1:
            continue
        main_id = mains[0]

        def _mask(i):
            m = np.zeros((H, W), bool)
            m[idxs[i]] = True
            return m

        refined = np.stack([
            cluster_blurry_centroid(img, _mask(i)) for i in six])

        # inverted trigonometric direction to match image coordinates
        angles = np.arctan2(c0[:, 0], c0[:, 1])
        angles = angles - angles[main_id]
        angles = np.where(angles < 0, 2 * np.pi + angles, angles)
        angles[main_id] = 0.0
        hex_order = np.argsort(angles, kind="stable")

        ret.append(HexTargetPosition(
            pos_ref_dot=refined[hex_order[0]],
            dots_positives=np.asarray(
                [cols[i] == positive_color for i in hex_order[1:]]),
            dots_positions=refined[hex_order[1:]],
        ))
        used[six] = True
    return ret
