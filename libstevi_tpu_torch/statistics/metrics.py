"""Disparity and flow accuracy metrics in numpy (counterpart of
`libstevi_tpu/statistics/metrics.py`).

Reference parity: `examples/stereo-match/main.cpp:234-258` (proportion of
pixels with |err| <= threshold — "prop good", the complement of the bad-N
score) and :275-303 (mean absolute error over the inliers).
"""

from __future__ import annotations

import numpy as np


def prop_good(disp, gt, threshold: float = 2.0) -> float:
    """Fraction of GT-valid pixels with |disp - gt| <= threshold.  Pixels
    without ground truth (NaN gt) are excluded; an invalid *estimate* (NaN
    disp) counts as bad."""
    disp = np.asarray(disp, np.float64)
    gt = np.asarray(gt, np.float64)
    valid = np.isfinite(gt)
    if not valid.any():
        return float("nan")
    err = np.abs(disp - gt)[valid]
    return float((err <= threshold).mean())    # NaN err compares False


def bad_n(disp, gt, threshold: float = 2.0) -> float:
    """The bad-N score: 1 - prop_good (Middlebury convention)."""
    return 1.0 - prop_good(disp, gt, threshold)


def inlier_mae(disp, gt, threshold: float = 2.0) -> float:
    """Mean |err| over pixels with |err| <= threshold."""
    disp = np.asarray(disp, np.float64)
    gt = np.asarray(gt, np.float64)
    valid = np.isfinite(gt) & np.isfinite(disp)
    err = np.abs(disp - gt)[valid]
    inl = err[err <= threshold]
    return float(inl.mean()) if inl.size else float("nan")


def end_point_error(flow, gt_flow) -> float:
    """Mean euclidean end-point error of an (H, W, 2) flow field vs GT
    (the optical-flow analogue of the disparity MAE).  Validity masks on
    the GROUND TRUTH only: a non-finite *estimate* at a GT-valid pixel
    propagates NaN into the mean, consistent with `prop_good`'s
    invalid-estimate-counts-as-bad semantics."""
    flow = np.asarray(flow, np.float64)
    gt = np.asarray(gt_flow, np.float64)
    d = np.linalg.norm(flow - gt, axis=-1)
    valid = np.isfinite(gt).all(-1)
    return float(d[valid].mean()) if valid.any() else float("nan")
