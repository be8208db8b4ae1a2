"""Checkerboard (calibration target) detection (counterpart of
`libstevi_tpu/imageproc/checkerboard.py`).

Reference parity: `imageProcessing/checkBoardDetection.h` (1532 LoC):
  * corner candidates from the eigen-decomposition of the box-aggregated
    Hessian, selected at local response minima with a two-sided eigenvalue
    threshold (`checkBoardCornersCandidates:870-1000`);
  * candidate filtering by 8-section interquartile-mean consistency
    (`checkBoardFilterCandidates:1003-1084`);
  * grid growing (`isolateCheckBoard:259`) — a BFS lattice fill with
    first-order (perspective-tolerant) position extrapolation;
  * subpixel refinement by the 4-parameter atan saddle model fit with
    Gauss-Newton (`fitCheckboardCornerCenterModelOptParameters:1086-1380`,
    `deltaFromCornerFitParams:1382`, `refineCheckBoardCorners:1451`);
  * hierarchical (pyramid-upsampling) refinement
    (`fitCheckboardCornerCenterHiearchical:1412`,
    `upsampleRefineCheckBoardCorners:1490`).

The response maps and the Gauss-Newton fit (all corners at once: batched
4x4 `torch.linalg.solve`, a fixed loop of ``n_iter`` steps) are torch ops
on the image's device; the candidate list, its filter and the grid growing
are the JAX package's host numpy.  The response's box sums are the port's
shifted-slice box filter (`ops.filters.box_filter_2d`), the same window
sums as the JAX package's 2-D prefix sums without their cancellation:
where the response is flat, the JAX package's values are rounding noise
and its candidates there differ from these (the adaptive eigenvalue
threshold of `detect_checkerboard` drops them).  The normal equations are
elementwise products summed (no matmul, so no TF32 on a GPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.filters import box_filter_2d


# ---------------------------------------------------------------------------
# candidates (`checkBoardCornersCandidates`, :870)
# ---------------------------------------------------------------------------

def checkerboard_response(image: torch.Tensor, smooth_radius: int = 1):
    """Hessian eigen-analysis maps: (resp, lambda_min, lambda_max,
    main_dir) per pixel.  resp = det(H) of the box-aggregated second
    derivatives; checkerboard corners are strong saddles (det < 0 with
    both |eigenvalues| large).  `checkBoardCornersCandidates:870-955`."""
    x = image.float()

    def dx(a):  # central difference along x (`finiteDifference`), wrapped
        return (torch.roll(a, -1, 1) - torch.roll(a, 1, 1)) / 2.0

    def dy(a):
        return (torch.roll(a, -1, 0) - torch.roll(a, 1, 0)) / 2.0

    r = smooth_radius
    xd, yd = dx(x), dy(x)
    xx = box_filter_2d(dx(xd), r, r)
    xy = box_filter_2d(dy(xd), r, r)
    yy = box_filter_2d(dy(yd), r, r)

    # symmetric 2x2 eigen decomposition in closed form
    tr2 = (xx + yy) / 2.0
    rad = torch.sqrt(((xx - yy) / 2.0) ** 2 + xy * xy)
    lmax = tr2 + rad
    lmin = tr2 - rad
    resp = lmax * lmin
    # eigenvector of lambda_max, sign-normalized to y >= 0 (:944-947)
    off = torch.abs(xy) > 1e-12
    vx = torch.where(off, lmax - yy, 1.0)
    vy = torch.where(off, xy, 0.0)
    sign = torch.where(vy < 0, -1.0, 1.0)
    main_dir = torch.atan2(sign * vy, sign * vx)
    return resp, lmin, lmax, main_dir


def checkerboard_corner_candidates(image: torch.Tensor,
                                   smooth_radius: int = 1,
                                   nms_radius: int = 2,
                                   lambda_threshold: float = 0.0):
    """Discrete candidates: local response *minima* (strongest saddles are
    the most negative det) with lambda_min < -thr and lambda_max > thr.
    Returns a host structured array with x, y, lmin, lmax, main_dir
    (`checkBoardCornersCandidates:956-1000`)."""
    resp, lmin, lmax, main_dir = checkerboard_response(image, smooth_radius)
    r = nms_radius
    local_min = -F.max_pool2d(-resp[None], 2 * r + 1, stride=1,
                              padding=r)[0]
    is_cand = ((resp == local_min) & (lmin <= -lambda_threshold)
               & (lmax >= lambda_threshold))
    ii, jj = torch.nonzero(is_cand, as_tuple=True)
    vals = torch.stack([lmin[ii, jj], lmax[ii, jj], main_dir[ii, jj]])
    vals = vals.cpu().numpy()
    return np.rec.fromarrays(
        [jj.cpu().numpy().astype(np.int32), ii.cpu().numpy().astype(np.int32),
         vals[0], vals[1], vals[2]],
        names=["x", "y", "lmin", "lmax", "main_dir"])


# ---------------------------------------------------------------------------
# candidate filtering (`checkBoardFilterCandidates`, :1003)
# ---------------------------------------------------------------------------

_SECTION_DX = np.array([2, -2, 2, -2, 2, -2, 0, 0])
_SECTION_DY = np.array([2, -2, 0, 0, -2, 2, 2, -2])


def filter_checkerboard_candidates(image, candidates,
                                   hard_tolerance: float = 0.2,
                                   soft_threshold: float = 0.6):
    """Keep candidates whose 8 surrounding 3x3 sections pair up like a
    checkerboard: opposite sections (diagonal/axial pairs) must have
    similar interquartile-mean intensity relative to the local intensity
    range (at most 3 hard failures at ``hard_tolerance`` x range and at
    most 1 at ``soft_threshold`` x range) — `:1003-1084` exactly.  Host
    numpy; ``image`` is a tensor or an array."""
    img = image.cpu().numpy() if isinstance(image, torch.Tensor) \
        else np.asarray(image, np.float32)
    img = img.astype(np.float32, copy=False)
    H, W = img.shape
    c = candidates
    inb = ((c.x >= 3) & (c.y >= 3) & (c.x <= W - 4) & (c.y <= H - 4))
    c = c[inb]
    if len(c) == 0:
        return c
    # gather the 8 sections x 9 pixels per candidate
    oy = (_SECTION_DY[None, :, None]
          + np.array([-1, -1, -1, 0, 0, 0, 1, 1, 1])[None, None, :])
    ox = (_SECTION_DX[None, :, None]
          + np.array([-1, 0, 1, -1, 0, 1, -1, 0, 1])[None, None, :])
    vals = img[c.y[:, None, None] + oy, c.x[:, None, None] + ox]
    vals.sort(axis=-1)
    iq_mean = vals[..., 2:7].sum(axis=-1)              # (N, 8)
    rng = iq_mean.max(axis=1) - iq_mean.min(axis=1)
    pair_diff = np.abs(iq_mean[:, 0::2] - iq_mean[:, 1::2])   # (N, 4)
    failures = (pair_diff > hard_tolerance * rng[:, None]).sum(1)
    errors = (pair_diff > soft_threshold * rng[:, None]).sum(1)
    return c[(failures <= 3) & (errors <= 1)]


# ---------------------------------------------------------------------------
# 4-parameter corner model (`fitCheckboardCornerCenterModelOptParameters`)
# ---------------------------------------------------------------------------

def _fit_corner_params(windows: torch.Tensor, init_cos: torch.Tensor,
                       init_sin: torch.Tensor, radius: int, n_iter: int):
    """Batched Gauss-Newton fit of the saddle model
    atan(Tx * Ty), T = [[X2, -X3], [X3, X2]] . p + (X0, X1), to the
    contrast-normalized window intensities (`:1086-1233`).  ``windows`` is
    (N, n, n); returns X (N, 4)."""
    N, n, _ = windows.shape
    n_obs = n * n
    dev = windows.device
    d = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    px = d.repeat(n)[None]                              # (1, n_obs)
    py = d.repeat_interleave(n)[None]

    flat = windows.reshape(N, n_obs)
    sor = torch.sort(flat, 1).values
    black_idx = n_obs // 10
    black = sor[:, black_idx:black_idx + 1]
    white = sor[:, n_obs - black_idx - 1:n_obs - black_idx]
    denom = torch.where(torch.abs(white - black) < 1e-12, 1.0, white - black)
    obs = 2 * (flat - black) / denom * (math.pi / 2) - math.pi / 2

    X = torch.stack([torch.zeros_like(init_cos), torch.zeros_like(init_cos),
                     init_cos, init_sin], -1)            # (N, 4)
    ridge = 1e-8 * torch.eye(4, device=dev)
    for _ in range(n_iter):
        tx = X[:, 2:3] * px - X[:, 3:4] * py + X[:, 0:1]
        ty = X[:, 3:4] * px + X[:, 2:3] * py + X[:, 1:2]
        err = obs - torch.atan(tx * ty)                  # (N, n_obs)
        att = 1.0 / ((tx * ty) ** 2 + 1.0)
        A = torch.stack([att * ty, att * tx, att * (py * tx + px * ty),
                         att * (px * tx - py * ty)], -1)  # (N, n_obs, 4)
        AtA = (A[..., :, None] * A[..., None, :]).sum(1)
        Atb = (A * err[..., None]).sum(1)
        X = X + torch.linalg.solve(AtA + ridge, Atb)
    return X


def _delta_from_params(X: torch.Tensor) -> torch.Tensor:
    """delta = -inv([[X2, -X3], [X3, X2]]) @ (X0, X1)
    (`deltaFromCornerFitParams:1382`); (N, 4) -> (N, 2) [dx, dy]."""
    det = X[:, 2] ** 2 + X[:, 3] ** 2
    det = torch.where(det < 1e-12, 1e-12, det)
    dx = -(X[:, 2] * X[:, 0] + X[:, 3] * X[:, 1]) / det
    dy = -(-X[:, 3] * X[:, 0] + X[:, 2] * X[:, 1]) / det
    return torch.stack([dx, dy], -1)


def _gather_windows(image: torch.Tensor, xs, ys, radius: int):
    """(N, n, n) windows centered on integer (xs, ys), border-clamped like
    the reference (`:1117-1139`)."""
    H, W = image.shape
    off = torch.arange(-radius, radius + 1, device=image.device)
    yy = (ys[:, None, None] + off[None, :, None]).clamp(0, H - 1)
    xx = (xs[:, None, None] + off[None, None, :]).clamp(0, W - 1)
    return image.float()[yy, xx]


def fit_checkerboard_corners(image: torch.Tensor, xs, ys, main_dir,
                             radius: int = 3, n_iter: int = 5):
    """Subpixel positions for integer corner estimates: 4-param model fit
    seeded from each corner's main direction (theta = main_dir - pi/4,
    X[2:] = (cos -theta, sin -theta), `:1168-1173`).  Returns ((N, 2)
    float [x, y], X (N, 4)) on the image's device."""
    dev = image.device
    xs = torch.as_tensor(np.asarray(xs), device=dev).long()
    ys = torch.as_tensor(np.asarray(ys), device=dev).long()
    theta = torch.as_tensor(np.asarray(main_dir, np.float32),
                            device=dev) - math.pi / 4
    win = _gather_windows(image, xs, ys, radius)
    X = _fit_corner_params(win, torch.cos(-theta), torch.sin(-theta),
                           radius, n_iter)
    pos = torch.stack([xs.float(), ys.float()], -1) + _delta_from_params(X)
    return pos, X


def fit_checkerboard_corners_hierarchical(images, xs, ys, main_dir,
                                          upscaling_factor: float,
                                          radius: int = 3, n_iter: int = 5):
    """Pyramid refinement (`fitCheckboardCornerCenterHiearchical:1412`):
    fit at the coarsest level, then at each finer level re-center on the
    upscaled position and re-fit with the previous transform params
    divided by the upscaling factor (`:1434-1443`).  ``images`` is
    coarsest-first; positions/dirs are level-0 (coarsest) coordinates."""
    pos, X = fit_checkerboard_corners(images[0], xs, ys, main_dir, radius,
                                      n_iter)
    for lvl in range(1, len(images)):
        pos = pos * upscaling_factor
        xi = torch.round(pos[:, 0]).long()
        yi = torch.round(pos[:, 1]).long()
        win = _gather_windows(images[lvl], xi, yi, radius)
        X = _fit_corner_params(win, X[:, 2] / upscaling_factor,
                               X[:, 3] / upscaling_factor, radius, n_iter)
        pos = torch.stack([xi.float(), yi.float()], -1) \
            + _delta_from_params(X)
    return pos


# ---------------------------------------------------------------------------
# grid growing (`isolateCheckBoard`, :259)
# ---------------------------------------------------------------------------

@dataclass
class CheckBoard:
    """Detected grid: (rows, cols, 2) float [x, y] corner positions (NaN
    where no corner was found)."""

    corners: np.ndarray

    @property
    def rows(self):
        return self.corners.shape[0]

    @property
    def cols(self):
        return self.corners.shape[1]

    @property
    def n_points_found(self):
        return int(np.isfinite(self.corners[..., 0]).sum())


def isolate_checkerboard(candidates, tol: float = 0.35,
                         dir_tol: float = 0.6) -> CheckBoard | None:
    """Grid growing: seed at the most central candidate, estimate the two
    lattice vectors from its nearest direction-consistent neighbors, then
    BFS-extend with FIRST-ORDER extrapolation (the predicted position of
    (a+1, b) uses p(a,b) + (p(a,b) - p(a-1,b)) when available), which
    follows perspective distortion where a global lattice would drift —
    the re-designed equivalent of `isolateCheckBoard:259-868`.  Candidates
    must land within ``tol`` x local step of the prediction and have a
    main direction within ``dir_tol`` rad of the alternating pattern."""
    if hasattr(candidates, "x"):
        pts = np.stack([np.asarray(candidates.x, np.float64),
                        np.asarray(candidates.y, np.float64)], -1)
        dirs = np.asarray(candidates.main_dir, np.float64)
    else:
        pts = np.asarray(candidates, np.float64)
        dirs = None
    if len(pts) < 4:
        return None
    center = pts.mean(0)
    seed = int(np.argmin(((pts - center) ** 2).sum(1)))
    d = np.linalg.norm(pts - pts[seed], axis=1)
    d[seed] = np.inf
    n1 = int(np.argmin(d))
    v1 = pts[n1] - pts[seed]
    scores = np.full(len(pts), np.inf)
    for k in range(len(pts)):
        if k in (seed, n1):
            continue
        v = pts[k] - pts[seed]
        nv = np.linalg.norm(v)
        if nv < 1e-9:
            continue
        cosang = abs(v @ v1) / (nv * np.linalg.norm(v1))
        scores[k] = nv * (1 + 4 * cosang)
    n2 = int(np.argmin(scores))
    v2 = pts[n2] - pts[seed]

    def dir_ok(k, ref):
        if dirs is None or ref is None:
            return True
        # adjacent corners have OPPOSITE contrast, negating the Hessian:
        # their max-eigenvector is perpendicular to the neighbor's, so
        # orientations must match on the pi/2-periodic circle
        dd = abs(((dirs[k] - ref) + np.pi / 4) % (np.pi / 2) - np.pi / 4)
        return dd < dir_tol

    def find(p, step, ref_dir):
        # skip already-assigned candidates here: the nearest in-tolerance
        # candidate may be taken, and the next-nearest free one still fits
        dd = np.linalg.norm(pts - p, axis=1)
        order = np.argsort(dd)
        for k in order[:4]:
            if dd[k] >= tol * step:
                break
            if int(k) in used:
                continue
            if dir_ok(k, ref_dir):
                return int(k)
        return -1

    grid = {(0, 0): seed}
    used = {seed}
    frontier = [(0, 0)]
    while frontier:
        (a, b) = frontier.pop()
        p0 = pts[grid[(a, b)]]
        ref_dir = dirs[grid[(a, b)]] if dirs is not None else None
        for (da, db) in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            key = (a + da, b + db)
            if key in grid:
                continue
            # first-order extrapolation from the opposite neighbor
            prev = (a - da, b - db)
            if prev in grid:
                v = p0 - pts[grid[prev]]
            else:
                v = da * v1 + db * v2
            step = np.linalg.norm(v)
            k = find(p0 + v, step, ref_dir)
            if k >= 0:
                grid[key] = k
                used.add(k)
                frontier.append(key)

    if len(grid) < 4:
        return None
    aa = [k[0] for k in grid]
    bb = [k[1] for k in grid]
    a0, a1 = min(aa), max(aa)
    b0, b1 = min(bb), max(bb)
    out = np.full((a1 - a0 + 1, b1 - b0 + 1, 2), np.nan)
    idx = np.full((a1 - a0 + 1, b1 - b0 + 1), -1, np.int64)
    for (a, b), k in grid.items():
        out[a - a0, b - b0] = pts[k]
        idx[a - a0, b - b0] = k
    board = CheckBoard(out)
    board._candidate_idx = idx
    return board


# ---------------------------------------------------------------------------
# full pipelines (`refineCheckBoardCorners:1451`,
# `upsampleRefineCheckBoardCorners:1490`)
# ---------------------------------------------------------------------------

def refine_checkerboard_corners(image: torch.Tensor, board: CheckBoard,
                                candidates, radius: int = 3, n_iter: int = 5
                                ) -> CheckBoard:
    """Subpixel-refine every found grid corner with the 4-param model."""
    idx = board._candidate_idx
    found = idx >= 0
    ks = idx[found]
    pos, _ = fit_checkerboard_corners(
        image, np.asarray(candidates.x)[ks], np.asarray(candidates.y)[ks],
        np.asarray(candidates.main_dir)[ks], radius, n_iter)
    out = np.full_like(board.corners, np.nan)
    out[found] = pos.cpu().numpy()
    ref = CheckBoard(out)
    ref._candidate_idx = idx
    return ref


def detect_checkerboard(image: torch.Tensor, smooth_radius: int = 1,
                        nms_radius: int = 2, lambda_threshold: float = 0.0,
                        refine: bool = True) -> CheckBoard | None:
    """Full pipeline: candidates -> section filter -> grid growing ->
    4-param subpixel refinement."""
    cands = checkerboard_corner_candidates(image, smooth_radius, nms_radius,
                                           lambda_threshold)
    # adaptive default: keep clearly saddle-like responses only (flat
    # regions tie at resp == 0 and would otherwise flood the NMS)
    if lambda_threshold == 0.0 and len(cands):
        thr = 0.05 * float((-cands.lmin).max())
        cands = cands[(cands.lmin <= -thr) & (cands.lmax >= thr)]
    cands = filter_checkerboard_candidates(image, cands)
    board = isolate_checkerboard(cands)
    if board is None or not refine:
        return board
    return refine_checkerboard_corners(image, board, cands)
