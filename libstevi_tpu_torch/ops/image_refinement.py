"""Image-based (feature-space barycentric) subpixel refinement (counterpart
of `libstevi_tpu/ops/image_refinement.py`).

Reference parity: `correlation/image_based_refinement.h` — the refinement
interpolates *feature vectors* of the target image rather than costs:
  * `refineBarycentricDisp` (:186-355): two 2-point barycentric best
    approximations (toward jd+1 and jd-1), candidate deltas accepted only in
    (0, 1) and only when the re-evaluated comparison score improves
    (interpolated target features re-normalized for Normalized functions);
  * `refineBarycentricSymmetricDisp` (:32-106): one (2r+1)-point affine
    best approximation, delta = sum(coeff_p * p), accepted when |delta| < 1;
  * per-function barycentric solvers from the traits
    (`matching_costs.h:436-650`): spherical for NCC/ZNCC, L2 for SSD/ZSSD,
    L1 for SAD/ZSAD, least-median for MEDAD/ZMEDAD.

The per-pixel solves are one batched call of the `optim` solvers over all
pixels (`optim.lsq.small_lstsq` underneath); target feature windows are
`torch.gather`s.  The cost volume of the image-level entries comes from
`aggregate_cost` 'auto', which launches K5 on CUDA for the dot/SSD/SAD
families; the rest is torch ops on the inputs' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.types import (MatchingFunction, MATCH_TRAITS, ExtractionStrategy,
                          DispDirection)
from ..core.utils import Contiguity
from .matching import feature_comparison
from ..optim.lsq import (affine_best_l2_approximation,
                         spherical_affine_best_approximation)
from ..optim.l1 import affine_best_l1_approximation
from ..optim.lmeds import affine_best_least_median_approximation


def _barycentric_solver(func: MatchingFunction, test_sets=None):
    """Per-trait barycentric solver (`matching_costs.h:436-650`): spherical
    for NCC/ZNCC, L2 for SSD/ZSSD/CC/ZCC, L1 for SAD/ZSAD, least-median for
    MEDAD/ZMEDAD.  With ``test_sets`` (the reference's ``testSetsIdxs``),
    the subpart least-median solver restricted to the given row subsets —
    defined only for the least-median traits
    (`subpartBarycentricBestApproximation`, `matching_costs.h:614,645`).
    Each solver maps A (..., F, n) and b (..., F) to (..., n)."""
    k = MATCH_TRAITS[func].kernel
    norm = MATCH_TRAITS[func].normalized
    if test_sets is not None:
        if k != "medad":
            raise NotImplementedError(
                "subpart barycentric refinement is only defined for the "
                "least-median matching functions (MEDAD/ZMEDAD), matching "
                "the reference traits")
        sub = np.asarray(test_sets, np.int32)
        return lambda A, b: affine_best_least_median_approximation(A, b, sub)
    if k == "medad":
        return affine_best_least_median_approximation
    if k == "dot" and norm:
        return spherical_affine_best_approximation
    if k == "ssd" or (k == "dot" and not norm):
        return affine_best_l2_approximation
    if k == "sad":
        return affine_best_l1_approximation
    raise NotImplementedError(
        f"barycentric refinement not defined for {func}")


def _gather_cols(fv: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """fv (H, W, F); cols (H, W) -> (H, W, F), clamped."""
    H, W, F = fv.shape
    c = torch.clamp(cols, 0, W - 1).long().expand(H, W)
    return torch.gather(fv, 1, c[..., None].expand(H, W, F))


def _maybe_normalize(func, v):
    if MATCH_TRAITS[func].normalized:
        return v / torch.clamp_min(torch.linalg.vector_norm(
            v, dim=-1, keepdim=True), 1e-12)
    return v


def _roles(direction, fv_l, fv_r):
    """(source, target) feature volumes of ``direction``."""
    return ((fv_r, fv_l) if direction is DispDirection.RIGHT_TO_LEFT
            else (fv_l, fv_r))


def _better(func):
    if MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE:
        return lambda a, b: a > b
    return lambda a, b: a < b


def _cols(W, device):
    return torch.arange(W, dtype=torch.int32, device=device)[None, :]


def refine_barycentric_disp(func: MatchingFunction, fv_l: torch.Tensor,
                            fv_r: torch.Tensor, selected_index: torch.Tensor,
                            direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                            test_sets_idxs=None) -> torch.Tensor:
    """Two-sided 2-point barycentric refinement (`refineBarycentricDisp`,
    `image_based_refinement.h:186-355`).  Feature volumes raw (zero-mean
    applied upstream if the trait requires; normalization happens inside per
    the reference)."""
    sign = direction.delta_sign
    src, target_fv = _roles(direction, fv_l, fv_r)
    H, W, F = target_fv.shape
    d = selected_index.to(torch.int32)
    jd = _cols(W, d.device) + sign * d
    valid = (jd >= 1) & (jd + 1 < W)

    t0 = _gather_cols(target_fv, jd)
    tp = _gather_cols(target_fv, jd + 1)
    tm = _gather_cols(target_fv, jd - 1)

    solver = _barycentric_solver(func, test_sets_idxs)
    coeffs_p = solver(torch.stack([t0, tp], -1), src)        # (H, W, 2)
    coeffs_m = solver(torch.stack([tm, t0], -1), src)
    dd_plus = coeffs_p[..., 1]
    dd_minus = coeffs_m[..., 0]

    src_n = _maybe_normalize(func, src)
    base_score = feature_comparison(func, src_n, _maybe_normalize(func, t0))
    interp_p = _maybe_normalize(
        func, t0 * coeffs_p[..., 0:1] + tp * coeffs_p[..., 1:2])
    interp_m = _maybe_normalize(
        func, tm * coeffs_m[..., 0:1] + t0 * coeffs_m[..., 1:2])
    score_p = feature_comparison(func, src_n, interp_p)
    score_m = feature_comparison(func, src_n, interp_m)
    better = _better(func)

    delta = torch.zeros((H, W), dtype=torch.float32, device=d.device)
    score = base_score
    ok_p = (dd_plus > 0) & (dd_plus < 1) & better(score_p, score)
    delta = torch.where(ok_p, dd_plus, delta)
    score = torch.where(ok_p, score_p, score)
    ok_m = (dd_minus > 0) & (dd_minus < 1) & better(score_m, score)
    delta = torch.where(ok_m, -dd_minus, delta)

    df = d.float()
    return torch.where(valid, df + sign * delta, df)


def refine_barycentric_symmetric_disp(
        func: MatchingFunction, fv_l: torch.Tensor, fv_r: torch.Tensor,
        selected_index: torch.Tensor, disp_width: int, refine_radius: int = 1,
        direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
        test_sets_idxs=None) -> torch.Tensor:
    """Symmetric (2r+1)-point barycentric refinement
    (`refineBarycentricSymmetricDisp`, `image_based_refinement.h:32-106`)."""
    sign = direction.delta_sign
    source_fv, target_fv = _roles(direction, fv_l, fv_r)
    H, W, F = target_fv.shape
    r = refine_radius
    d = selected_index.to(torch.int32)
    jj = _cols(W, d.device)
    jd = jj + sign * d
    valid = ((jj + 1 < W)
             & (jd - r >= 0) & (jd + 1 <= W - r)
             & (d != 0) & (d + 1 < disp_width))

    A = torch.stack([_gather_cols(target_fv, jd + p)
                     for p in range(-r, r + 1)], -1)   # (H, W, F, 2r+1)
    coeffs = _barycentric_solver(func, test_sets_idxs)(A, source_fv)
    ps = torch.arange(-r, r + 1, dtype=torch.float32, device=d.device)
    delta = torch.sum(coeffs * ps, -1)
    df = d.float()
    refined = torch.where(torch.abs(delta) < 1, df + delta, df)
    return torch.where(valid, refined, df)


_CORNER_DIRS = {Contiguity.QUEEN: ((1, 1), (1, 0), (0, 1)),
                Contiguity.ROOK: ((1, 0), (0, 1)),
                Contiguity.BISHOP: ((1, 1),)}


def refine_barycentric_2d_disp(func: MatchingFunction, source_fv: torch.Tensor,
                               target_fv: torch.Tensor,
                               selected_index: torch.Tensor,
                               search=None,
                               contiguity: Contiguity = Contiguity.QUEEN,
                               test_sets_idxs=None) -> torch.Tensor:
    """2-D barycentric refinement of an (H, W, 2) flow field
    (`refineBarycentric2dDisp`, `image_based_refinement.h:679-883`): for
    each quadrant (dir_x, dir_y) in {1,-1}^2, one barycentric best
    approximation over the contiguity's corner directions plus the
    center (`contiguity.h:140-160`: Queen = {(1,1),(1,0),(0,1)}); the
    joint delta (sum alpha_k * dir_k) is accepted when |delta0| <= 1 and
    |delta1| <= 1 and the re-evaluated comparison improves, best kept
    across quadrants.  Entries whose WTA flow falls outside ``search``
    (a `SearchOffset2`, when given) pass through unrefined, like the
    reference's searchWindows gate."""
    H, W, F = target_fv.shape
    d = selected_index.to(torch.int32)
    d0, d1 = d[..., 0], d[..., 1]
    ii = torch.arange(H, dtype=torch.int32, device=d.device)[:, None]
    jj = _cols(W, d.device)
    ti = torch.clamp(ii + d0, 1, H - 2).long()
    tj = torch.clamp(jj + d1, 1, W - 2).long()
    valid = ((ii + d0 >= 1) & (ii + d0 < H - 1)
             & (jj + d1 >= 1) & (jj + d1 < W - 1))
    if search is not None:
        valid = (valid
                 & (d0 >= search.lower0) & (d0 <= search.upper0)
                 & (d1 >= search.lower1) & (d1 <= search.upper1))

    def grab(di, dj):
        return target_fv[ti + di, tj + dj]

    t0 = grab(0, 0)
    solver = _barycentric_solver(func, test_sets_idxs)
    src = source_fv
    src_n = _maybe_normalize(func, src)
    score = feature_comparison(func, src_n, _maybe_normalize(func, t0))
    better = _better(func)

    dirs = _CORNER_DIRS[contiguity]
    delta0 = torch.zeros((H, W), dtype=torch.float32, device=d.device)
    delta1 = torch.zeros_like(delta0)
    for dx in (1, -1):
        for dy in (1, -1):
            A = torch.stack([grab(sd[0] * dx, sd[1] * dy) for sd in dirs]
                            + [t0], -1)               # (H, W, F, nd)
            alphas = solver(A, src)
            td0 = sum(alphas[..., k] * (dirs[k][0] * dx)
                      for k in range(len(dirs)))
            td1 = sum(alphas[..., k] * (dirs[k][1] * dy)
                      for k in range(len(dirs)))
            interp = _maybe_normalize(
                func, torch.einsum("hwfn,hwn->hwf", A, alphas))
            s = feature_comparison(func, src_n, interp)
            ok = ((torch.abs(td0) <= 1.0) & (torch.abs(td1) <= 1.0)
                  & better(s, score))
            delta0 = torch.where(ok, td0, delta0)
            delta1 = torch.where(ok, td1, delta1)
            score = torch.where(ok, s, score)

    df = d.float()
    refined = df + torch.stack([delta0, delta1], -1)
    return torch.where(valid[..., None], refined, df)


def refine_cost_symmetric_disp(func: MatchingFunction, fv_l, fv_r,
                               selected_index, disp_width,
                               direction=DispDirection.RIGHT_TO_LEFT,
                               cost_volume=None) -> torch.Tensor:
    """Cost-based symmetric refinement (`refineCostSymmetricDisp`,
    `image_based_refinement.h:1592-1688`): a parabola delta from the
    COST-VOLUME triplet cv[i,j,d-1..d+1] is averaged with a second delta
    from a HALF-PIXEL-interpolated source (0.5 src(j) + 0.5 src(j+dir),
    dir opposing the first delta; delta2 = parabola(f) - 0.5 dir,
    accepted when |delta2| < 1).  The correction applies WITHOUT
    deltaSign (the reference emits d + delta directly, `:1688`).  The
    parabola formula is sign-invariant, so Cost and Score functions
    share it, as in the reference.

    ``cost_volume`` is the WTA volume; recomputed from the feature
    volumes when omitted.  Documented deviation (the JAX package's):
    degenerate flat triplets (zero second difference) return the
    unrefined d instead of the reference's inf."""
    sign = direction.delta_sign
    source_fv, target_fv = _roles(direction, fv_l, fv_r)
    H, W, F = target_fv.shape
    d = selected_index.to(torch.int32)
    jjb = _cols(W, d.device).expand(H, W)
    jd = jjb + sign * d

    if cost_volume is None:
        from .cost_volume import feature_volume_to_cost_volume
        cost_volume = feature_volume_to_cost_volume(func, fv_l, fv_r,
                                                    disp_width, direction)
    D = cost_volume.shape[-1]
    valid = (jjb > 1) & (jjb + 1 < W) & (d > 0) & (d + 1 < D)

    def cv_at(dd):
        return torch.gather(cost_volume, -1,
                            torch.clamp(dd, 0, D - 1).long()[..., None])[..., 0]

    cm1, c0, c1 = cv_at(d - 1), cv_at(d), cv_at(d + 1)
    den = 2.0 * (c1 - 2.0 * c0 + cm1)
    delta = (cm1 - c1) / torch.where(den != 0, den, 1.0)
    delta = torch.where(den != 0, delta, 0.0)

    dir_ = torch.where(delta > 0, -1, 1).to(torch.int32)
    inner = (jd > 1) & (jd + 1 < W)
    src_half = _maybe_normalize(
        func, 0.5 * source_fv + 0.5 * _gather_cols(source_fv, jjb + dir_))

    def f_at(cols):
        return feature_comparison(
            func, src_half, _maybe_normalize(func, _gather_cols(target_fv,
                                                                cols)))

    fm1, f0, f1 = f_at(jd - 1), f_at(jd), f_at(jd + 1)
    den2 = 2.0 * (f1 - 2.0 * f0 + fm1)
    delta2 = (fm1 - f1) / torch.where(den2 != 0, den2, 1.0) \
        - dir_.float() * 0.5
    use2 = inner & (torch.abs(delta2) < 1.0) & (den2 != 0)
    delta = torch.where(use2, 0.5 * (delta + delta2), delta)

    df = d.float()
    return torch.where(valid, df + delta, df)


# ---------------------------------------------------------------------------
# Subpart (test-subset least-median) variants
# ---------------------------------------------------------------------------

def refine_subpart_barycentric_disp(func, fv_l, fv_r, selected_index,
                                    test_sets_idxs,
                                    direction=DispDirection.RIGHT_TO_LEFT):
    """`refineSubpartBarycentricDisp` (`image_based_refinement.h:516-675`):
    the two-sided 2-point refinement with the subpart least-median solver
    restricted to ``test_sets_idxs`` rows (MEDAD/ZMEDAD only).  Subsets are
    (n_sets, k) row-index sets (the reference stores them column-major)."""
    return refine_barycentric_disp(func, fv_l, fv_r, selected_index,
                                   direction, test_sets_idxs)


def refine_subpart_barycentric_symmetric_disp(
        func, fv_l, fv_r, selected_index, disp_width, test_sets_idxs,
        refine_radius=1, direction=DispDirection.RIGHT_TO_LEFT):
    """`refineSubpartBarycentricSymmetricDisp`
    (`image_based_refinement.h:108-184`)."""
    return refine_barycentric_symmetric_disp(
        func, fv_l, fv_r, selected_index, disp_width, refine_radius,
        direction, test_sets_idxs)


def refine_subpart_barycentric_2d_disp(func, source_fv, target_fv,
                                       selected_index, test_sets_idxs):
    """`refineSubpartBarycentric2dDisp`
    (`image_based_refinement.h:885-1066`)."""
    return refine_barycentric_2d_disp(func, source_fv, target_fv,
                                      selected_index,
                                      test_sets_idxs=test_sets_idxs)


# ---------------------------------------------------------------------------
# Symmetric 2-D (contiguity-neighborhood) refinement
# ---------------------------------------------------------------------------

# the reference's neighbor enumeration order (`contiguity.h:99-123`); the
# center column is appended LAST, matching `image_based_refinement.h:1183`
_REF_DIRS = {
    Contiguity.QUEEN: ((1, 1), (1, 0), (1, -1), (0, 1), (0, -1),
                       (-1, 1), (-1, 0), (-1, -1)),
    Contiguity.ROOK: ((1, 0), (0, 1), (0, -1), (-1, 0)),
}


def refine_barycentric_symmetric_2d_disp(
        func, fv_l, fv_r, selected_indices, search,
        contiguity: Contiguity = Contiguity.QUEEN,
        direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
        test_sets_idxs=None) -> torch.Tensor:
    """`refineBarycentricSymmetric2dDisp`
    (`image_based_refinement.h:1071-1241`): one affine best approximation
    over the contiguity neighbors + center of the matched target pixel;
    delta = sum(alpha_k * dir_k), accepted when |delta_0| <= 1 and
    |delta_1| <= 1 AND the re-evaluated (re-normalized) interpolated score
    improves.  ``search`` is a SearchOffset2.  With ``test_sets_idxs`` this
    is `refineSubpartBarycentricSymmetric2dDisp` (:1246)."""
    source_fv, target_fv = _roles(direction, fv_l, fv_r)
    H, W, F = target_fv.shape
    d = selected_indices.to(torch.int32)
    d0, d1 = d[..., 0], d[..., 1]
    ii = torch.arange(H, dtype=torch.int32, device=d.device)[:, None]
    jj = _cols(W, d.device)
    idr = ii + d0
    jdr = jj + d1
    valid = ((idr >= 1) & (idr + 1 < H) & (jdr >= 1) & (jdr + 1 < W)
             & (d0 >= search.lower0) & (d0 <= search.upper0)
             & (d1 >= search.lower1) & (d1 <= search.upper1))
    ic = torch.clamp(idr, 1, H - 2).long()
    jc = torch.clamp(jdr, 1, W - 2).long()

    dirs = _REF_DIRS[contiguity]
    cols = [target_fv[ic + di, jc + dj] for (di, dj) in dirs]
    cols.append(target_fv[ic, jc])
    A = torch.stack(cols, -1)                         # (H, W, F, nDirs+1)

    src = source_fv
    alphas = _barycentric_solver(func, test_sets_idxs)(A, src)

    di_vec = torch.tensor([p[0] for p in dirs], dtype=torch.float32,
                          device=d.device)
    dj_vec = torch.tensor([p[1] for p in dirs], dtype=torch.float32,
                          device=d.device)
    delta0 = torch.sum(alphas[..., :-1] * di_vec, -1)
    delta1 = torch.sum(alphas[..., :-1] * dj_vec, -1)

    src_n = _maybe_normalize(func, src)
    base_score = feature_comparison(func, src_n,
                                    _maybe_normalize(func, cols[-1]))
    interp = torch.einsum("hwfn,hwn->hwf", A, alphas)
    tmp_score = feature_comparison(func, src_n,
                                   _maybe_normalize(func, interp))
    accept = ((torch.abs(delta0) <= 1.0) & (torch.abs(delta1) <= 1.0)
              & _better(func)(tmp_score, base_score))

    df = d.float()
    # where (not multiply) so NaN deltas from degenerate subset solves are
    # cleanly rejected (0 * NaN would leak NaN)
    deltas = torch.stack([delta0, delta1], -1)
    refined = df + torch.where(accept[..., None], deltas, 0.0)
    return torch.where(valid[..., None], refined, df)


def refine_subpart_barycentric_symmetric_2d_disp(
        func, fv_l, fv_r, selected_indices, search, test_sets_idxs,
        contiguity: Contiguity = Contiguity.QUEEN,
        direction: DispDirection = DispDirection.RIGHT_TO_LEFT):
    """`refineSubpartBarycentricSymmetric2dDisp`
    (`image_based_refinement.h:1246-1416`)."""
    return refine_barycentric_symmetric_2d_disp(
        func, fv_l, fv_r, selected_indices, search, contiguity, direction,
        test_sets_idxs)


# ---------------------------------------------------------------------------
# Arbitrary-interpolation refinement (verification-grade scan of subpixel
# candidates, `image_based_refinement.h:362-372`: "more meant to be generic
# than optimized")
# ---------------------------------------------------------------------------

def _pyramid_kernel(x):
    return max(0.0, 1.0 - abs(x))


def _bicubic_kernel(x, a=-0.5):
    x = abs(x)
    if x < 1:
        return (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1
    if x < 2:
        return a * (x ** 3 - 5 * x ** 2 + 8 * x - 4)
    return 0.0


_INTERP_KERNELS = {"pyramid": (_pyramid_kernel, 1),
                   "bicubic": (_bicubic_kernel, 2)}


def _interp_weight_table(ts, kfun, taps):
    """(n_cands, n_taps) static weights w[c, k] = kernel(t_c - tap_k)."""
    return np.asarray([[kfun(float(t) - k) for k in taps] for t in ts],
                      np.float32)


def _first_min_update(best, best_pos, cost, pos):
    """Fold one batch of candidates (cost, pos: (c, H, W), in scan order)
    into the running (best, best_pos): the JAX package's argmin over the
    whole scan (the first minimum wins; a NaN cost, the first NaN)."""
    j = torch.argmin(cost, dim=0, keepdim=True)
    cmin = torch.gather(cost, 0, j)[0]
    pmin = torch.gather(pos, 0, j)[0]
    win = (cmin < best) | (torch.isnan(cmin) & ~torch.isnan(best))
    return torch.where(win, cmin, best), torch.where(win, pmin, best_pos)


def refine_arbitrary_interpolation_disp(
        func, fv_l, fv_r, selected_index, n_pixels_cut: int = 100,
        kernel: str = "pyramid", with_additional_refine: bool = True,
        direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
        chunk: int = 16) -> torch.Tensor:
    """`refineArbitraryInterpolationDisp`
    (`image_based_refinement.h:373-514`): scan ``n_pixels_cut`` subpixel
    cuts on each side of the matched target column, interpolate the target
    feature vector there with the chosen kernel (clamped taps at image
    borders, like the reference's Constant border on the sliced line), keep
    the best-scoring candidate (first wins on ties, like the reference's
    strict-improvement scan); with ``with_additional_refine`` each candidate
    gets a 2-point barycentric correction between the previous and current
    interpolated vectors (accepted when coeff0 in (0, 1)).

    The 2n candidates run ``chunk`` at a time in the JAX package's scan
    order (one einsum of a static (cands, taps) weight table against the
    gathered tap columns, one batched solve), folded into a running
    strict minimum: the JAX package evaluates all 2n at once, (2n, H, W, F)
    tensors of 12 GB each at 480x640, F = 49 and the default n = 100.  The
    result does not depend on ``chunk``."""
    kfun, kr = _INTERP_KERNELS[kernel]
    sign_dir = direction.delta_sign
    src, target_fv = _roles(direction, fv_l, fv_r)
    H, W, F = target_fv.shape
    dev = target_fv.device
    d = selected_index.to(torch.int32)
    jd = _cols(W, dev) + sign_dir * d
    valid = (jd >= 1) & (jd + 1 < W)

    bw = 1.0 / n_pixels_cut
    # candidate offsets in the reference's scan order (sign=-1 first)
    ts = ([-(c + 1) * bw for c in range(n_pixels_cut)]
          + [(c + 1) * bw for c in range(n_pixels_cut)])
    t_prev = ([-c * bw for c in range(n_pixels_cut)]
              + [c * bw for c in range(n_pixels_cut)])

    # taps jd + k; reference border handling == clamping k to [-kr, kr] then
    # the column to the image (Constant border on the sliced line)
    taps = list(range(-(kr + 1), kr + 2))
    tap_vals = torch.stack(
        [_gather_cols(target_fv, jd + max(-kr, min(kr, k))) for k in taps],
        0)                                            # (K, H, W, F)

    def table(t):
        return torch.from_numpy(_interp_weight_table(t, kfun, taps)).to(dev)

    Wt, Wt_prev = table(ts), table(t_prev)
    t_arr = torch.tensor(ts, dtype=torch.float32, device=dev)[:, None, None]
    tp_arr = torch.tensor(t_prev, dtype=torch.float32,
                          device=dev)[:, None, None]

    src_n = _maybe_normalize(func, src)
    t0 = _gather_cols(target_fv, jd)
    base = feature_comparison(func, src_n, _maybe_normalize(func, t0))
    score = MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE
    df = d.float()
    best, best_pos = (-base if score else base), df
    solver = _barycentric_solver(func)

    for c0 in range(0, len(ts), chunk):
        sl = slice(c0, c0 + chunk)
        feats = torch.einsum("ck,khwf->chwf", Wt[sl], tap_vals)
        if with_additional_refine:
            prevs = torch.einsum("ck,khwf->chwf", Wt_prev[sl], tap_vals)
            coeffs = solver(torch.stack([prevs, feats], -1),
                            src.expand(feats.shape))
            cf0 = coeffs[..., 0]
            use = (cf0 > 0) & (cf0 < 1)
            # DeltaD = -deltaSign*sign*coeff0*binWidth; sign*binWidth =
            # t - t_prev
            step = t_arr[sl] - tp_arr[sl]
            delta_extra = torch.where(use, -sign_dir * cf0 * step, 0.0)
            feats = torch.where(
                use[..., None],
                coeffs[..., 0:1] * prevs + coeffs[..., 1:2] * feats, feats)
            del prevs, coeffs
        else:
            delta_extra = 0.0
        costs = feature_comparison(func, src_n[None],
                                   _maybe_normalize(func, feats))
        if score:
            costs = -costs
        positions = df[None] + sign_dir * t_arr[sl] + delta_extra
        best, best_pos = _first_min_update(best, best_pos, costs, positions)
        del feats, costs
    return torch.where(valid, best_pos, df)


def refine_arbitrary_interpolation_2d_disp(
        func, source_fv, target_fv, selected_index, n_pixels_cut: int = 10,
        kernel: str = "pyramid",
        with_additional_refine: bool = True) -> torch.Tensor:
    """`refineArbitraryInterpolation2dDisp`
    (`image_based_refinement.h:1423-1589`): the 2-D analogue over a
    (2n)^2 grid of subpixel offsets around the matched target pixel, one
    candidate at a time in the JAX package's scan order.

    Documented deviations (the JAX package's) — the reference body has
    three clear bugs fixed to the intended semantics: (a) the
    additional-refine loop indexes the C matrix with the outer loop
    variable (`:1541`, `C(0,i)` for `C(0,c)`), (b) an accepted refine adds
    `pixCoord` (= kernelRadius + deltaPix) instead of the relative
    correction to the disparity (`:1548`), and (c) without additional
    refine the candidate offset `deltaPix` is never applied to the output
    even when its cost wins (`:1568`).  Here a winning candidate
    contributes `deltaPix`, and an accepted refine adds `C @ coeffs` on
    top."""
    kfun, kr = _INTERP_KERNELS[kernel]
    H, W, F = target_fv.shape
    dev = target_fv.device
    d = selected_index.to(torch.int32)
    d0, d1 = d[..., 0], d[..., 1]
    ii = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    jj = _cols(W, dev)
    idr = ii + d0
    jdr = jj + d1
    valid = (idr >= 1) & (idr + 1 < H) & (jdr >= 1) & (jdr + 1 < W)
    ic = torch.clamp(idr, 0, H - 1)
    jc = torch.clamp(jdr, 0, W - 1)

    bw = 1.0 / n_pixels_cut
    cuts = [(c + 1) * bw for c in range(-n_pixels_cut, n_pixels_cut)]

    taps = list(range(-(kr + 1), kr + 2))
    K = len(taps)
    # (Ki, Kj, H, W, F) clamped 2-D tap grid
    tap_vals = torch.stack([
        torch.stack([target_fv[
            torch.clamp(ic + max(-kr, min(kr, ki)), 0, H - 1).long(),
            torch.clamp(jc + max(-kr, min(kr, kj)), 0, W - 1).long()]
            for kj in taps], 0)
        for ki in taps], 0)

    wi = torch.from_numpy(_interp_weight_table(cuts, kfun, taps)).to(dev)
    wi_prev = torch.from_numpy(_interp_weight_table(
        [c - bw for c in cuts], kfun, taps)).to(dev)
    n = len(cuts)

    def interp_at(wrow_i, wrow_j):
        return torch.einsum("i,j,ijhwf->hwf", wrow_i, wrow_j, tap_vals)

    src_n = _maybe_normalize(func, source_fv)
    t0 = tap_vals[K // 2, K // 2]
    base_cost = feature_comparison(func, src_n, _maybe_normalize(func, t0))
    is_score = MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE
    solver = _barycentric_solver(func) if with_additional_refine else None

    best_cost = base_cost if not is_score else -base_cost
    best_d0 = d0.float()
    best_d1 = d1.float()
    cuts_arr = torch.tensor(cuts, dtype=torch.float32, device=dev)

    # the (a, b) candidate grid, row-major: the JAX package's lax.scan
    for a in range(n):
        for b in range(n):
            wa, wb = wi[a], wi[b]
            feat = interp_at(wa, wb)
            dd0 = cuts_arr[a].expand(H, W)
            dd1 = cuts_arr[b].expand(H, W)
            if with_additional_refine:
                # square corners at (0,0), (-bw,0), (0,-bw), (-bw,-bw)
                A = torch.stack([feat, interp_at(wi_prev[a], wb),
                                 interp_at(wa, wi_prev[b]),
                                 interp_at(wi_prev[a], wi_prev[b])], -1)
                co = solver(A, source_fv)
                ok = ((co[..., 0] > 0) & (co[..., 0] < 1)
                      & (co[..., 1] > 0) & (co[..., 1] < 1)
                      & (co[..., 2] > 0) & (co[..., 2] < 1))
                ci = -bw * (co[..., 1] + co[..., 3])
                cj = -bw * (co[..., 2] + co[..., 3])
                dd0 = dd0 + torch.where(ok, ci, 0.0)
                dd1 = dd1 + torch.where(ok, cj, 0.0)
                feat = torch.where(ok[..., None],
                                   torch.einsum("hwfn,hwn->hwf", A, co),
                                   feat)
            cost = feature_comparison(func, src_n,
                                      _maybe_normalize(func, feat))
            if is_score:
                cost = -cost
            win = cost < best_cost
            best_cost = torch.where(win, cost, best_cost)
            best_d0 = torch.where(win, d0 + dd0, best_d0)
            best_d1 = torch.where(win, d1 + dd1, best_d1)

    refined = torch.stack([best_d0, best_d1], -1)
    return torch.where(valid[..., None], refined, d.float())


# ---------------------------------------------------------------------------
# Feature-volume and image-level convenience entry points
# (`image_based_refinement.h:1692-2795`): build the cost volume, extract
# the WTA index and refine in one call.  Trait-driven preprocessing per
# `refined*DispFeatureVol` (:1702-1767): ZeroMean+Normalized functions
# match on the normalized volumes and refine on the zero-mean ones unless
# ``pre_normalize``; Normalized-only functions refine on the raw volumes
# unless ``pre_normalize``.  The subpart (sliding-sub-window) variants are
# selected automatically for the sampling costs (MEDAD/ZMEDAD), as the
# reference's trait dispatch does (:2435-2469).
# ---------------------------------------------------------------------------

_SUBPART_FUNCS = (MatchingFunction.MEDAD, MatchingFunction.ZMEDAD)


def _trait_volumes(func, fv_l, fv_r, pre_normalize):
    """Returns ((cv_fv_l, cv_fv_r), (refine_fv_l, refine_fv_r)) per the
    matching function's ZeroMean/Normalized traits."""
    from .cost_volume import (channels_mean, channels_norm,
                              channels_zero_mean_norm)
    tr = MATCH_TRAITS[func]
    fv_l = fv_l.float()
    fv_r = fv_r.float()
    if tr.zero_mean and tr.normalized:
        ml, mr = channels_mean(fv_l), channels_mean(fv_r)
        zl, zr = fv_l - ml[..., None], fv_r - mr[..., None]
        sl = channels_zero_mean_norm(fv_l, ml)
        sr = channels_zero_mean_norm(fv_r, mr)
        nl, nr = zl / sl[..., None], zr / sr[..., None]
        return (nl, nr), ((nl, nr) if pre_normalize else (zl, zr))
    if tr.zero_mean:
        zl = fv_l - channels_mean(fv_l)[..., None]
        zr = fv_r - channels_mean(fv_r)[..., None]
        return (zl, zr), (zl, zr)
    if tr.normalized:
        nl = fv_l / channels_norm(fv_l)[..., None]
        nr = fv_r / channels_norm(fv_r)[..., None]
        return (nl, nr), ((nl, nr) if pre_normalize else (fv_l, fv_r))
    return (fv_l, fv_r), (fv_l, fv_r)


def _cv_and_index(func, cv_l, cv_r, search, direction):
    from .cost_volume import aggregate_cost, extract_selected_index
    cv = aggregate_cost(func, cv_l, cv_r, search, direction)
    return extract_selected_index(cv, MATCH_TRAITS[func].strategy)


def refined_barycentric_symmetric_disp_fv(
        func, fv_l, fv_r, search_range: int, refine_radius: int = 1,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False,
        test_sets_idxs=None):
    """`refinedBarycentricSymmetricDispFeatureVol`
    (`image_based_refinement.h:1693`) / `refinedSubpart...` (:1779) when
    ``test_sets_idxs`` is given."""
    (cl, cr), (rl, rr) = _trait_volumes(func, fv_l, fv_r, pre_normalize)
    idx = _cv_and_index(func, cl, cr, search_range, direction)
    return refine_barycentric_symmetric_disp(
        func, rl, rr, idx, search_range, refine_radius, direction,
        test_sets_idxs)


def refined_barycentric_disp_fv(
        func, fv_l, fv_r, search_range: int,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False,
        test_sets_idxs=None):
    """`refinedBarycentricDispFeatureVol` (:1855) / subpart (:1941)."""
    (cl, cr), (rl, rr) = _trait_volumes(func, fv_l, fv_r, pre_normalize)
    idx = _cv_and_index(func, cl, cr, search_range, direction)
    return refine_barycentric_disp(func, rl, rr, idx, direction,
                                   test_sets_idxs)


def refined_cost_symmetric_disp_fv(
        func, fv_l, fv_r, search_range: int,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False):
    """`refinedCostSymmetricDispFeatureVol` (:2352)."""
    from .cost_volume import aggregate_cost, extract_selected_index
    (cl, cr), (rl, rr) = _trait_volumes(func, fv_l, fv_r, pre_normalize)
    cv = aggregate_cost(func, cl, cr, search_range, direction)
    idx = extract_selected_index(cv, MATCH_TRAITS[func].strategy)
    return refine_cost_symmetric_disp(func, rl, rr, idx, search_range,
                                      direction, cost_volume=cv)


def refined_barycentric_2d_disp_fv(
        func, fv_l, fv_r, search, direction=DispDirection.RIGHT_TO_LEFT,
        pre_normalize: bool = False, test_sets_idxs=None):
    """`refinedBarycentric2dDispFeatureVol` (:2020) / subpart (:2108).
    ``search`` is a SearchOffset2; returns the refined (H, W, 2) flow."""
    from .cost_volume import (aggregate_cost, extract_selected_2d_index,
                              selected_2d_index_to_disp)
    (cl, cr), (rl, rr) = _trait_volumes(func, fv_l, fv_r, pre_normalize)
    cv = aggregate_cost(func, cl, cr, search, direction)
    idx = extract_selected_2d_index(cv, MATCH_TRAITS[func].strategy)
    d = selected_2d_index_to_disp(idx, search)
    src, tgt = _roles(direction, rl, rr)
    return refine_barycentric_2d_disp(func, src, tgt, d, search=search,
                                      test_sets_idxs=test_sets_idxs)


def refined_barycentric_symmetric_2d_disp_fv(
        func, fv_l, fv_r, search, contiguity: Contiguity = Contiguity.QUEEN,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False,
        test_sets_idxs=None):
    """`refinedBarycentricSymmetric2dDispFeatureVol` (:2187) / subpart
    (:2275)."""
    from .cost_volume import (aggregate_cost, extract_selected_2d_index,
                              selected_2d_index_to_disp)
    (cl, cr), (rl, rr) = _trait_volumes(func, fv_l, fv_r, pre_normalize)
    cv = aggregate_cost(func, cl, cr, search, direction)
    idx = extract_selected_2d_index(cv, MATCH_TRAITS[func].strategy)
    d = selected_2d_index_to_disp(idx, search)
    return refine_barycentric_symmetric_2d_disp(
        func, rl, rr, d, search, contiguity, direction, test_sets_idxs)


def _unfold_pair(img_l, img_r, h_radius, v_radius):
    from .unfold import unfold, unfold_sliding_subwindow_idxs
    fv_l = unfold(h_radius, v_radius, img_l)
    fv_r = unfold(h_radius, v_radius, img_r)
    channels = 1 if img_l.ndim == 2 else img_l.shape[2]
    sub = unfold_sliding_subwindow_idxs(h_radius, v_radius, h_radius + 1,
                                        v_radius + 1, channels)
    return fv_l, fv_r, sub


def refined_barycentric_symmetric_disp(
        func, img_l, img_r, h_radius: int, v_radius: int, search_range: int,
        refine_radius: int = 1, direction=DispDirection.RIGHT_TO_LEFT,
        pre_normalize: bool = False):
    """Image-level entry (`refinedBarycentricSymmetricDisp`, :2427):
    unfold both images, then cost volume + WTA + symmetric barycentric
    refinement; the sampling costs (MEDAD/ZMEDAD) automatically use the
    sliding-sub-window subpart solver (:2460-2467)."""
    fv_l, fv_r, sub = _unfold_pair(img_l, img_r, h_radius, v_radius)
    ts = sub if func in _SUBPART_FUNCS else None
    return refined_barycentric_symmetric_disp_fv(
        func, fv_l, fv_r, search_range, refine_radius, direction,
        pre_normalize, ts)


def refined_barycentric_disp(
        func, img_l, img_r, h_radius: int, v_radius: int, search_range: int,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False):
    """`refinedBarycentricDisp` (:2503)."""
    fv_l, fv_r, sub = _unfold_pair(img_l, img_r, h_radius, v_radius)
    ts = sub if func in _SUBPART_FUNCS else None
    return refined_barycentric_disp_fv(func, fv_l, fv_r, search_range,
                                       direction, pre_normalize, ts)


def refined_cost_symmetric_disp(
        func, img_l, img_r, h_radius: int, v_radius: int, search_range: int,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False):
    """`refinedCostSymmetricDisp` (:2574)."""
    from .unfold import unfold
    fv_l = unfold(h_radius, v_radius, img_l)
    fv_r = unfold(h_radius, v_radius, img_r)
    return refined_cost_symmetric_disp_fv(func, fv_l, fv_r, search_range,
                                          direction, pre_normalize)


def refined_barycentric_2d_disp(
        func, img_l, img_r, h_radius: int, v_radius: int, search,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False):
    """`refinedBarycentric2dDisp` (:2632)."""
    fv_l, fv_r, sub = _unfold_pair(img_l, img_r, h_radius, v_radius)
    ts = sub if func in _SUBPART_FUNCS else None
    return refined_barycentric_2d_disp_fv(func, fv_l, fv_r, search,
                                          direction, pre_normalize, ts)


def refined_barycentric_symmetric_2d_disp(
        func, img_l, img_r, h_radius: int, v_radius: int, search,
        contiguity: Contiguity = Contiguity.QUEEN,
        direction=DispDirection.RIGHT_TO_LEFT, pre_normalize: bool = False):
    """`refinedBarycentricSymmetric2dDisp` (:2714)."""
    fv_l, fv_r, sub = _unfold_pair(img_l, img_r, h_radius, v_radius)
    ts = sub if func in _SUBPART_FUNCS else None
    return refined_barycentric_symmetric_2d_disp_fv(
        func, fv_l, fv_r, search, contiguity, direction, pre_normalize, ts)
