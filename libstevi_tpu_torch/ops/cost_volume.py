"""Cost-volume construction and disparity extraction, the 1-D engine of
`libstevi_tpu/ops/cost_volume.py`.

Reference parity:
  * feature normalization — `channelsMean` (`correlation/correlation_base.h:1080`),
    `channelsNorm`/`channelsZeroMeanNorm` (`correlation/cross_correlations.h:36-191`),
    `getFeatureVolumeForMatchFunc` (`cross_correlations.h:647-722`);
  * aggregation — `aggregateCost` (`cross_correlations.h:195,252,311`): source /
    target roles from the disparity direction (`condImgRef`,
    `correlation_base.h:824-878`; RIGHT_TO_LEFT means source = right image and
    target sampled at ``j + d``), out-of-range target feature vectors are all
    zeros;
  * umbrella entries — `featureVolume2CostVolume` (:724),
    `unfoldBasedCostVolume` (:740), `unfoldBased2dDisparityCostVolume` (:794);
  * WTA extraction — `extractSelectedIndex`/`extractSelected2dIndex`
    (`correlation_base.h:428,467`; ties break toward the LAST optimal index
    because the reference uses `<=` / `>=`), `selectedIndexToDisp` (:512),
    `selected2dIndexToDisp` (:534), `selectedCost` (:557),
    `truncatedCostVolume` (:582), `truncatedBidirectionaCostVolume` (:679),
    `extractInBoundDomain` (:730).

Dispatch follows the JAX package, with "the tensors are on CUDA" in place
of "the default backend is the TPU": `aggregate_cost` 'auto' launches K5
(`fv_backend`) for dot/ssd/sad on CUDA where its tile fits on chip and
takes the shifted-compare loop where it does not (`auto_backend`, as the
JAX package falls back past its VMEM budget), and `unfold_based_cost_volume`
'auto' launches K1 (`box_cuda`) for a dot-family cost and the census
kernel (`census_cuda`) for CENSUS on gray images, RIGHT_TO_LEFT over
[0, D).  A 2-D (SearchOffset2) search is a loop of
shifted compares over the (d0, d1) grid on either device, as it is XLA in
the JAX package.
"""

from __future__ import annotations

import functools

import torch

from ..core.types import (MatchingFunction, MATCH_TRAITS, ExtractionStrategy,
                          DispDirection, TruncatedCvDirection, disp_dtype)
from ..core.search import SearchOffset1, SearchOffset2
from .box_backend import (DOT_FAMILY, box_cost_volume, disparities,
                          supports_box)
from .census import census_features
from .fv_backend import (FUSABLE_KERNELS, fused_fits,
                         fused_fv_cost_volume, shifted_compare)
from .matching import feature_comparison
from .unfold import unfold
from ..utils.profiling import span

# ---------------------------------------------------------------------------
# Feature-volume normalization
# ---------------------------------------------------------------------------

def channels_mean(fv: torch.Tensor) -> torch.Tensor:
    """Per-pixel mean over the feature axis (`correlation_base.h:1080`)."""
    return torch.mean(fv, dim=-1)


def channels_norm(fv: torch.Tensor) -> torch.Tensor:
    """Per-pixel L2 norm over the feature axis (`cross_correlations.h:124-191`)."""
    return torch.sqrt(torch.sum(fv * fv, dim=-1))


def channels_zero_mean_norm(fv: torch.Tensor,
                            mean: torch.Tensor | None = None) -> torch.Tensor:
    """Per-pixel L2 norm of the mean-subtracted features
    (`cross_correlations.h:36-122`)."""
    if mean is None:
        mean = channels_mean(fv)
    d = fv - mean[..., None]
    return torch.sqrt(torch.sum(d * d, dim=-1))


def normalize_feature_volume(func: MatchingFunction,
                             fv: torch.Tensor) -> torch.Tensor:
    """Apply the zero-mean / normalization / census preprocessing a matching
    function requires (`getFeatureVolumeForMatchFunc`,
    `cross_correlations.h:647-722`)."""
    traits = MATCH_TRAITS[func]
    fv = fv.float() if not traits.census else fv
    if traits.zero_mean and traits.normalized:
        mean = channels_mean(fv)
        sigma = channels_zero_mean_norm(fv, mean)
        fv = (fv - mean[..., None]) / sigma[..., None]
    elif traits.zero_mean:
        fv = fv - channels_mean(fv)[..., None]
    elif traits.normalized:
        fv = fv / channels_norm(fv)[..., None]
    if traits.census:
        fv = census_features(fv)
    return fv


# ---------------------------------------------------------------------------
# Aggregation
# ---------------------------------------------------------------------------

def _source_target(func_dir: DispDirection, fv_l: torch.Tensor,
                   fv_r: torch.Tensor):
    """`condImgRef` role assignment (`correlation_base.h:824-878`)."""
    if func_dir is DispDirection.RIGHT_TO_LEFT:
        return fv_r, fv_l
    return fv_l, fv_r


def _shifted_compare_scan(func: MatchingFunction, source_fv: torch.Tensor,
                          target_fv: torch.Tensor, shifts,
                          cv_dtype) -> torch.Tensor:
    """(H, W, D): cost[i, j, d] = compare(source[i, j, :],
    target[i, j + shifts[d], :]) with zero target features out of range.
    K5's plain version for dot/ssd/sad and the only route for
    medad/hamming/kermi."""
    return shifted_compare(functools.partial(feature_comparison, func),
                           source_fv, target_fv, shifts, cv_dtype)


def auto_backend(kernel: str, cuda: bool, shape, shifts) -> str:
    """'auto''s choice for source volumes of ``shape`` (on a CUDA device
    when ``cuda``): 'fused' (K5) for a dot/SSD/SAD family over (H, W, F)
    volumes whose K5 tile fits one block's shared memory
    (`fv_backend.fused_fits`), else 'scan' (the JAX package's 'auto' falls
    back to its scan past its VMEM budget, `libstevi_tpu/ops/
    cost_volume.py:181-191`)."""
    if (cuda and kernel in FUSABLE_KERNELS and len(shape) == 3
            and fused_fits(shape[-1], shifts)):
        return "fused"
    return "scan"


def _aggregate_2d(func: MatchingFunction, source_fv: torch.Tensor,
                  target_fv: torch.Tensor, search: SearchOffset2,
                  cv_dtype) -> torch.Tensor:
    """(H, W, D0, D1): cost[i, j, a, b] = compare(source[i, j],
    target[i + lower0 + a, j + lower1 + b]), zero target features out of
    range; one aligned slice of a zero-padded target per (d0, d1)."""
    H, W, _ = source_fv.shape
    off0, off1 = max(0, -search.lower0), max(0, -search.lower1)
    padded = torch.nn.functional.pad(
        target_fv, (0, 0, off1, max(0, search.upper1),
                    off0, max(0, search.upper0)))
    out = torch.empty((H, W, search.count0, search.count1), dtype=cv_dtype,
                      device=source_fv.device)
    for a in range(search.count0):
        i0 = off0 + search.lower0 + a
        for b in range(search.count1):
            j0 = off1 + search.lower1 + b
            out[:, :, a, b] = feature_comparison(
                func, source_fv, padded[i0:i0 + H, j0:j0 + W])
    return out


def aggregate_cost(func: MatchingFunction, fv_l: torch.Tensor,
                   fv_r: torch.Tensor, search,
                   direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                   cv_dtype=torch.float32, backend: str = "auto") -> torch.Tensor:
    """Build a cost volume from two *already normalized* feature volumes
    (`aggregateCost`, `cross_correlations.h:195,252,311`): (H, W, D) over a
    1-D search (int width or SearchOffset1), (H, W, D0, D1) over a 2-D one
    (SearchOffset2; target sampled at (i + d0, j + d1), the direction's
    sign ignored as in the reference's 2-D overload,
    `cross_correlations.h:359`).

    ``backend='auto'`` launches K5 for the dot/SSD/SAD families on CUDA
    tensors where its tile fits on chip and takes the shifted-compare loop
    otherwise (`auto_backend`); 'scan' forces the loop, 'fused' forces K5
    (its plain version on CPU tensors; it raises where the tile does not
    fit).  A 2-D search always takes the loop."""
    source_fv, target_fv = _source_target(direction, fv_l, fv_r)
    if isinstance(search, SearchOffset2):
        return _aggregate_2d(func, source_fv, target_fv, search, cv_dtype)
    if backend not in ("auto", "scan", "fused"):
        raise ValueError(f"backend {backend!r}: 'auto', 'scan' or 'fused'")
    shifts = [direction.delta_sign * d for d in disparities(search)]
    kernel = MATCH_TRAITS[func].kernel
    if backend == "auto":
        backend = auto_backend(kernel, source_fv.is_cuda,
                               source_fv.shape, shifts)
    if backend == "fused":
        return fused_fv_cost_volume(kernel, source_fv, target_fv, shifts,
                                    cv_dtype)
    return _shifted_compare_scan(func, source_fv, target_fv, shifts, cv_dtype)


def feature_volume_to_cost_volume(func: MatchingFunction, fv_l: torch.Tensor,
                                  fv_r: torch.Tensor, search,
                                  direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                                  cv_dtype=torch.float32,
                                  backend: str = "auto") -> torch.Tensor:
    """Normalize per the matching function's traits, then aggregate
    (`featureVolume2CostVolume`, `cross_correlations.h:724-738`)."""
    return aggregate_cost(func,
                          normalize_feature_volume(func, fv_l),
                          normalize_feature_volume(func, fv_r),
                          search, direction, cv_dtype, backend=backend)


def volume_kernel(func, img_l, search,
                  direction=DispDirection.RIGHT_TO_LEFT,
                  cv_dtype=torch.float32):
    """The port's kernel that builds this 1-D volume, and its D: ``("k1",
    D)`` (K1, `box_cuda.box_cv`) for a dot-family cost, ``("census", D)``
    (`census_cuda.census_cv`) for CENSUS, on gray images, RIGHT_TO_LEFT
    over [0, D), into a float32 or bfloat16 volume; None otherwise.  The
    one rule `unfold_based_cost_volume` and `sgm.dense_sgm_stereo` follow."""
    if func in DOT_FAMILY:
        kernel = "k1"
    elif func is MatchingFunction.CENSUS:
        kernel = "census"
    else:
        return None
    if (img_l.ndim != 2 or direction is not DispDirection.RIGHT_TO_LEFT
            or cv_dtype not in (torch.float32, torch.bfloat16)
            or isinstance(search, SearchOffset2)):
        return None
    if isinstance(search, SearchOffset1):
        return (kernel, search.upper + 1) if search.lower == 0 else None
    return kernel, int(search)


def kernel_cost_volume(kernel: str, func: MatchingFunction,
                       img_l: torch.Tensor, img_r: torch.Tensor,
                       h_radius: int, v_radius: int, disp_width: int,
                       cv_dtype=torch.float32, *, negate: bool = False,
                       out: torch.Tensor | None = None) -> torch.Tensor:
    """The (H, W, D) volume from the kernel `volume_kernel` named, inside
    the span ``stevi.<kernel>`` (on CPU tensors its wrapper runs the plain
    version).  ``negate`` (K1 only) stores a SCORE volume as costs;
    ``out`` receives the volume."""
    if kernel == "k1":
        from .box_cuda import box_cv
        with span("stevi.k1"):
            return box_cv(func, img_l, img_r, h_radius, v_radius, disp_width,
                          cv_dtype, negate=negate, out=out)
    from .census_cuda import census_cv
    with span("stevi.census"):
        return census_cv(img_l, img_r, h_radius, v_radius, disp_width,
                         cv_dtype, out=out)


def unfold_based_cost_volume(func: MatchingFunction, img_l: torch.Tensor,
                             img_r: torch.Tensor, h_radius: int, v_radius: int,
                             search,
                             direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                             cv_dtype=torch.float32,
                             backend: str = "auto") -> torch.Tensor:
    """(H, W, D) cost volume (or (H, W, D0, D1) over a SearchOffset2):
    unfold -> normalize -> aggregate (`unfoldBasedCostVolume`,
    `cross_correlations.h:740-765`), or the box decomposition for the
    window-decomposable functions over a 1-D search.

    ``backend``: 'auto' takes the box route when the function supports it
    and the search is 1-D, the unfold route otherwise; 'box' forces the box
    route (K1 where `volume_kernel` picks it on CUDA, `box_backend`
    otherwise; it raises on a 2-D search, as the JAX package's does);
    'unfold' forces unfold + the shifted-compare loop.  On the unfold route
    under 'auto', `aggregate_cost` launches K5 for the dot/SSD/SAD families
    on CUDA, and CENSUS takes the census kernel where `volume_kernel`
    picks it on CUDA (the same volume from the images' float32 values)."""
    if backend not in ("auto", "box", "unfold"):
        raise ValueError(f"backend {backend!r}: 'auto', 'box' or 'unfold'")
    auto = backend == "auto"
    if auto:
        backend = ("box" if supports_box(func)
                   and not isinstance(search, SearchOffset2) else "unfold")
    picked = (volume_kernel(func, img_l, search, direction, cv_dtype)
              if img_l.is_cuda else None)
    if backend == "box":
        if picked is not None and picked[0] == "k1":
            return kernel_cost_volume("k1", func, img_l, img_r,
                                      h_radius, v_radius, picked[1], cv_dtype)
        return box_cost_volume(func, img_l, img_r, h_radius, v_radius, search,
                               direction, cv_dtype)
    if auto and picked is not None and picked[0] == "census":
        return kernel_cost_volume("census", func, img_l, img_r, h_radius,
                                  v_radius, picked[1], cv_dtype)
    fv_l = unfold(h_radius, v_radius, img_l)
    fv_r = unfold(h_radius, v_radius, img_r)
    # 'unfold' forces the loop; 'auto' lets aggregate_cost launch K5
    return feature_volume_to_cost_volume(
        func, fv_l, fv_r, search, direction, cv_dtype,
        backend="auto" if auto else "scan")


def unfold_based_2d_disparity_cost_volume(
        func: MatchingFunction, img_l: torch.Tensor, img_r: torch.Tensor,
        h_radius: int, v_radius: int, search: SearchOffset2,
        direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
        cv_dtype=torch.float32) -> torch.Tensor:
    """2-D (optical-flow style) cost volume (H, W, D0, D1)
    (`unfoldBased2dDisparityCostVolume`, `cross_correlations.h:794-822`)."""
    fv_l = unfold(h_radius, v_radius, img_l)
    fv_r = unfold(h_radius, v_radius, img_r)
    return feature_volume_to_cost_volume(func, fv_l, fv_r, search,
                                         direction, cv_dtype)


def extract_selected_index(cv: torch.Tensor,
                           strategy: ExtractionStrategy) -> torch.Tensor:
    """WTA argmin (COST) / argmax (SCORE) over the last axis, ties toward
    the LAST optimal index (`correlation_base.h:428-464`): torch's argmin
    and argmax return the first optimum, so they run on the flipped axis."""
    D = cv.shape[-1]
    flipped = torch.flip(cv, dims=(-1,))
    if strategy is ExtractionStrategy.COST:
        idx = torch.argmin(flipped, dim=-1)
    else:
        idx = torch.argmax(flipped, dim=-1)
    return (D - 1 - idx).to(disp_dtype)


def extract_selected_2d_index(cv: torch.Tensor,
                              strategy: ExtractionStrategy) -> torch.Tensor:
    """WTA over the last two axes of an (H, W, D0, D1) cost volume, ties
    toward the last (d0, d1) in row-major scan order
    (`extractSelected2dIndex`, `correlation_base.h:467-509`): (H, W, 2)
    int32 indices."""
    H, W, D0, D1 = cv.shape
    flat = torch.flip(cv.reshape(H, W, D0 * D1), dims=(-1,))
    if strategy is ExtractionStrategy.COST:
        idx = torch.argmin(flat, dim=-1)
    else:
        idx = torch.argmax(flat, dim=-1)
    idx = D0 * D1 - 1 - idx
    return torch.stack([idx // D1, idx % D1], dim=-1).to(disp_dtype)


def selected_index_to_disp(selected_index: torch.Tensor,
                           direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                           disp_offset: int = 0) -> torch.Tensor:
    """disp = delta_sign * index + offset (`selectedIndexToDisp`,
    `correlation_base.h:511-532`)."""
    return direction.delta_sign * selected_index + disp_offset


def selected_2d_index_to_disp(selected_index: torch.Tensor,
                              search: SearchOffset2) -> torch.Tensor:
    """(`selected2dIndexToDisp`, `correlation_base.h:534-555`)."""
    offs = torch.tensor([search.lower0, search.lower1],
                        dtype=selected_index.dtype,
                        device=selected_index.device)
    return selected_index + offs


def _gather_disp(cv: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """cv[i, j, p[i, j]] with p clipped (validity handled by the caller)."""
    pc = p.clamp(0, cv.shape[-1] - 1).long()
    return torch.gather(cv, -1, pc[..., None])[..., 0]


def selected_cost(cv: torch.Tensor, selected_index: torch.Tensor) -> torch.Tensor:
    """Cost value at the selected index (`selectedCost`,
    `correlation_base.h:557-577`)."""
    return _gather_disp(cv, selected_index)


def same_slot_valid(p: torch.Tensor, H: int, W: int, D: int, h_radius: int,
                    v_radius: int) -> torch.Tensor:
    """Validity of a SAME-mode band slot sampling disparity index ``p`` at
    every pixel (`correlation_base.h:602-670`, verbatim): in range, and
    the source and target windows inside the image."""
    ii = torch.arange(H, device=p.device)[:, None]
    jj = torch.arange(W, device=p.device)[None, :]
    return ((p >= 0) & (p < D) & (jj >= h_radius) & (jj + p + h_radius < W)
            & (ii >= v_radius) & (ii + v_radius < H))


def reversed_slot_valid(p: torch.Tensor, k: int, r: int, sgn: int, H: int,
                        W: int, D: int, h_radius: int,
                        v_radius: int) -> torch.Tensor:
    """Validity of a REVERSED-mode band slot k (sampling cv[i, j + sgn *
    (k - r), p]) at every pixel (`correlation_base.h:602-670`, verbatim):
    only the source-window bounds of the shifted pixel are checked, not
    the sampled entry's own target window."""
    ii = torch.arange(H, device=p.device)[:, None]
    jj = torch.arange(W, device=p.device)[None, :]
    jp = jj + sgn * (k - r)
    return ((p >= 0) & (p < D) & (torch.minimum(jp, jj) >= h_radius)
            & (torch.maximum(jp, jj) + h_radius < W)
            & (ii >= v_radius) & (ii + v_radius < H))


def _band_slots(sdir: TruncatedCvDirection, r: int, same, reversed_):
    """The slots of a band in the reference's order: SAME k = 0..2r,
    REVERSED likewise, BOTH interleaved (slots 2k direct, 2k + 1 reversed;
    the center shares one slot, the reversed sample being invalid there by
    the reference's jp = -1, `correlation_base.h:643-650`)."""
    if sdir is TruncatedCvDirection.SAME:
        return [same(k) for k in range(2 * r + 1)]
    if sdir is TruncatedCvDirection.REVERSED:
        return [reversed_(k) for k in range(2 * r + 1)]
    slots = [None] * (4 * r + 1)
    for k in range(2 * r + 1):
        slots[2 * k if k <= r else 2 * k - 1] = same(k)
        if k != r:
            slots[2 * k + 1 if k < r else 2 * k] = reversed_(k)
    return slots


def truncated_cost_volume(cv: torch.Tensor, selected_index: torch.Tensor,
                          h_radius: int, v_radius: int, cost_vol_radius: int,
                          direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                          sdir: TruncatedCvDirection = TruncatedCvDirection.SAME
                          ) -> torch.Tensor:
    """Band around the selected disparity, NaN outside the validity bounds
    (`truncatedCostVolume`, `correlation_base.h:582-674`).

    SAME samples cv[i, j, sel+k] into (H, W, 2r+1); REVERSED samples
    cv[i, j+sgn*k, sel+k] (sgn = -1 for RIGHT_TO_LEFT); BOTH interleaves
    the two (4r+1 slots, direct/reversed pairs sharing the center slot).
    Validity replicates the reference's conditions verbatim, including two
    quirks: the SAME bound ``j + p + h_radius < W`` is
    direction-independent, and REVERSED slots check only the source-window
    bounds of the shifted pixel."""
    H, W, D = cv.shape
    r = cost_vol_radius
    sgn = -1 if direction is DispDirection.RIGHT_TO_LEFT else 1

    def same(k):
        p = selected_index + (k - r)
        valid = same_slot_valid(p, H, W, D, h_radius, v_radius)
        return torch.where(valid, _gather_disp(cv, p), float("nan"))

    def reversed_(k):
        p = selected_index + (k - r)
        valid = reversed_slot_valid(p, k, r, sgn, H, W, D, h_radius, v_radius)
        # cv shifted by the static offset sgn*(k-r) along W (the wrapped
        # columns are never valid)
        shifted = torch.roll(cv, -sgn * (k - r), dims=1)
        return torch.where(valid, _gather_disp(shifted, p), float("nan"))

    return torch.stack(_band_slots(sdir, r, same, reversed_), dim=-1)


def truncated_bidirectional_cost_volume(cv: torch.Tensor,
                                        selected_index: torch.Tensor,
                                        radius0: int = 1, radius1: int = 1
                                        ) -> torch.Tensor:
    """Truncated (H, W, 2r0+1, 2r1+1) window of a 4-D (H, W, D0, D1) cost
    volume around the selected 2-D index, NaN out of range
    (`truncatedBidirectionaCostVolume`, `correlation_base.h:679-725`)."""
    H, W, D0, D1 = cv.shape
    r0 = max(1, radius0)
    r1 = radius1 if radius1 >= 1 else r0
    sel0, sel1 = selected_index[..., 0], selected_index[..., 1]
    flat = cv.reshape(H, W, D0 * D1)
    rows = []
    for k0 in range(2 * r0 + 1):
        row = []
        for k1 in range(2 * r1 + 1):
            p0 = sel0 + (k0 - r0)
            p1 = sel1 + (k1 - r1)
            valid = (p0 >= 0) & (p0 < D0) & (p1 >= 0) & (p1 < D1)
            lin = p0.clamp(0, D0 - 1) * D1 + p1.clamp(0, D1 - 1)
            row.append(torch.where(valid, _gather_disp(flat, lin),
                                   float("nan")))
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def extract_in_bound_domain(selected_index: torch.Tensor, width: int,
                            h_radius: int, v_radius: int, cost_vol_radius: int,
                            direction: DispDirection = DispDirection.RIGHT_TO_LEFT,
                            sdir: TruncatedCvDirection = TruncatedCvDirection.SAME,
                            dtype=torch.int32) -> torch.Tensor:
    """Binary validity mask matching `truncated_cost_volume`'s slots
    (`extractInBoundDomain`, `correlation_base.h:730-820`)."""
    H, W = selected_index.shape
    r = cost_vol_radius
    sgn = -1 if direction is DispDirection.RIGHT_TO_LEFT else 1

    def same(k):
        return same_slot_valid(selected_index + (k - r), H, W, width,
                               h_radius, v_radius)

    def reversed_(k):
        return reversed_slot_valid(selected_index + (k - r), k, r, sgn, H, W,
                                   width, h_radius, v_radius)

    return torch.stack(_band_slots(sdir, r, same, reversed_),
                       dim=-1).to(dtype)
