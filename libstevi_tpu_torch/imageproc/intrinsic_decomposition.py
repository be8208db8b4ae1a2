"""Intrinsic image decomposition (Retinex with a non-local texture
constraint; counterpart of `libstevi_tpu/imageproc/intrinsic_decomposition.py`).

Reference parity: `imageProcessing/intrinsicImageDecomposition.h` —

  * `retinex_with_nonlocal_texture_constraint` (:60-545): solve a single
    per-pixel log-shading scalar s from three quadratic constraint
    groups —
      - retinex: for every 4-neighbour pair, shading varies freely where
        the log-chromaticity differs (a reflectance edge) and must track
        the full log-intensity difference where it does not
        (weight ``reflectance_to_shading_weight``);
      - non-local texture: pixels whose 3x3 chromaticity patch matches
        another patch in any of the four 90-degree orientations (SSD
        below ``grouping_threshold``) are clustered; each cluster gets a
        median 7x7 patch, members are weighted by how far out (3x3 /
        5x5 / 7x7) they match that median, and consecutive members are
        chained with shading-difference-equals-intensity-difference
        constraints;
      - scaling: the brightest pixels (>= 0.95 of the max) anchor the
        log-shading at e.
  * `auto_retinex_with_nonlocal_texture_constraint` (:548-608): sweep 12
    chromaticity thresholds and keep the decomposition whose shading
    histogram has minimal entropy.
  * `perform_intrinsic_image_decomposition` (:610-646) is an UNFINISHED
    stub in the reference (computes a pixel count and returns nothing);
    here it is the convenience entry dispatching gray images to an FFT
    retinex split and RGB images to the non-local texture solver.

Design, as in the JAX package: the reference's Eigen sparse system
becomes a matrix-free operator — the retinex term is a 4-neighbour
weighted Laplacian applied with rolls, the scale term a diagonal, and the
texture chains a fixed-size scatter-add (`index_add_`) — solved with
Jacobi-preconditioned CG on the image's device.  The JAX package's
jit-compiled 600 fixed iterations become a Python loop of tensor ops with
no host read inside it.  The O(N^2) greedy patch clustering (same
asymptotics as the reference's forward-list walk) runs on the host: the
JAX package's numpy code, copied with its float32 arithmetic, so the
chains are the same.  `retinex_fft` is `torch.fft` and the port's
`optim.l0.l0_smoothing`.

Documented deviations:
  * :262-266 compares `fVecs[0]` for all four orientations (the rotated
    patches are built but unused, so minOrientation is always Rotate0);
    we compare each orientation, the stated intent.
  * :400 stops the chain loop at size-2 so the last group member never
    constrains; we chain all consecutive members.
  * group medians use the even-count mean convention (np.nanmedian)
    instead of nth_element's lower median.
  * `histogram.h:321` "entropy" is a sum of squared counts; the auto
    variant here minimizes Shannon entropy (see
    `histogram.Histogram.entropy`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..optim.l0 import l0_smoothing
from .histogram import Histogram


@dataclass
class IntrinsicDecomposition:
    reflectance: torch.Tensor
    shading: torch.Tensor


def _host(x) -> np.ndarray:
    """A float32 numpy copy of an array or a tensor on any device."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _rot_offsets(d0, d1, o):
    """`correlation/unfold.h:153-169` center-relative rotated offsets."""
    if o == 0:
        return d0, d1
    if o == 1:
        return -d1, d0
    if o == 2:
        return -d0, -d1
    return d1, -d0


def _rg_chromaticity(log_img: np.ndarray) -> np.ndarray:
    """`colorConversions.h:138` on the log image: (r, g) normalized by the
    mean intensity, non-finite ratios zeroed."""
    it = log_img.mean(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        nr = log_img[..., 0] / it
        ng = log_img[..., 1] / it
    out = np.stack([nr, ng], -1)
    out[~np.isfinite(out)] = 0.0
    return out.astype(np.float32)


def _patch_stack(chroma: np.ndarray, radius: int, orients: np.ndarray,
                 pts: np.ndarray) -> np.ndarray:
    """Sample (n, (2r+1)^2 * 2) patch features at pixel rows ``pts``
    (flat (n, 2) int coords), each in its own orientation (offsets
    rotated per `rotatedOffsetsFromOrientation`), indices edge-clamped."""
    H, W, _ = chroma.shape
    feats = []
    for d0 in range(-radius, radius + 1):
        for d1 in range(-radius, radius + 1):
            vals = np.empty((len(pts), 2), np.float32)
            for o in range(4):
                m = orients == o
                if not m.any():
                    continue
                di, dj = _rot_offsets(d0, d1, o)
                ii = np.clip(pts[m, 0] + di, 0, H - 1)
                jj = np.clip(pts[m, 1] + dj, 0, W - 1)
                vals[m] = chroma[ii, jj]
            feats.append(vals)
    return np.concatenate(feats, axis=1)


def _texture_chains(chroma: np.ndarray, log_img: np.ndarray,
                    grouping_threshold: float):
    """Greedy non-local patch clustering + chain constraint assembly
    (`intrinsicImageDecomposition.h:265-464`).  Returns flat index pairs
    (p, i) with their A-coefficients (3 * 2 cp cq) and b values
    (2 cp cq * sum_c dlogI)."""
    H, W, _ = chroma.shape
    r = 1
    if H <= 2 * r or W <= 2 * r:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),) * 2

    ii, jj = np.mgrid[r:H - r, r:W - r]
    pts = np.stack([ii.ravel(), jj.ravel()], 1)         # raster order
    n = len(pts)
    f_by_o = [
        _patch_stack(chroma, r, np.full(n, o, np.int32), pts)
        for o in range(4)
    ]                                                    # (4, n, 18)
    f0 = f_by_o[0]
    nf = f0.shape[1]

    owner = np.full(n, -1, np.int64)                     # cluster root
    orient = np.zeros(n, np.int32)
    alive = np.ones(n, bool)
    for s in range(n):
        alive[s] = False
        cand = np.nonzero(alive)[0]
        if cand.size == 0:
            if owner[s] < 0:
                owner[s] = s
            continue
        # each orientation of the current patch vs the candidates' R0
        costs = np.stack([
            ((f0[cand] - f_by_o[o][s][None]) ** 2).mean(1)
            for o in range(4)
        ])                                               # (4, ncand)
        best_o = costs.argmin(0)
        best_c = costs.min(0)
        hit = cand[best_c < grouping_threshold]
        root = owner[s] if owner[s] >= 0 else s
        if owner[s] < 0:
            owner[s] = s
        owner[hit] = root
        # member-R0 ~ seed-R(o), so sampling the member at R(4-o) lands
        # in the seed's frame; compose with the seed's own root-relative
        # orientation when the seed was itself absorbed earlier
        o_hit = best_o[best_c < grouping_threshold]
        orient[hit] = (orient[s] + 4 - o_hit) % 4
        alive[hit] = False

    pairs_p, pairs_i, coeffs = [], [], []
    roots = np.unique(owner)
    for g in roots:
        members = np.nonzero(owner == g)[0]              # raster order
        if len(members) <= 1:
            continue
        mo = orient[members]
        mp = pts[members]
        # group median 7x7 patch from orientation-aligned member windows
        p2r = r + 2
        side = 2 * p2r + 1
        samples = np.full((len(members), side, side, 2), np.nan,
                          np.float32)
        for o in range(4):
            sel = mo == o
            if not sel.any():
                continue
            for a, d0 in enumerate(range(-p2r, p2r + 1)):
                for b, d1 in enumerate(range(-p2r, p2r + 1)):
                    di, dj = _rot_offsets(d0, d1, o)
                    yi = mp[sel, 0] + di
                    xj = mp[sel, 1] + dj
                    ok = (yi >= 0) & (yi < H) & (xj >= 0) & (xj < W)
                    v = np.full((sel.sum(), 2), np.nan, np.float32)
                    v[ok] = chroma[yi[ok], xj[ok]]
                    samples[sel, a, b] = v
        median = np.nanmedian(samples, axis=0)           # (7, 7, 2)
        median = np.nan_to_num(median)

        # member weights cq = K (1 - gCost): K grows with the largest
        # window radius still matching the median below the threshold
        Kv = np.full(len(members), 3, np.float32)
        gcost = np.ones(len(members), np.float32)
        for rad, Kk in ((1, 3), (2, 5), (3, 7)):
            pf = _patch_stack(chroma, rad, mo, mp)
            mid = median[p2r - rad:p2r + rad + 1,
                         p2r - rad:p2r + rad + 1].reshape(-1)
            cost = ((pf - mid[None]) ** 2).mean(1)
            Kv = np.where(cost < grouping_threshold, Kk, Kv)
            gcost = np.minimum(gcost, cost)
        cq = Kv * (1.0 - gcost)

        flat = mp[:, 0] * W + mp[:, 1]
        for e in range(1, len(members)):
            pairs_p.append(flat[e - 1])
            pairs_i.append(flat[e])
            coeffs.append(2.0 * cq[e - 1] * cq[e])

    if not pairs_p:
        return (np.zeros(0, np.int64),) * 2 + (np.zeros(0, np.float32),) * 2
    pp = np.asarray(pairs_p)
    pi = np.asarray(pairs_i)
    co = np.asarray(coeffs, np.float32)
    dlog = log_img.reshape(-1, 3)
    bvals = co * (dlog[pi] - dlog[pp]).sum(1)
    return pp, pi, co, bvals


def retinex_with_nonlocal_texture_constraint(
        rgb_image: torch.Tensor, diff_threshold: float,
        lambda_retinex: float = 1.0, lambda_texture: float = 1.0,
        lambda_scaling: float = 1000.0,
        reflectance_to_shading_weight: float = 100.0,
        grouping_threshold: float = 0.01,
        cg_iters: int = 600, _chains=None) -> IntrinsicDecomposition:
    """Reference-parity non-local-texture retinex
    (`intrinsicImageDecomposition.h:60-545`) for an (H, W, 3) image.
    Returns linear-domain reflectance and shading with
    image = reflectance * shading, on the image's device (the CPU for a
    numpy array).  ``_chains`` lets the auto sweep reuse the
    (threshold-independent) texture clustering."""
    dev = rgb_image.device if isinstance(rgb_image, torch.Tensor) \
        else torch.device("cpu")
    img = _host(rgb_image)
    H, W, C = img.shape
    assert C == 3, "retinexWithNonLocalTextureConstraint expects RGB"
    log_img = np.log(np.maximum(img, 1e-8))   # reference takes a raw log;
    chroma = _rg_chromaticity(log_img)        # clamp guards log(0)

    pp, pi, co, bt = (_texture_chains(chroma, log_img, grouping_threshold)
                      if _chains is None else _chains)

    gray = img.mean(-1)
    bright = gray >= 0.95 * gray.max()

    log_i = torch.from_numpy(log_img).to(dev)
    ch = torch.from_numpy(chroma).to(dev)
    bright_t = torch.from_numpy(bright.astype(np.float32)).to(dev)
    pp_t = torch.from_numpy(np.asarray(pp, np.int64)).to(dev)
    pi_t = torch.from_numpy(np.asarray(pi, np.int64)).to(dev)
    co_t = torch.from_numpy(np.asarray(co, np.float32)).to(dev)
    bt_t = torch.from_numpy(np.asarray(bt, np.float32)).to(dev)
    chained = co_t.numel() > 0
    lr, lt, ls = (float(lambda_retinex), float(lambda_texture),
                  float(lambda_scaling))
    omega0 = float(reflectance_to_shading_weight)
    t2 = float(diff_threshold) ** 2

    shifts = ((-1, 0), (1, 0), (0, -1), (0, 1))

    ws, dls = [], []
    for di, dj in shifts:
        nb_ch = torch.roll(ch, (-di, -dj), (0, 1))
        nb_li = torch.roll(log_i, (-di, -dj), (0, 1))
        valid = torch.ones((H, W), dtype=torch.bool, device=dev)
        if di == -1:
            valid[0] = False
        if di == 1:
            valid[-1] = False
        if dj == -1:
            valid[:, 0] = False
        if dj == 1:
            valid[:, -1] = False
        dsq = torch.sum((ch - nb_ch) ** 2, -1)
        omega = torch.where(dsq > t2, 0.0, omega0)
        ws.append(torch.where(valid, 2.0 * 3 * (1.0 + omega), 0.0))
        dls.append(torch.where(valid, 2.0 * omega
                               * torch.sum(log_i - nb_li, -1), 0.0))

    def a_apply(s):
        out = torch.zeros_like(s)
        for (di, dj), w in zip(shifts, ws):
            nb = torch.roll(s, (-di, -dj), (0, 1))
            out = out + lr * w * (s - nb)
        out = out + ls * 2.0 * bright_t * s
        if chained:
            sf = s.reshape(-1)
            d = sf[pp_t] - sf[pi_t]
            upd = torch.zeros(H * W, dtype=s.dtype, device=dev)
            upd.index_add_(0, pp_t, lt * 3.0 * co_t * d)
            upd.index_add_(0, pi_t, -lt * 3.0 * co_t * d)
            out = out + upd.view(H, W)
        return out

    b = lr * sum(dls) + ls * 2.0 * float(np.e) * bright_t
    if chained:
        ub = torch.zeros(H * W, dtype=torch.float32, device=dev)
        ub.index_add_(0, pi_t, lt * bt_t)
        ub.index_add_(0, pp_t, -lt * bt_t)
        b = b + ub.view(H, W)

    # Jacobi preconditioner: the scale anchor is 1000x the Laplacian
    diag = lr * sum(ws) + ls * 2.0 * bright_t
    if chained:
        dg = torch.zeros(H * W, dtype=torch.float32, device=dev)
        dg.index_add_(0, pp_t, lt * 3.0 * co_t)
        dg.index_add_(0, pi_t, lt * 3.0 * co_t)
        diag = diag + dg.view(H, W)
    inv_d = 1.0 / torch.clamp(diag, min=1e-6)

    # Jacobi-preconditioned CG, ``cg_iters`` steps, no host read
    x = torch.zeros((H, W), dtype=torch.float32, device=dev)
    rr = b - a_apply(x)
    z = inv_d * rr
    p = z
    rz = torch.sum(rr * z)
    for _ in range(cg_iters):
        ap = a_apply(p)
        alpha = rz / torch.clamp(torch.sum(p * ap), min=1e-30)
        x = x + alpha * p
        rr = rr - alpha * ap
        z = inv_d * rr
        rz_new = torch.sum(rr * z)
        p = z + (rz_new / torch.clamp(rz, min=1e-30)) * p
        rz = rz_new

    log_s = x
    log_r = log_i - log_s[..., None]
    return IntrinsicDecomposition(
        torch.exp(log_r),
        torch.exp(log_s)[..., None] * torch.ones((1, 1, 3), device=dev))


def auto_retinex_with_nonlocal_texture_constraint(
        rgb_image: torch.Tensor, lambda_retinex: float = 1.0,
        lambda_texture: float = 1.0, lambda_scaling: float = 1000.0,
        reflectance_to_shading_weight: float = 100.0,
        grouping_threshold: float = 0.01, hist_bin_size: float = 1.0,
        min_val: float = 0.0, max_val: float = 255.0
        ) -> IntrinsicDecomposition:
    """Auto-tuned chromaticity threshold
    (`intrinsicImageDecomposition.h:548-608`): sweep 12 thresholds in
    [0, 0.005) and keep the decomposition whose shading histogram has
    minimal (Shannon) entropy (one host read a threshold)."""
    n_thresh = 12
    lo, hi = 1e-5, 5e-3
    bin_w = (hi - lo) / n_thresh
    n_bins = max(1, int(round((max_val - min_val) / hist_bin_size)))

    img = _host(rgb_image)
    log_img = np.log(np.maximum(img, 1e-8))
    chains = _texture_chains(_rg_chromaticity(log_img), log_img,
                             grouping_threshold)

    best, best_e = None, np.inf
    for i in range(n_thresh):
        cand = retinex_with_nonlocal_texture_constraint(
            rgb_image, lo + i * bin_w, lambda_retinex, lambda_texture,
            lambda_scaling, reflectance_to_shading_weight,
            grouping_threshold, _chains=chains)
        h = Histogram.compute(cand.shading[..., 0], n_bins,
                              vmin=min_val, vmax=max_val)
        e = float(h.entropy())
        if e < best_e:
            best, best_e = cand, e
    return best


def retinex_fft(image: torch.Tensor, gradient_threshold: float = 0.15,
                lam_reflectance: float = 0.02, eps: float = 1e-4
                ) -> IntrinsicDecomposition:
    """Gradient-threshold retinex with an FFT Poisson re-integration and
    an L0 piecewise-constant reflectance cleanup — the fast single-solve
    path for gray images (no reference equivalent; kept because the
    reference's generic `performIntrinsicImageDecomposition` is an
    unfinished stub, :610-646).  For an (H, W, 3) image the reflectance
    carries the chromaticity (the log image minus the log shading) and
    the L0 cleanup, whose result the JAX package discards there, is not
    run."""
    x = torch.clamp(image.float(), min=eps)
    log_i = torch.log(x)
    lum = log_i if log_i.ndim == 2 else torch.mean(log_i, -1)
    H, W = lum.shape

    # Even (mirrored) extension: the periodic FFT Poisson solve forbids any
    # net circulation, which would flatten linear shading ramps; on the
    # mirrored domain a ramp becomes a triangle wave and survives (Neumann
    # boundary via DFT).
    lum_m = torch.cat([torch.cat([lum, torch.flip(lum, (1,))], 1),
                       torch.cat([torch.flip(lum, (0,)),
                                  torch.flip(lum, (0, 1))], 1)], 0)
    Hm, Wm = 2 * H, 2 * W

    gx = torch.roll(lum_m, -1, 1) - lum_m
    gy = torch.roll(lum_m, -1, 0) - lum_m
    sx = torch.where(torch.abs(gx) < gradient_threshold, gx, 0.0)
    sy = torch.where(torch.abs(gy) < gradient_threshold, gy, 0.0)

    # Poisson: minimize ||grad s - (sx, sy)||^2 on the mirrored domain
    fx = torch.zeros((Hm, Wm), dtype=torch.complex64, device=x.device)
    fy = torch.zeros((Hm, Wm), dtype=torch.complex64, device=x.device)
    fx[0, 0], fx[0, Wm - 1] = -1, 1
    fy[0, 0], fy[Hm - 1, 0] = -1, 1
    otf_x = torch.fft.fft2(fx)
    otf_y = torch.fft.fft2(fy)
    denom = torch.abs(otf_x) ** 2 + torch.abs(otf_y) ** 2
    denom[0, 0] = 1.0
    F = (torch.conj(otf_x) * torch.fft.fft2(sx)
         + torch.conj(otf_y) * torch.fft.fft2(sy)) / denom
    F[0, 0] = torch.fft.fft2(lum_m)[0, 0]    # keep the mean in shading
    log_s = torch.real(torch.fft.ifft2(F))[:H, :W]

    if log_i.ndim == 3:
        # chromaticity rides with the reflectance
        return IntrinsicDecomposition(torch.exp(log_i - log_s[..., None]),
                                      torch.exp(log_s))
    log_r = l0_smoothing(lum - log_s, lam_reflectance)
    return IntrinsicDecomposition(torch.exp(log_r), torch.exp(log_s))


# round-1 name kept as an alias of the fast path
retinex_with_non_local_texture_constraint = retinex_fft


def perform_intrinsic_image_decomposition(image: torch.Tensor, **kw
                                          ) -> IntrinsicDecomposition:
    """Convenience entry: RGB images go through the reference non-local
    texture solver (auto threshold), everything else through the FFT
    retinex.  The reference's own generic entry
    (`performIntrinsicImageDecomposition`, :610-646) is an unfinished
    stub."""
    if image.ndim == 3 and image.shape[-1] == 3 and not kw:
        return auto_retinex_with_nonlocal_texture_constraint(image)
    return retinex_fft(image, **kw)
