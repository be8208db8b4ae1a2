"""Shape from shading (counterpart of
`libstevi_tpu/imageproc/shape_from_shading.py`).

Reference parity: `imageProcessing/shapeFromShading.h` —

  * `estimate_light_direction_from_shading` — `estimateLightDirection`
    (:1113): Gaussian low-pass, separable finite differences, principal
    gradient direction by SVD, sign from the intensity centroid, 45-degree
    elevation assumption.
  * `initial_normal_map_estimate` — `initialNormalMapEstimate` (:34):
    Sobel gradients, per-pixel quadratic for the two unit normals whose
    tangential direction follows the gradient, greedy selection by
    neighbour continuity with an upward-z preference.
  * `normal_map_from_single_shading_image` (:224) and
    `normal_map_from_intrinsic_decomposition` (:452): Gauss-Newton on the
    energy  ||<ld, n> - s||^2 + lambda_diff ||grad n||^2
    + lambda_norm (|n|^2-1)^2  (+ lambda_dir edge-alignment term for the
    decomposition variant), normalized output.
  * `rectify_normal_map` (:768), `height_from_normal_map` (:836),
    `flatten_height_map_in_area_of_interest` (:973).
  * `gradient_based_edges` — `edgesDetection.h:39` (quantile threshold on
    sign-aligned aggregated channel gradients).

Design, as in the JAX package: every solver is matrix-free — the
reference's Eigen sparse matrices (P, Dx, Dy, D, N) become stencil and
rank-1 operators on the image's device, and the sparse LU / CG solves
become conjugate-gradient loops.  The JAX `lax.while_loop`s become Python
loops that read the residual (CG) or the step norm (Gauss-Newton) on the
host once a step, their only host read; `jax.linear_transpose` of the
difference stencils becomes a hand-written adjoint of each (`_drT`,
`_dcT`, `_gxT`, `_gyT`).  The sequential greedy root selection of the
initial estimate is a loop over rows (the JAX `lax.scan`): rows are
selected in parallel against the final row above plus a provisional left
neighbour (two vectorized passes per row) instead of the reference's
strictly sequential raster order.  Products that are matmuls or einsums
in the JAX package are written as elementwise sums (no TF32 on a GPU);
the light direction's 2x2 eigenproblem is `torch.linalg.eigh`, its
eigenvector's arbitrary sign fixed by the centroid test as in JAX; the
edge threshold is `jnp.quantile`'s linear interpolation over a sort of
all values (no size limit; `torch.quantile` refuses more than 2^24).
`refine_normals` differentiates with `torch.autograd` where the JAX
package takes `jax.grad`.

Documented deviations (reference bugs fixed rather than replicated):
  * `shapeFromShading.h:293` flips the data-term sign (P -= ld), driving
    <ld, n> = -s; the decomposition variant (:526) uses the physical
    +ld.  We use + in both.
  * :331-359 accumulates BOTH axis differences into the same matrix Dx
    (Dy stays empty), penalizing ||d_row n + d_col n||^2; we penalize the
    two axis differences separately (the declared intent).
  * :385 writes the norm-penalty Hessian diagonal as 4*quadr + 8*x
    (missing a factor x); we use the exact Gauss-Newton term
    4*quadr*I + 8*n n^T.
  * :617-621 documents a 90-degree gradient rotation for the edge
    constraint but applies the unrotated gradient; we rotate, so the
    normal's tangential component aligns with the guide gradient.
  * :866 computes the y fallback sign from nx (copy-paste typo); we use
    ny.
  * :1080-1092 subtracts the pre-negation minimum after the convexity
    flip; we re-derive the minimum of the returned values.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .convolutions import PaddingInfos, PaddingType, convolve_2d
from .filters import (extend_linear_kernel, finite_differences_kernel,
                      gaussian_filter_taps)

_PM1 = PaddingInfos(1, mode=PaddingType.MIRROR)
_P0 = PaddingInfos(0)


def _t(x, dev) -> torch.Tensor:
    """``x`` (a tensor, array or sequence) as float32 on ``dev``."""
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float32, device=dev)


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """`jnp.linalg.norm(x, axis=-1)`: the root of the sum of squares."""
    return torch.sqrt(torch.sum(x * x, -1, keepdim=keepdim))


def _ref_gradients(img: torch.Tensor):
    """The reference gradient pair (`shapeFromShading.h:49-74`,
    `edgesDetection.h:47-71`): correlation with the two smoothed
    difference kernels; channel 0 differentiates along columns, channel 1
    along rows (both negated forward-central, as in the reference)."""
    k0 = torch.tensor([[1., 0., -1.], [2., 0., -2.], [1., 0., -1.]],
                      device=img.device)
    k1 = torch.tensor([[1., 2., 1.], [0., 0., 0.], [-1., -2., -1.]],
                      device=img.device)
    pads = (_PM1, _PM1)
    return convolve_2d(img, k0, pads), convolve_2d(img, k1, pads)


# ---------------------------------------------------------------------------
# Light direction
# ---------------------------------------------------------------------------

def estimate_light_direction_from_shading(shading: torch.Tensor,
                                          low_pass_radius: int = 3
                                          ) -> torch.Tensor:
    """Estimate the (3,) light direction from a single shading image
    (`shapeFromShading.h:1113`): principal direction of the smoothed
    image gradients, oriented toward the intensity centroid, with unit z
    (45-degree elevation)."""
    s = shading.float()
    dev = s.device
    H, W = s.shape
    if low_pass_radius >= 1:
        sigma = float(low_pass_radius + 1) / 2
        taps = torch.from_numpy(gaussian_filter_taps(
            sigma, low_pass_radius, normalize=False)).to(dev)
        pad = PaddingInfos(low_pass_radius, mode=PaddingType.MIRROR)
        lp = convolve_2d(s, taps[:, None], (pad, _P0))
        lp = convolve_2d(lp, taps[None, :], (_P0, pad))
    else:
        lp = s
    fd = torch.from_numpy(finite_differences_kernel()).to(dev)
    el = torch.from_numpy(extend_linear_kernel()).to(dev)
    d0 = convolve_2d(lp, fd[:, None], (_PM1, _P0))
    d0 = convolve_2d(d0, el[None, :], (_P0, _PM1))
    d1 = convolve_2d(lp, el[:, None], (_PM1, _P0))
    d1 = convolve_2d(d1, fd[None, :], (_P0, _PM1))

    # principal right-singular vector of the (N, 2) gradient matrix: the
    # top eigenvector of its 2x2 Gram matrix (sums, not a matmul)
    c01 = torch.sum(d0 * d1)
    gram = torch.stack([torch.stack([torch.sum(d0 * d0), c01]),
                        torch.stack([c01, torch.sum(d1 * d1)])])
    _, vecs = torch.linalg.eigh(gram)
    direction = vecs[:, -1]
    direction = direction / _norm(direction)

    ii = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    jj = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    wsum = torch.sum(lp)
    centroid = torch.stack([torch.sum(ii * lp), torch.sum(jj * lp)]) / wsum
    centroid = centroid - torch.tensor([H, W], dtype=torch.float32,
                                       device=dev) / 2
    # the eigenvector's sign is arbitrary: the centroid test fixes it
    direction = torch.where(torch.sum(direction * centroid) < 0,
                            -direction, direction)
    # light opposes the gradient; first image axis is y; 45-degree z
    return torch.stack([-direction[1], direction[0], _norm(direction)])


# ---------------------------------------------------------------------------
# Initial estimate
# ---------------------------------------------------------------------------

def initial_normal_map_estimate(shading: torch.Tensor, light
                                ) -> torch.Tensor:
    """Per-pixel two-root normal candidates + greedy continuity selection
    (`shapeFromShading.h:34-221`).  The light is rescaled so the maximum
    shading maps to a fronto-parallel surface; each pixel solves the
    quadratic for the unit normal whose tangential part follows the local
    gradient; the root closer to the already-selected neighbours wins,
    with a z >= 0 override.  One row a step (the JAX `lax.scan`)."""
    s = shading.float()
    H, W = s.shape
    ld = _t(light, s.device)
    ld = ld / _norm(ld) * torch.max(s)

    gx, gy = _ref_gradients(s)
    branch = torch.abs(gx) < torch.abs(gy)      # v parameterizes y else x
    raw = torch.where(branch, gx / gy, gy / gx)
    scale = torch.where(torch.isfinite(raw), raw, 1.0)
    lv = torch.where(branch, scale * ld[0] + ld[1], scale * ld[1] + ld[0])
    tr = -lv / ld[2]                            # z = tr * v + s
    a = tr * tr + scale * scale + 1.0           # |n| = 1 quadratic in v
    b = 2.0 * tr * s
    c = s * s - 1.0
    sq = torch.sqrt(torch.clamp(b * b - 4.0 * a * c, min=0.0))

    cands = []
    for sign in (1.0, -1.0):
        v = (-b + sign * sq) / (2.0 * a)
        z = tr * v + s
        o = scale * v
        x = torch.where(branch, o, v)
        y = torch.where(branch, v, o)
        cands.append(torch.stack([x, y, z], dim=-1))
    cand = torch.stack(cands, dim=-2)           # (H, W, 2, 3)

    def pick(crow, sel):
        return torch.gather(crow, 1, sel[:, None, None].expand(W, 1, 3))[:, 0]

    rows = []
    prev = None
    for i in range(H):
        crow = cand[i]                          # (W, 2, 3)
        if prev is None:
            d_up = torch.zeros((W, 2), device=s.device)
        else:
            d_up = _norm(crow - prev[:, None, :])
        sel0 = torch.argmin(d_up, dim=-1)       # provisional: up only
        est0 = pick(crow, sel0)
        left = torch.cat([est0[:1], est0[:-1]], dim=0)
        d_left = _norm(crow - left[:, None, :])
        d_left[0] = 0.0
        sel = torch.argmin(d_up + d_left, dim=-1)
        zsel = torch.gather(crow[..., 2], 1, sel[:, None])[:, 0]
        sel = torch.where(zsel < 0, 1 - sel, sel)
        prev = pick(crow, sel)
        rows.append(prev)
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# Matrix-free operators + CG
# ---------------------------------------------------------------------------

def _dr(n: torch.Tensor) -> torch.Tensor:
    """Central difference along rows, one-sided at the edges (the
    reference's Dx stencil, `shapeFromShading.h:314-330`)."""
    up = torch.cat([n[:1], n[:-1]], dim=0)
    dn = torch.cat([n[1:], n[-1:]], dim=0)
    return dn - up


def _drT(y: torch.Tensor) -> torch.Tensor:
    """The adjoint of `_dr`: the down-shift's transpose (y[i - 1] to row
    i, y[H - 1] also to the last row) minus the up-shift's (y[i + 1] to
    row i, y[0] also to the first row)."""
    z = torch.zeros_like(y[:1])
    dn = torch.cat([z, y[:-1]], dim=0)
    dn[-1] += y[-1]
    up = torch.cat([y[1:], z], dim=0)
    up[0] += y[0]
    return dn - up


def _dc(n: torch.Tensor) -> torch.Tensor:
    return _dr(n.transpose(0, 1)).transpose(0, 1)


def _dcT(y: torch.Tensor) -> torch.Tensor:
    return _drT(y.transpose(0, 1)).transpose(0, 1)


def _gx(z: torch.Tensor) -> torch.Tensor:
    """Forward difference along columns, (H, W) -> (H, W - 1)."""
    return z[:, 1:] - z[:, :-1]


def _gxT(y: torch.Tensor) -> torch.Tensor:
    """The adjoint of `_gx`, (H, W - 1) -> (H, W)."""
    return F.pad(y, (1, 0)) - F.pad(y, (0, 1))


def _gy(z: torch.Tensor) -> torch.Tensor:
    """Forward difference along rows, (H, W) -> (H - 1, W)."""
    return z[1:, :] - z[:-1, :]


def _gyT(y: torch.Tensor) -> torch.Tensor:
    """The adjoint of `_gy`, (H - 1, W) -> (H, W)."""
    return F.pad(y, (0, 0, 1, 0)) - F.pad(y, (0, 0, 0, 1))


def _cg(apply_fn, b, x0, iters: int, tol: float = 1e-10):
    """Conjugate gradient until ``iters`` steps or the squared residual
    is at most ``tol`` (the JAX `while_loop`'s test, in float32): one host
    read of the residual a step."""
    x = x0
    r = b - apply_fn(x0)
    p = r
    rs = torch.sum(r * r)
    tol32 = float(np.float32(tol))
    k = 0
    while k < iters and rs.item() > tol32:
        ap = apply_fn(p)
        alpha = rs / torch.clamp(torch.sum(p * ap), min=1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
        rs = rs_new
        k += 1
    _cg.steps = k
    return x


_cg.steps = 0


def _smooth_apply(v, lam_diff):
    return lam_diff * (_drT(_dr(v)) + _dcT(_dc(v)))


# ---------------------------------------------------------------------------
# Normal-map solvers
# ---------------------------------------------------------------------------

def _solve_normals(s, ld, lam_norm, lam_diff, n_iter, incr_tol, n0,
                   edge_dir=None, lam_dir=0.0):
    """Gauss-Newton on the shading energy with matrix-free CG inner
    solves.  ``edge_dir`` is an optional (H, W, 2) field of unit
    constraint directions d with weight lam_dir enforcing
    <d, n_xy> = 0 at edge pixels (zeros elsewhere).  One host read of the
    step norm a Gauss-Newton step."""
    H, W = s.shape

    def lin_apply(v, n_cur):
        # data: ld ld^T per pixel
        av = ld * torch.sum(v * ld, -1, keepdim=True)
        av = av + _smooth_apply(v, lam_diff)
        # GN term of (|n|^2 - 1)^2, made PSD with |q| so the inner CG
        # stays valid where |n| < 1 (the reference's LU tolerates the
        # indefinite 4 q I + 8 n n^T; CG does not)
        q = torch.sum(n_cur * n_cur, -1, keepdim=True) - 1.0
        av = av + lam_norm * (4.0 * torch.abs(q) * v + 8.0 * n_cur
                              * torch.sum(n_cur * v, -1, keepdim=True))
        if edge_dir is not None:
            e = torch.sum(edge_dir * v[..., :2], -1, keepdim=True)
            av = torch.cat([av[..., :2] + lam_dir * edge_dir * e,
                            av[..., 2:]], -1)
        return av

    def rhs(n_cur):
        # b = L^T s - A0 n - lam_norm grad_norm  (grad of the quartic)
        b = ld * s[..., None]
        b = b - ld * torch.sum(n_cur * ld, -1, keepdim=True)
        b = b - _smooth_apply(n_cur, lam_diff)
        q = torch.sum(n_cur * n_cur, -1, keepdim=True) - 1.0
        b = b - lam_norm * 4.0 * q * n_cur
        if edge_dir is not None:
            e = torch.sum(edge_dir * n_cur[..., :2], -1, keepdim=True)
            b = torch.cat([b[..., :2] + -lam_dir * edge_dir * e,
                           b[..., 2:]], -1)
        return b

    n_inner = min(80, 3 * H * W)
    tol32 = float(np.float32(incr_tol))
    n, k, dn = n0, 0, math.inf
    inner = 0
    while k < n_iter and dn > tol32:
        delta = _cg(lambda v: lin_apply(v, n), rhs(n), torch.zeros_like(n),
                    n_inner)
        inner += _cg.steps
        n = n + delta
        dn = (_norm(delta.reshape(1, -1))[0] / (3 * H * W)).item()
        k += 1
    _solve_normals.steps = (k, inner)
    return n / torch.clamp(_norm(n, keepdim=True), min=1e-12)


_solve_normals.steps = (0, 0)


def normal_map_from_single_shading_image(shading: torch.Tensor, light,
                                         lambda_norm: float = 1.0,
                                         lambda_diff: float = 0.25,
                                         n_iter: int = 50,
                                         incr_tol: float = 1e-6
                                         ) -> torch.Tensor:
    """(H, W, 3) unit normal map from one shading image under a known
    light (`shapeFromShading.h:224-449`): Gauss-Newton on the shading /
    smoothness / unit-norm energy, starting from the zero field as the
    reference does."""
    s = shading.float()
    ld = _t(light, s.device)
    ld = ld / _norm(ld) * torch.max(s)
    n0 = torch.zeros(s.shape + (3,), dtype=torch.float32, device=s.device)
    return _solve_normals(s, ld, float(lambda_norm), float(lambda_diff),
                          n_iter, float(incr_tol), n0)


def _linear_quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """`jnp.quantile(x, q)` (linear interpolation, NaN if any value is
    NaN) over all values: the float32 index arithmetic of JAX's
    `_quantile` on a sort, with no size limit."""
    a = torch.sort(x.reshape(-1)).values
    n = np.float32(a.numel())
    one = np.float32(1)
    qq = np.float32(q) * (n - one)
    low, high = np.floor(qq), np.ceil(qq)
    hw = np.float32(qq - low)
    lw = one - hw
    low = int(min(max(low, 0), n - one))
    high = int(min(max(high, 0), n - one))
    out = a[low] * float(lw) + a[high] * float(hw)
    return torch.where(torch.isnan(a[-1]), a[-1], out)


def gradient_based_edges(guide: torch.Tensor, prop_edges: float = 0.05):
    """Top-``prop_edges`` gradient pixels of a (H, W, C) guide image
    (`edgesDetection.h:39-130`).  Channel gradients are sign-aligned
    before aggregation so orientation matters but direction does not.
    Returns (mask (H, W) bool, gradients (H, W, 2) zeroed off-mask)."""
    g = guide.float()
    if g.ndim == 2:
        g = g[..., None]
    d0 = torch.zeros(g.shape[:2], dtype=torch.float32, device=g.device)
    d1 = torch.zeros(g.shape[:2], dtype=torch.float32, device=g.device)
    for ch in range(g.shape[-1]):
        c0, c1 = _ref_gradients(g[..., ch])
        coeff = torch.where(d0 * c0 + d1 * c1 < 0, -1.0, 1.0)
        d0 = d0 + coeff * c0
        d1 = d1 + coeff * c1
    ampl = d0 * d0 + d1 * d1
    thresh = _linear_quantile(ampl, 1.0 - prop_edges)
    # the reference compares >= (`edgesDetection.h:141`); we additionally
    # require a non-zero gradient so a mostly-flat image (quantile 0)
    # cannot flag every pixel as an edge with an undefined direction
    mask = (ampl >= thresh) & (ampl > 0)
    grads = torch.where(mask[..., None], torch.stack([d0, d1], -1), 0.0)
    return mask, grads


def normal_map_from_intrinsic_decomposition(shading: torch.Tensor,
                                            guide: torch.Tensor, light,
                                            lambda_norm: float = 1.0,
                                            lambda_diff: float = 0.25,
                                            lambda_dir: float = 0.25,
                                            prop_edges: float = 0.05,
                                            n_iter: int = 50,
                                            incr_tol: float = 1e-6
                                            ) -> torch.Tensor:
    """Normal map from an intrinsic-decomposition shading image with a
    guide-image edge alignment constraint
    (`shapeFromShading.h:452-765`): at strong guide edges the normal's
    tangential component must align with the gradient (the 90-degree
    rotated gradient dotted with n_xy is penalized), initialization from
    `initial_normal_map_estimate`."""
    s = shading.float()
    ld = _t(light, s.device)
    ld = ld / _norm(ld) * torch.max(s)

    mask, grads = gradient_based_edges(guide, prop_edges)
    ampl = torch.clamp(_norm(grads, keepdim=True), min=1e-12)
    # rotate 90 degrees: cross(grad, n_xy) = 0 <=> <grad_perp, n_xy> = 0
    perp = torch.stack([-grads[..., 1], grads[..., 0]], -1) / ampl
    perp = torch.where(mask[..., None], perp, 0.0)
    n_edges = torch.clamp(torch.sum(mask), min=1).float()
    rescale = torch.tensor(float(s.shape[0] * s.shape[1]),
                           device=s.device) / n_edges

    n0 = initial_normal_map_estimate(shading, ld)
    n0 = torch.where(torch.isfinite(n0), n0,
                     torch.tensor([0.0, 0.0, 1.0], device=s.device))
    return _solve_normals(s, ld, float(lambda_norm), float(lambda_diff),
                          n_iter, float(incr_tol), n0, edge_dir=perp,
                          lam_dir=float(lambda_dir) * rescale)


# ---------------------------------------------------------------------------
# Normal-map post-processing
# ---------------------------------------------------------------------------

def rectify_normal_map(normalmap: torch.Tensor, mask: torch.Tensor
                       ) -> torch.Tensor:
    """Rotate the map so the masked mean normal becomes vertical
    (`shapeFromShading.h:768-833`, Rodrigues rotation about
    mean x z-axis)."""
    from ..geometry.rotations import rodrigues_formula
    n = normalmap.float()
    m = mask[..., None].float()
    mean = torch.sum(n * m, dim=(0, 1)) / torch.clamp(torch.sum(m), min=1.0)
    vertical = torch.tensor([0.0, 0.0, 1.0], device=n.device)
    axis = torch.linalg.cross(mean, vertical)
    alpha = torch.arccos(torch.clamp(torch.sum(mean * vertical)
                                     / torch.clamp(_norm(mean), min=1e-12),
                                     -1.0, 1.0))
    axis = axis / torch.clamp(_norm(axis), min=1e-12)
    R = rodrigues_formula(alpha * axis)
    # R @ n at every pixel, written out (no matmul)
    return n[..., :1] * R[:, 0] + n[..., 1:2] * R[:, 1] + n[..., 2:] * R[:, 2]


def height_from_normal_map(normalmap: torch.Tensor, max_diff: float = 50.0
                           ) -> torch.Tensor:
    """Least-squares height integration (`shapeFromShading.h:836-969`):
    forward-difference observations equal the mean of adjacent slopes
    n_x/n_z, n_y/n_z (clamped to +-max_diff), one anchor at (0, 0); the
    normal equations are solved matrix-free with CG (the reference uses
    a sparse LU)."""
    n = normalmap.float()
    H, W = n.shape[:2]
    nz = n[..., 2]

    def _slope(comp):
        d = comp / nz
        fallback = torch.sign(comp) * max_diff
        return torch.where(torch.isfinite(d) & (torch.abs(d) <= max_diff),
                           d, fallback)

    dx = _slope(n[..., 0])
    dy = _slope(n[..., 1])
    bx = (dx[:, :-1] + dx[:, 1:]) / 2           # (H, W-1)
    by = (dy[:-1, :] + dy[1:, :]) / 2           # (H-1, W)

    def apply_fn(z):
        out = _gxT(_gx(z)) + _gyT(_gy(z))
        out[0, 0] += z[0, 0]                    # anchor z[0,0] = 0
        return out

    b = _gxT(bx) + _gyT(by)
    return _cg(apply_fn, b, torch.zeros((H, W), device=n.device),
               iters=4 * (H + W), tol=1e-8)


def flatten_height_map_in_area_of_interest(base_height: torch.Tensor,
                                           mask: torch.Tensor,
                                           ensure_convex: bool = False
                                           ) -> torch.Tensor:
    """Remove the best-fit plane over the masked area, optionally flip so
    the region is convex-up, and shift the masked minimum to zero
    (`shapeFromShading.h:973-1108`); outside the mask the result is 0."""
    h = base_height.float()
    dev = h.device
    H, W = h.shape
    mask = mask.bool()
    m = mask.float()
    ii = torch.arange(H, dtype=torch.float32, device=dev)[:, None] \
        * torch.ones((1, W), device=dev)
    jj = torch.ones((H, 1), device=dev) \
        * torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    one = torch.ones((H, W), dtype=torch.float32, device=dev)
    basis = torch.stack([ii, jj, one], dim=-1)           # (H, W, 3)
    wb = basis * m[..., None]
    M = torch.sum(wb[..., :, None] * basis[..., None, :], dim=(0, 1))
    r = torch.sum(wb * h[..., None], dim=(0, 1))
    coeffs = torch.linalg.solve(M, r)
    flat = (h - torch.sum(basis * coeffs, -1)) * m

    if ensure_convex:
        # reference parity (`shapeFromShading.h:1050-1075`): the vote
        # kernel is the all-positive [[1,1,1],[1,8,1],[1,1,1]] smoother,
        # i.e. the sign of the SMOOTHED plane-removed height, majority
        # over the mask.  Note this is not a curvature test: it chooses
        # the flip where most of the region sits ABOVE the fitted plane
        # (a narrow peak over a wide tail gets inverted to a wide
        # plateau with a dent — the reference's concavity-ambiguity
        # disambiguation, replicated as-is).
        k = torch.tensor([[1., 1., 1.], [1., 8., 1.], [1., 1., 1.]],
                         device=dev)
        conv = convolve_2d(flat, k, (_PM1, _PM1))
        score = torch.sum(torch.where(conv >= 0, 1.0, -1.0) * m)
        flat = torch.where(score < 0, -flat, flat)

    big = torch.finfo(torch.float32).max
    mn = torch.min(torch.where(mask, flat, big))
    return torch.where(mask, flat - mn, 0.0)


# ---------------------------------------------------------------------------
# Compact legacy surface (round-1 API, kept for callers/tests)
# ---------------------------------------------------------------------------

def estimate_light_direction(image: torch.Tensor, normals: torch.Tensor
                             ) -> torch.Tensor:
    """Least-squares Lambertian light from KNOWN normals (a convenience
    inverse of the shading model; for the reference's from-shading-only
    estimator see `estimate_light_direction_from_shading`).  JAX's
    minimum-norm `lstsq` through the port's `optim.lsq.small_lstsq`."""
    from ..optim.lsq import small_lstsq
    I = image.float().reshape(-1)
    N = normals.float().reshape(-1, 3)
    return small_lstsq(N, I)


def initial_normal_map(image: torch.Tensor, light) -> torch.Tensor:
    """Linearized initial normals: start from the light direction scaled to
    match the observed shading, bent toward the image gradient."""
    I = image.float()
    light = _t(light, I.device)
    gy = torch.gradient(I, dim=0)[0]
    gx = torch.gradient(I, dim=1)[0]
    ct = torch.clamp(I / torch.clamp(_norm(light), min=1e-6), 0.0, 1.0)
    st = torch.sqrt(1.0 - ct * ct)
    g = torch.stack([gy, gx], -1)
    gn = g / torch.clamp(_norm(g, keepdim=True), min=1e-6)
    n = torch.stack([-gn[..., 1] * st, -gn[..., 0] * st, ct], -1)
    return n / _norm(n, keepdim=True)


def refine_normals(image: torch.Tensor, normals0: torch.Tensor, light,
                   smoothness: float = 0.1, iters: int = 200,
                   lr: float = 0.05) -> torch.Tensor:
    """Minimize ||n . L - I||^2 + w ||grad n||^2 over unit normals
    (projected gradient descent, the gradient by `torch.autograd`; the
    reference-parity Gauss-Newton solver is
    `normal_map_from_single_shading_image`)."""
    I = image.float()
    L = _t(light, I.device)

    def energy(n):
        n = n / torch.clamp(_norm(n, keepdim=True), min=1e-6)
        shade = torch.sum(n * L, -1)
        data = torch.sum((shade - I) ** 2)
        gx = n[:, 1:] - n[:, :-1]
        gy = n[1:, :] - n[:-1, :]
        return data + smoothness * (torch.sum(gx * gx) + torch.sum(gy * gy))

    n = normals0.float().detach()
    with torch.enable_grad():
        for _ in range(iters):
            v = n.requires_grad_(True)
            g, = torch.autograd.grad(energy(v), v)
            n = v.detach() - lr * g
            n = n / torch.clamp(_norm(n, keepdim=True), min=1e-6)
    return n


def integrate_normals(normals: torch.Tensor) -> torch.Tensor:
    """Normals -> height via the Frankot-Chellappa integrability projection
    (FFT fast path; the reference-parity least-squares integration is
    `height_from_normal_map`)."""
    n = normals.float()
    dev = n.device
    nz = torch.where(torch.abs(n[..., 2]) > 1e-4, n[..., 2], 1e-4)
    p = -n[..., 0] / nz   # dz/drow
    q = -n[..., 1] / nz   # dz/dcol
    H, W = p.shape
    wy = torch.fft.fftfreq(H, device=dev) * 2 * math.pi
    wx = torch.fft.fftfreq(W, device=dev) * 2 * math.pi
    WY, WX = torch.meshgrid(wy, wx, indexing="ij")
    denom = WY * WY + WX * WX
    denom[0, 0] = 1.0
    Fz = (-1j * WY * torch.fft.fft2(p) - 1j * WX * torch.fft.fft2(q)) / denom
    Fz[0, 0] = 0.0
    return torch.real(torch.fft.ifft2(Fz))


def shape_from_shading(image: torch.Tensor, light, smoothness: float = 0.1,
                       iters: int = 200):
    """Full pipeline: initial estimate -> refinement -> height integration.
    Returns (normals, height)."""
    n0 = initial_normal_map(image, light)
    n = refine_normals(image, n0, light, smoothness, iters)
    return n, integrate_normals(n)
