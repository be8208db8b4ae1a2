"""The port's `imageproc` modules against the JAX package's on the CPU, on
the same numpy-seeded inputs: the N-d convolution engine (every role, every
padding mode at widths up to past the axis, strides, four Moving axes),
the filters, finite differences, colour conversions, histograms and
thresholds, morphology, connected components, edges and the rasterizers,
checkerboard detection and hexagonal targets.  Float maps are held at
rtol = atol = 1e-5 unless a test says otherwise; discrete outputs
(labels, edges, masks, counts, targets) exactly."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_imageproc_pipelines as pipelines
from libstevi_tpu.imageproc import checkerboard as JC
from libstevi_tpu.imageproc import color as JCol
from libstevi_tpu.imageproc import convolutions as JV
from libstevi_tpu.imageproc import edges as JE
from libstevi_tpu.imageproc import filters as JF
from libstevi_tpu.imageproc import finite_differences as JFD
from libstevi_tpu.imageproc import histogram as JH
from libstevi_tpu.imageproc import morphology as JM
from libstevi_tpu.imageproc import targets as JT

from libstevi_tpu_torch.imageproc import checkerboard as TC
from libstevi_tpu_torch.imageproc import color as TCol
from libstevi_tpu_torch.imageproc import convolutions as TV
from libstevi_tpu_torch.imageproc import edges as TE
from libstevi_tpu_torch.imageproc import filters as TF
from libstevi_tpu_torch.imageproc import finite_differences as TFD
from libstevi_tpu_torch.imageproc import histogram as TH
from libstevi_tpu_torch.imageproc import morphology as TM
from libstevi_tpu_torch.imageproc import targets as TT

# `imageproc.connected_components` is the function (the package's export
# shadows the module)
JCC = importlib.import_module("libstevi_tpu.imageproc.connected_components")
TCC = importlib.import_module(
    "libstevi_tpu_torch.imageproc.connected_components")

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _uniform(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


# -- convolutions ---------------------------------------------------------

MODES = ["CONSTANT", "PERIODIC", "MIRROR"]


def _axis(pkg, kind, pad=(0, None, "CONSTANT"), stride=0):
    if kind == "M":
        p = pkg.PaddingInfos(pad[0], pad[1], pkg.PaddingType[pad[2]])
        return pkg.MovingWindowAxis(p, stride)
    return {"A": pkg.AggregateWindowsAxis, "I": pkg.BatchedInputAxis,
            "O": pkg.BatchedOutputAxis}[kind]()


def _filters(coef, kinds, pads=None, strides=None):
    pads = pads or {}
    strides = strides or {}
    out = []
    for pkg in (JV, TV):
        axes = [_axis(pkg, k, pads.get(i, (0, None, "CONSTANT")),
                      strides.get(i, 0)) for i, k in enumerate(kinds)]
        out.append(pkg.FilterND(coef, *axes))
    return out


# (input shape, filter shape, axis roles)
ROLES = {
    "moving2": ((9, 11), (3, 3), "MM"),
    "aggregate": ((8, 10, 3), (3, 3, 3), "MMA"),
    "batched_in": ((4, 8, 10), (3, 3), "IMM"),
    "batched_out": ((8, 10), (3, 3, 2), "MMO"),
    "full_mix": ((2, 7, 9, 3), (3, 3, 3, 2), "IMMAO"),
    "moving3": ((6, 7, 8), (3, 3, 3), "MMM"),
    "moving4": ((5, 6, 4, 5), (2, 3, 2, 3), "MMMM"),
    "moving4_roles": ((2, 4, 5, 4, 5, 2), (2, 2, 3, 3, 2, 3), "IMMMMAO"),
    "contraction": ((4, 3), (3, 2), "IAO"),
    "moving1": ((3, 17), (5,), "IM"),
}


@pytest.mark.parametrize("case", ROLES)
def test_filter_nd_roles_match_jax(case):
    """Each role combination, up to four Moving axes (past torch's 3-D
    convolutions) and none (a plain contraction): the output and
    `output_shape` against the JAX engine."""
    xs, ks, kinds = ROLES[case]
    x = _uniform(1, xs)
    k = _uniform(2, ks, -1, 1)
    jf, tf = _filters(k, kinds)
    want = _np(jf.convolve(jnp.asarray(x)))
    got = tf.convolve(_t(x))
    assert got.shape == want.shape == tf.output_shape(xs) \
        == jf.output_shape(xs)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("pre,post", [(1, None), (2, 0), (0, 3), (5, 7),
                                      (12, 13)])
def test_filter_nd_padding_matches_jnp_pad(mode, pre, post):
    """Every padding mode at widths from 1 to past the axis (9 columns,
    13 padded: `jnp.pad`'s wrap / reflect repeat), one mode a Moving axis
    and two modes on two axes."""
    x = _uniform(3, (6, 9))
    k = _uniform(4, (3, 2), -1, 1)
    other = MODES[(MODES.index(mode) + 1) % 3]
    jf, tf = _filters(k, "MM", pads={0: (2, 1, other),
                                      1: (pre, post, mode)})
    want = _np(jf.convolve(jnp.asarray(x)))
    got = tf.convolve(_t(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("mode", MODES)
def test_pad_axis_matches_jnp_pad_on_one_element(mode):
    """An axis of one element: wrap and reflect repeat it."""
    x = _uniform(5, (1, 4))
    want = _np(jnp.pad(jnp.asarray(x), ((3, 2), (0, 0)),
                       mode={"CONSTANT": "constant", "PERIODIC": "wrap",
                             "MIRROR": "reflect"}[mode]))
    got = TV.pad_axis(_t(x), 0, 3, 2, TV.PaddingType[mode])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("strides", [(1, 0), (0, 2), (2, 1), (3, 3)])
def test_filter_nd_strides_match_jax(strides):
    """A stride of s keeps every (s+1)-th window position, padded."""
    x = _uniform(6, (2, 11, 13))
    k = _uniform(7, (3, 4), -1, 1)
    jf, tf = _filters(k, "IMM", pads={1: (1, None, "MIRROR"),
                                       2: (2, 1, "PERIODIC")},
                      strides={1: strides[0], 2: strides[1]})
    want = _np(jf.convolve(jnp.asarray(x)))
    got = tf.convolve(_t(x)).numpy()
    assert got.shape == want.shape == tf.output_shape(x.shape)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("kind", ["plain", "depthwise", "aggregate"])
@pytest.mark.parametrize("strides", [(1, 1), (2, 3)])
def test_convolve_2d_and_filter_match_jax(kind, strides):
    """`convolve_2d` (plain, depthwise, aggregate) with two padding modes
    and strides, and `Filter.convolve`."""
    shape = (10, 12) if kind == "plain" else (10, 12, 3)
    x = _uniform(8, shape)
    k = _uniform(9, (3, 5, 3) if kind == "aggregate" else (3, 5), -1, 1)
    pads = [(pkg.PaddingInfos(1, 2, pkg.PaddingType.MIRROR),
             pkg.PaddingInfos(2, None, pkg.PaddingType.PERIODIC))
            for pkg in (JV, TV)]
    want = _np(JV.convolve_2d(jnp.asarray(x), jnp.asarray(k), pads[0],
                              strides))
    got = TV.convolve_2d(_t(x), _t(k), pads[1], strides).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    got_f = TV.Filter(_t(k), pads[1], strides).convolve(_t(x)).numpy()
    np.testing.assert_array_equal(got_f, got)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("channels", [False, True])
def test_gaussian_filters_match_jax(mode, channels):
    """The taps (equal), the two separated passes and `gaussian_blur`."""
    x = _uniform(10, (14, 17, 2) if channels else (14, 17))
    np.testing.assert_array_equal(TF.gaussian_filter_taps(1.3, 4, False),
                                  JF.gaussian_filter_taps(1.3, 4, False))
    jv, jh = JF.separated_gaussian_filter(1.3, 4, True,
                                          JV.PaddingType[mode])
    tv, th = TF.separated_gaussian_filter(1.3, 4, True,
                                          TV.PaddingType[mode])
    np.testing.assert_allclose(tv.convolve(_t(x)).numpy(),
                               _np(jv.convolve(jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(th.convolve(_t(x)).numpy(),
                               _np(jh.convolve(jnp.asarray(x))), **TOL)
    for sigma, radius in ((0.8, None), (2.0, 3)):
        want = _np(JF.gaussian_blur(jnp.asarray(x), sigma, radius,
                                    JV.PaddingType[mode]))
        got = TF.gaussian_blur(_t(x), sigma, radius, TV.PaddingType[mode])
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_array_equal(TF.finite_differences_kernel(),
                                  JF.finite_differences_kernel())
    np.testing.assert_array_equal(TF.extend_linear_kernel(),
                                  JF.extend_linear_kernel())


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_finite_differences_match_jax(axis):
    x = _uniform(11, (5, 7, 4))
    np.testing.assert_allclose(
        TFD.finite_difference(_t(x), axis).numpy(),
        _np(JFD.finite_difference(jnp.asarray(x), axis)), **TOL)
    img = x[..., 0]
    for g, w in zip(TFD.gradient_2d(_t(img)), JFD.gradient_2d(
            jnp.asarray(img))):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


# -- colour ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["linear_to_log", "log_to_linear",
                                  "rgb_to_gray", "bgr_to_rgb", "rgb_to_hsv",
                                  "hsv_to_rgb", "rgb_to_hsi", "yuv_to_rgb",
                                  "normalize_channels"])
def test_color_conversions_match_jax(name):
    """Each converter on random colours with greys, pure hues, black and
    every maximum channel; HSV input from `rgb_to_hsv` so every sector
    appears.  The HSI hue at 1e-4 degrees (degrees scale the arccos)."""
    x = _uniform(12, (9, 11, 3))
    x[0, :3] = [[0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
    x[1, :3] = [[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [0.2, 0.9, 0.9]]
    if name == "hsv_to_rgb":
        x = _np(JCol.rgb_to_hsv(jnp.asarray(x)))
    want = _np(getattr(JCol, name)(jnp.asarray(x)))
    got = getattr(TCol, name)(_t(x)).numpy()
    tol = dict(rtol=1e-5, atol=1e-4) if name == "rgb_to_hsi" else TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("name", ["yuyv_to_rgb", "yvyu_to_rgb"])
def test_packed_422_matches_jax(name):
    x = _uniform(13, (6, 10, 2), 0, 255)
    np.testing.assert_allclose(getattr(TCol, name)(_t(x)).numpy(),
                               _np(getattr(JCol, name)(jnp.asarray(x))),
                               **TOL)
    with pytest.raises(ValueError):
        getattr(TCol, name)(_t(x[:, :1]))


# -- histogram -------------------------------------------------------------

@pytest.mark.parametrize("bins,limits", [(256, (None, None)),
                                         (17, (None, None)),
                                         (32, (0.1, 0.7))])
def test_histogram_matches_jax(bins, limits):
    """Counts exactly (values outside given limits clip into the end
    bins), edges, centers and entropy at 1e-5."""
    x = _uniform(14, (40, 50))
    want = JH.Histogram.compute(jnp.asarray(x), bins, *limits)
    got = TH.Histogram.compute(_t(x), bins, *limits)
    assert got.counts.dtype == torch.int32
    np.testing.assert_array_equal(got.counts.numpy(), _np(want.counts))
    np.testing.assert_allclose(got.edges.numpy(), _np(want.edges), **TOL)
    np.testing.assert_allclose(got.centers.numpy(), _np(want.centers), **TOL)
    np.testing.assert_allclose(float(got.entropy()), float(want.entropy()),
                               **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_thresholds_match_jax(seed):
    """Otsu and the balanced threshold on a bimodal sample with unequal
    modes."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.normal(0.25, 0.05, 3000),
                        rng.normal(0.7, 0.08, 1800)]).astype(np.float32)
    for name in ("otsu_threshold", "balanced_histogram_threshold"):
        for bins in (256, 64):
            want = float(getattr(JH, name)(jnp.asarray(x), bins))
            got = float(getattr(TH, name)(_t(x), bins))
            np.testing.assert_allclose(got, want, **TOL)


# -- morphology ------------------------------------------------------------

@pytest.mark.parametrize("op", ["erosion", "dilation", "opening", "closing"])
@pytest.mark.parametrize("element", ["rect1", "rect2", "circle2", "cross"])
@pytest.mark.parametrize("channels", [False, True])
def test_morphology_matches_jax(op, element, channels):
    """Rectangular (max-pool) and arbitrary elements (shifted slices),
    gray and (H, W, C) inputs: exact (min and max round nothing)."""
    x = _uniform(15, (13, 16, 2) if channels else (13, 16))
    if element.startswith("rect"):
        kw = dict(radius=int(element[-1]))
    elif element == "circle2":
        el = JM.circular_structuring_element(2)
        np.testing.assert_array_equal(TM.circular_structuring_element(2), el)
        kw = dict(element=el)
    else:
        kw = dict(element=np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], bool))
    want = _np(getattr(JM, op)(jnp.asarray(x), **kw))
    got = getattr(TM, op)(_t(x), **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [1, 2, 3])
@pytest.mark.parametrize("channels", [False, True])
def test_median_filter_matches_jax(radius, channels):
    """The middle of the sorted (2r+1)^2 edge-padded samples, exactly;
    values repeat, so ties are present."""
    x = np.round(_uniform(16, (11, 14, 3) if channels else (11, 14)) * 6)
    want = _np(JM.median_filter(jnp.asarray(x), radius))
    got = TM.median_filter(_t(x), radius).numpy()
    np.testing.assert_array_equal(got, want)


# -- connected components --------------------------------------------------

def _blobs(seed, shape=(40, 56), level=0.55):
    from scipy.ndimage import gaussian_filter
    n = np.random.default_rng(seed).uniform(0, 1, shape)
    return gaussian_filter(n, 1.5) > np.quantile(gaussian_filter(n, 1.5),
                                                 level)


@pytest.mark.parametrize("contiguity", ["queen", "rook", "bishop"])
@pytest.mark.parametrize("max_iters", [None, 1, 3, 20])
def test_connected_components_match_jax(contiguity, max_iters):
    """Labels exactly, run to the fixed point in blocks of sweeps, and cut
    at ``max_iters`` as the JAX loop is (a spiral-free blob mask with
    long components)."""
    m = _blobs(17)
    want = _np(JCC.connected_components(jnp.asarray(m), contiguity,
                                        max_iters))
    got = TCC.connected_components(_t(m), contiguity, max_iters).numpy()
    np.testing.assert_array_equal(got, want)
    if max_iters is not None:
        assert TCC.connected_components.sweeps == max_iters
    with pytest.raises(ValueError):
        TCC.connected_components(_t(m), "king")


def test_cluster_stats_and_relabel_match_jax():
    m = _blobs(18)
    lab = JCC.connected_components(jnp.asarray(m), "queen")
    tlab = TCC.connected_components(_t(m), "queen")
    v = _uniform(19, m.shape)
    for got, want in zip(TCC.relabel_consecutive(tlab),
                         JCC.relabel_consecutive(lab)):
        np.testing.assert_array_equal(got, want)
    assert TCC.cluster_stats(tlab, _t(v)) == JCC.cluster_stats(lab, v)
    assert TCC.cluster_stats(tlab) == JCC.cluster_stats(lab)


# -- edges -----------------------------------------------------------------

def _edge_images():
    step = np.zeros((24, 24), np.float32)
    step[:, 12:] = 1.0
    board, _ = pipelines.TestCheckerboard._render(H=64, W=80, n_sq=(4, 5),
                                                  sq=12.0, theta=0.3,
                                                  origin=(14.0, 6.0))
    from scipy.ndimage import gaussian_filter
    noise = gaussian_filter(_uniform(20, (40, 48)), 2.0)
    return {"step": step, "board": board, "noise": noise,
            "flat": np.full((10, 12), 0.3, np.float32)}


@pytest.mark.parametrize("image", ["step", "board", "noise", "flat"])
@pytest.mark.parametrize("low,high", [(0.1, 0.3), (0.05, 0.5)])
def test_detect_edges_matches_jax(image, low, high):
    """Edges exactly, TestEdges' step among them: the suppression, both
    thresholds and the hysteresis fixed point."""
    x = _edge_images()[image]
    want = _np(JE.detect_edges(jnp.asarray(x), low, high))
    got = TE.detect_edges(_t(x), low, high).numpy()
    np.testing.assert_array_equal(got, want)


def test_rasterizers_match_jax():
    for p0, p1 in (((0, 0), (3, 7)), ((5.4, -2.2), (-3.0, 4.6)),
                   ((2, 2), (2, 2))):
        np.testing.assert_array_equal(TE.rasterize_line(p0, p1),
                                      JE.rasterize_line(p0, p1))
    for tri, shape in ((((0, 0), (6, 0), (0, 6)), None),
                       (((-2.5, 1.0), (7.2, 3.3), (1.0, 9.9)), (5, 6)),
                       (((0, 0), (1, 1), (2, 2)), None)):
        for g, w in zip(TE.rasterize_triangle(*tri, shape=shape),
                        JE.rasterize_triangle(*tri, shape=shape)):
            np.testing.assert_array_equal(g, w)


# -- checkerboard ----------------------------------------------------------

RENDERS = {
    "fronto": {},
    "rotated_perspective": dict(theta=0.42, persp=(0.01, -0.008), sharp=3.0),
}


def _board(name):
    img, gt = pipelines.TestCheckerboard._render(**RENDERS[name])
    if name == "rotated_perspective":
        from scipy.ndimage import gaussian_filter
        img = gaussian_filter(img, 1.0)
    return img, gt


def _saddles(xy, gt, tol=0.5):
    """Which of the (..., 2) [x, y] positions lie within ``tol`` px of a
    ground-truth corner: the board's saddles.  The others are the outer
    corners against the quiet zone, L-junctions where the saddle model is
    ill-posed: there the Gauss-Newton steps amplify float32 rounding (the
    two packages' fits part by up to ~20 px, JAX's own lying 4-50 px from
    any corner)."""
    d = np.linalg.norm(xy[..., None, :] - gt.reshape(-1, 2), axis=-1)
    return np.nan_to_num(d, nan=np.inf).min(-1) < tol


def _hessian64(img, r=1):
    """The response's box-summed second derivatives in float64 (rolled
    central differences, zero-padded box sums): (xx, xy, yy)."""
    from scipy.ndimage import uniform_filter

    def d(a, axis):
        return (np.roll(a, -1, axis) - np.roll(a, 1, axis)) / 2.0

    x = img.astype(np.float64)
    n = (2 * r + 1) ** 2
    box = lambda a: uniform_filter(a, 2 * r + 1, mode="constant") * n
    return box(d(d(x, 1), 1)), box(d(d(x, 1), 0)), box(d(d(x, 0), 0))


@pytest.mark.parametrize("name", RENDERS)
def test_checkerboard_response_matches_jax(name):
    """The three maps away from flat regions (where |lmin| or |lmax| >
    1e-3 of the largest: elsewhere the JAX package's prefix sums leave
    rounding noise), at 1e-5 of each map's range; the direction, an axis,
    modulo pi within 1e-4 rad where its vector (lmax - yy, xy) is longer
    than 1e-2 of the largest eigenvalue (it has no direction where it
    vanishes, and the 1e-12 switch on xy picks (1, 0) there)."""
    img, _ = _board(name)
    want = [_np(a) for a in JC.checkerboard_response(jnp.asarray(img))]
    got = [a.numpy() for a in TC.checkerboard_response(_t(img))]
    lam = np.maximum(np.abs(want[1]), np.abs(want[2]))
    keep = lam > 1e-3 * lam.max()
    assert keep.mean() > 0.2
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g[keep], w[keep], rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    xx, xy, yy = _hessian64(img)
    lmax = (xx + yy) / 2 + np.sqrt(((xx - yy) / 2) ** 2 + xy * xy)
    posed = np.hypot(lmax - yy, xy) > 1e-2 * lam.max()
    assert (keep & posed).mean() > 0.1
    d = np.abs(got[3] - want[3])[keep & posed] % np.pi
    assert np.minimum(d, np.pi - d).max() < 1e-4


@pytest.mark.parametrize("name", RENDERS)
def test_checkerboard_stages_match_jax(name):
    """On one candidate list (the JAX package's): the section filter and
    the grid exactly; the corner fit at the saddles within 1e-3 px and
    its parameters there at 1e-3.  (The candidate lists themselves differ
    by the ties the JAX package's prefix-sum noise breaks.)"""
    img, gt = _board(name)
    c = JC.checkerboard_corner_candidates(jnp.asarray(img))
    thr = 0.05 * float((-c.lmin).max())
    c = c[(c.lmin <= -thr) & (c.lmax >= thr)]
    jf = JC.filter_checkerboard_candidates(img, c)
    tf = TC.filter_checkerboard_candidates(_t(img), c)
    np.testing.assert_array_equal(tf, jf)
    jb, tb = JC.isolate_checkerboard(jf), TC.isolate_checkerboard(tf)
    np.testing.assert_array_equal(tb.corners, jb.corners)
    np.testing.assert_array_equal(tb._candidate_idx, jb._candidate_idx)
    jp, jX = JC.fit_checkerboard_corners(jnp.asarray(img), jf.x, jf.y,
                                         jf.main_dir)
    tp, tX = TC.fit_checkerboard_corners(_t(img), tf.x, tf.y, tf.main_dir)
    sad = _saddles(_np(jp), gt)
    assert sad.sum() >= 30
    np.testing.assert_allclose(tp.numpy()[sad], _np(jp)[sad], rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(tX.numpy()[sad], _np(jX)[sad], rtol=1e-3,
                               atol=1e-3)
    rj = JC.refine_checkerboard_corners(jnp.asarray(img), jb, jf)
    rt = TC.refine_checkerboard_corners(_t(img), tb, tf)
    sad = _saddles(rj.corners, gt)
    np.testing.assert_allclose(rt.corners[sad], rj.corners[sad], rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("name", RENDERS)
def test_detect_checkerboard_matches_jax(name):
    """The whole call: found, the same grid shape, points and NaN cells;
    every saddle within 1e-3 px of JAX's.  Unrefined, the grids are equal
    but where two pixels tie for an outer L-junction (1 px)."""
    img, gt = _board(name)
    want = JC.detect_checkerboard(jnp.asarray(img))
    got = TC.detect_checkerboard(_t(img))
    assert want is not None and got is not None
    assert (got.rows, got.cols, got.n_points_found) \
        == (want.rows, want.cols, want.n_points_found)
    np.testing.assert_array_equal(np.isnan(got.corners),
                                  np.isnan(want.corners))
    sad = _saddles(want.corners, gt)
    assert sad.sum() >= 0.9 * gt[..., 0].size
    np.testing.assert_allclose(got.corners[sad], want.corners[sad], rtol=0,
                               atol=1e-3)
    raw = TC.detect_checkerboard(_t(img), refine=False).corners
    raw_j = JC.detect_checkerboard(jnp.asarray(img), refine=False).corners
    np.testing.assert_array_equal(raw[sad], raw_j[sad])
    assert np.nanmax(np.abs(raw - raw_j)) <= 1.0


def test_hierarchical_corner_fit_matches_jax():
    """`fit_checkerboard_corners_hierarchical` over a 2x pyramid, on the
    JAX package's candidates of the coarse level: the saddles within
    1e-3 px."""
    from libstevi_tpu.interpolation import average_pooling_downsample
    img, gt = pipelines.TestCheckerboard._render(
        H=160, W=208, n_sq=(5, 7), sq=24.0, origin=(24, 24), theta=0.1)
    small = _np(average_pooling_downsample(jnp.asarray(img), 2))
    c = JC.checkerboard_corner_candidates(jnp.asarray(small))
    thr = 0.05 * float((-c.lmin).max())
    c = JC.filter_checkerboard_candidates(
        small, c[(c.lmin <= -thr) & (c.lmax >= thr)])
    want = _np(JC.fit_checkerboard_corners_hierarchical(
        [jnp.asarray(small), jnp.asarray(img)], c.x, c.y, c.main_dir, 2.0))
    got = TC.fit_checkerboard_corners_hierarchical(
        [_t(small), _t(img)], c.x, c.y, c.main_dir, 2.0).numpy()
    sad = _saddles(want, gt)
    assert sad.sum() >= 20
    np.testing.assert_allclose(got[sad], want[sad], rtol=0, atol=1e-3)


# -- hexagonal targets -----------------------------------------------------

def _hex_scene():
    """Two TestHexTargets renders side by side (one rotated code), and
    a few stray dots."""
    r = pipelines.TestHexTargets._render
    a, _ = r()
    b, _ = r(center=(30.0, 34.0), radius=11.0, phase=1.1, code="grbgrg")
    img = np.concatenate([a, b], 1)
    img[4:7, 60:63] = (1.0, 0.08, 0.08)
    return img


def test_detect_hex_targets_matches_jax():
    """TestHexTargets' render, and a two-target scene: the same targets,
    exactly, and the blurry centroid."""
    for img, kw in ((pipelines.TestHexTargets._render()[0],
                     dict(rel_max_hex_diameter=0.45)),
                    (_hex_scene(), dict(rel_max_hex_diameter=0.3))):
        want = JT.detect_hex_targets(img, **kw)
        got = TT.detect_hex_targets(_t(img), **kw)
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.pos_ref_dot, w.pos_ref_dot)
            np.testing.assert_array_equal(g.dots_positives, w.dots_positives)
            np.testing.assert_array_equal(g.dots_positions, w.dots_positions)
            assert g.center == w.center
    img = _hex_scene()
    m = np.zeros(img.shape[:2], bool)
    m[20:25, 30:34] = True
    np.testing.assert_array_equal(TT.cluster_blurry_centroid(img, m),
                                  JT.cluster_blurry_centroid(img, m))
