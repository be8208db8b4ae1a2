"""The port's feature-space subpixel refinement (`ops/image_refinement.py`)
and compressed unfold (`ops/compressor.py`) against the JAX package on the
CPU, at 24x32 with F = 25 (5x5 windows), on a smooth random pair that
holds a flat patch (equal pixels in both images: zero-mean windows there
are all zero, the solves rank-deficient).

Agreement rule (`_agree`): finite where JAX is, every pixel within 1 px
(2 px at random index fields), and within ``tol`` of JAX on >= 0.99 of
the pixels out of the flat patch's reach and on >= 0.98 of all (MEDAD
0.97).  Some decisions rest on rounding in both packages: a WTA over
exactly tied costs (the flat patch), exactly tied least-median residuals,
an acceptance test whose two scores differ by a few ulps (a coefficient
of ~1e-3 accepted or not), a zero second difference; there a pixel may
take a tied neighbour index or another accepted candidate."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JF
from libstevi_tpu.core.search import SearchOffset2 as JS2
from libstevi_tpu.core.types import DispDirection as JDir
from libstevi_tpu.core.utils import Contiguity as JContiguity
from libstevi_tpu.ops import compressor as JC
from libstevi_tpu.ops import image_refinement as J
from libstevi_tpu.ops.unfold import unfold as j_unfold

from libstevi_tpu_torch.core import MatchingFunction as TF
from libstevi_tpu_torch.core import SearchOffset2
from libstevi_tpu_torch.core.margins import PaddingMargins
from libstevi_tpu_torch.ops import compressor as TC
from libstevi_tpu_torch.ops import image_refinement as T
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

H, W, D, R = 24, 32, 6, 2
FLAT = (slice(6, 14), slice(8, 18))


def _pair(H=H, W=W, shift=(0.0, 3.35), seed=0):
    """A smooth random pair: the left image, and the right one the left
    one moved by ``shift`` (rows, columns; bilinear), with a little noise,
    and one flat patch of 0.5 in both.  The shift is fractional: on an
    exact integer shift a barycentric coefficient lands exactly on the
    (0, 1) acceptance bound, where float32 rounding decides either way."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (H + 8, W + 12))
    k = np.ones(3) / 3
    for ax in (0, 1):
        base = np.apply_along_axis(lambda v: np.convolve(v, k, "same"), ax,
                                   base)

    def sample(di, dj):
        y = np.arange(H)[:, None] + 4 + di
        x = np.arange(W)[None, :] + 4 + dj
        y0, x0 = np.floor(y).astype(int), np.floor(x).astype(int)
        fy, fx = y - y0, x - x0
        return ((1 - fy) * (1 - fx) * base[y0, x0]
                + (1 - fy) * fx * base[y0, x0 + 1]
                + fy * (1 - fx) * base[y0 + 1, x0]
                + fy * fx * base[y0 + 1, x0 + 1])

    L = sample(0.0, 0.0).astype(np.float32)
    Rt = (sample(*shift) + rng.normal(0, 2e-3, (H, W))).astype(np.float32)
    L[FLAT] = 0.5
    Rt[FLAT] = 0.5
    return L, Rt


L, RIMG = _pair()


def _near_flat(shape, reach_r=R + 2, reach_c=R + D + 3):
    """Pixels within ``reach`` of the flat patch, rows and columns (a
    source window, its matched target window and the refinement's
    neighbours)."""
    m = np.zeros(shape[:2], bool)
    rs, cs = FLAT
    m[max(0, rs.start - reach_r):rs.stop + reach_r,
      max(0, cs.start - reach_c):cs.stop + reach_c] = True
    return m


def _agree(got, want, tol, near=None, share=0.98, bound=1):
    """Finite where JAX is; every pixel within ``bound`` px (+ ``tol``):
    at WTA indices 1 (a tied neighbour index or another accepted
    candidate), at random ones 2 (accepted candidates on both sides of
    the index: each delta below 1 px); within ``tol`` on
    >= 0.99 of the pixels out of the flat patch's reach and on >= ``share``
    of all of them."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if near is None:
        near = _near_flat(want.shape)
    near = np.broadcast_to(near[..., None] if want.ndim == 3 else near,
                           want.shape)
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    assert (np.abs(got - want)[fin] <= bound + tol).all()
    ok = np.isclose(got, want, rtol=0, atol=tol, equal_nan=True)
    assert ok[~near].mean() >= 0.99, (ok[~near].mean(),
                                      np.argwhere(~ok & ~near)[:5])
    assert ok.mean() >= share, ok.mean()


def _fv(func_name):
    """The unfolded pair (r = 2, F = 25) on both packages."""
    jl, jr = (j_unfold(R, R, jnp.asarray(x)) for x in (L, RIMG))
    return (jl, jr), (torch.from_numpy(np.asarray(jl)),
                      torch.from_numpy(np.asarray(jr)))


IMAGE_LEVEL = ["refined_barycentric_disp", "refined_barycentric_symmetric_disp",
               "refined_cost_symmetric_disp"]


@pytest.mark.parametrize("fn", IMAGE_LEVEL)
@pytest.mark.parametrize("func", ["ZNCC", "NCC", "SSD", "ZSSD", "SAD",
                                  "ZSAD", "MEDAD"])
def test_image_level_matches_jax(func, fn):
    """Each image-level entry (unfold, cost volume, WTA, refinement; MEDAD
    through the sliding-sub-window subpart solver) at 24x32, r = 2, D = 6,
    1e-4 (the L1 IRLS of SAD/ZSAD and the cost-symmetric parabola 1e-3:
    30 reweighted solves, and a second difference, amplify float32
    roundings).  MEDAD's medians tie exactly over the flat patch (10% of
    the image), where rounding picks the subset in both packages: >= 0.97
    of its pixels agree."""
    want = getattr(J, fn)(JF[func], jnp.asarray(L), jnp.asarray(RIMG), R, R,
                          D)
    got = getattr(T, fn)(TF[func], torch.from_numpy(L),
                         torch.from_numpy(RIMG), R, R, D)
    _agree(got, want, 1e-3 if "SAD" in func or "cost" in fn else 1e-4,
           share=0.97 if func == "MEDAD" else 0.98)


@pytest.mark.parametrize("case", ["pre_normalize", "left_to_right",
                                  "radius2"])
@pytest.mark.parametrize("func", ["ZNCC", "NCC", "SSD"])
def test_fv_level_options_match_jax(func, case):
    """The feature-volume entries with ``pre_normalize``, LEFT_TO_RIGHT,
    and the symmetric refinement at refine_radius = 2 (5 columns), 1e-4
    (cost-symmetric 1e-3)."""
    (jl, jr), (tl, tr) = _fv(func)
    if case == "radius2":
        want = J.refined_barycentric_symmetric_disp_fv(JF[func], jl, jr, D, 2)
        got = T.refined_barycentric_symmetric_disp_fv(TF[func], tl, tr, D, 2)
        _agree(got, want, 1e-4)
        return
    kw = (dict(pre_normalize=True) if case == "pre_normalize"
          else dict(direction=JDir.LEFT_TO_RIGHT))
    tkw = {k: to_port(v) for k, v in kw.items()}
    for name in ("refined_barycentric_disp_fv",
                 "refined_barycentric_symmetric_disp_fv",
                 "refined_cost_symmetric_disp_fv"):
        want = getattr(J, name)(JF[func], jl, jr, D, **kw)
        got = getattr(T, name)(TF[func], tl, tr, D, **tkw)
        _agree(got, want, 1e-3 if "cost" in name else 1e-4)


def _idx(seed, shape=(H, W), lo=0, hi=D):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.int32)


@pytest.mark.parametrize("func", ["ZNCC", "SSD", "MEDAD"])
def test_subpart_refinements_match_jax(func):
    """The subpart (test-set least-median) refinements at given indices,
    sliding 2x2 sub-windows of the 5x5 window, the generic barycentric
    one with a random index field (so every kind of window is solved) and
    the cost-symmetric one at the WTA index, 1e-4 (cost-symmetric 1e-3;
    MEDAD's tied medians: >= 0.97 of all pixels)."""
    from libstevi_tpu_torch.ops.unfold import unfold_sliding_subwindow_idxs
    sub = unfold_sliding_subwindow_idxs(R, R, 2, 2, 1)
    (jl, jr), (tl, tr) = _fv(func)
    idx = _idx(1)
    ti = torch.from_numpy(idx)
    if func == "MEDAD":
        _agree(T.refine_subpart_barycentric_disp(TF[func], tl, tr, ti, sub),
               J.refine_subpart_barycentric_disp(JF[func], jl, jr,
                                                 jnp.asarray(idx), sub), 1e-4,
               share=0.97, bound=2)
        _agree(T.refine_subpart_barycentric_symmetric_disp(
            TF[func], tl, tr, ti, D, sub),
            J.refine_subpart_barycentric_symmetric_disp(
                JF[func], jl, jr, jnp.asarray(idx), D, sub), 1e-4,
            share=0.97, bound=2)
    else:
        with pytest.raises(NotImplementedError):
            T.refine_subpart_barycentric_disp(TF[func], tl, tr, ti, sub)
    _agree(T.refine_barycentric_disp(TF[func], tl, tr, ti),
           J.refine_barycentric_disp(JF[func], jl, jr, jnp.asarray(idx)),
           1e-4, bound=2)
    # the parabola at the WTA index (off the minimum its second difference
    # is small and the delta ill-conditioned in both packages)
    (cl, cr), _ = J._trait_volumes(JF[func], jl, jr, False)
    wta = np.asarray(J._cv_and_index(JF[func], cl, cr, D,
                                     JDir.RIGHT_TO_LEFT))
    _agree(T.refine_cost_symmetric_disp(TF[func], tl, tr,
                                        torch.from_numpy(wta), D),
           J.refine_cost_symmetric_disp(JF[func], jl, jr, jnp.asarray(wta),
                                        D), 1e-3)


S2 = (-2, 2, -2, 2)


@pytest.mark.parametrize("contiguity", ["QUEEN", "ROOK", "BISHOP"])
@pytest.mark.parametrize("func", ["ZNCC", "SSD"])
def test_2d_refinements_match_jax(func, contiguity):
    """`refine_barycentric_2d_disp` (each contiguity's corner directions),
    `refine_barycentric_symmetric_2d_disp` (QUEEN and ROOK: the
    reference defines no symmetric BISHOP) on a random flow field in
    (-2..2)^2, the search gate included, 1e-4 (random indices: 2 px
    bound)."""
    (jl, jr), (tl, tr) = _fv(func)
    flow = _idx(2, (H, W, 2), -2, 3)
    flow[0, 0] = (5, 5)                        # outside the search window
    s2, js2 = SearchOffset2(*S2), JS2(*S2)
    c = JContiguity[contiguity]
    _agree(T.refine_barycentric_2d_disp(TF[func], tr, tl,
                                        torch.from_numpy(flow), s2,
                                        to_port(c)),
           J.refine_barycentric_2d_disp(JF[func], jr, jl, jnp.asarray(flow),
                                        js2, c), 1e-4, bound=2)
    if contiguity != "BISHOP":
        _agree(T.refine_barycentric_symmetric_2d_disp(
            TF[func], tl, tr, torch.from_numpy(flow), s2, to_port(c)),
            J.refine_barycentric_symmetric_2d_disp(
                JF[func], jl, jr, jnp.asarray(flow), js2, c), 1e-4, bound=2)


@pytest.mark.parametrize("fn", ["refined_barycentric_2d_disp",
                                "refined_barycentric_symmetric_2d_disp"])
@pytest.mark.parametrize("func", ["ZNCC", "MEDAD"])
def test_2d_image_level_matches_jax(func, fn):
    """The 2-D image-level entries (2-D volume, 2-D WTA, refinement) over
    (-2..2)^2 on a pair moved by (1.3, 2.4), 1e-4 (MEDAD: the subpart
    solver)."""
    a, b = _pair(shift=(1.3, 2.4), seed=3)
    want = getattr(J, fn)(JF[func], jnp.asarray(a), jnp.asarray(b), R, R,
                          JS2(*S2))
    got = getattr(T, fn)(TF[func], torch.from_numpy(a), torch.from_numpy(b),
                         R, R, SearchOffset2(*S2))
    _agree(got, want, 1e-4)


@pytest.mark.parametrize("chunk", [12, 5, 1])
@pytest.mark.parametrize("kernel,refine", [("pyramid", True),
                                           ("bicubic", True),
                                           ("pyramid", False)])
@pytest.mark.parametrize("func", ["ZNCC", "SSD"])
def test_arbitrary_interpolation_chunked_matches_jax(func, kernel, refine,
                                                     chunk):
    """The chunked candidate scan at n_pixels_cut = 6 (12 candidates):
    one chunk, a chunk size that does not divide 12, one candidate a
    chunk; the first candidate still wins ties (the flat patch's equal
    costs), 1e-4."""
    (jl, jr), (tl, tr) = _fv(func)
    idx = _idx(4)
    want = J.refine_arbitrary_interpolation_disp(
        JF[func], jl, jr, jnp.asarray(idx), 6, kernel, refine)
    got = T.refine_arbitrary_interpolation_disp(
        TF[func], tl, tr, torch.from_numpy(idx), 6, kernel, refine,
        chunk=chunk)
    _agree(got, want, 1e-4)


def test_arbitrary_interpolation_chunks_are_bitwise_one_scan():
    """The chunk size does not change a bit: the fold keeps the first
    minimum (and the first NaN) as one argmin over the scan does."""
    _, (tl, tr) = _fv("ZNCC")
    idx = torch.from_numpy(_idx(5))
    a = T.refine_arbitrary_interpolation_disp(TF.ZNCC, tl, tr, idx, 7,
                                              chunk=14)
    for c in (3, 4, 13):
        assert torch.equal(a, T.refine_arbitrary_interpolation_disp(
            TF.ZNCC, tl, tr, idx, 7, chunk=c))
    best, pos = T._first_min_update(
        torch.tensor([1.0, float("nan"), 2.0]), torch.zeros(3),
        torch.tensor([[0.5, 0.1, float("nan")], [float("nan"), 0.0, 2.0]]),
        torch.tensor([[1.0, 1.0, 1.0], [2.0, 2.0, 2.0]]))
    # columns: the scans (1, 0.5, NaN), (NaN, 0.1, 0), (2, NaN, 2): the
    # first NaN wins each, as an argmin over the whole scan picks it
    assert torch.isnan(best).all() and pos.tolist() == [2.0, 0.0, 1.0]


@pytest.mark.parametrize("refine", [True, False])
def test_arbitrary_interpolation_2d_matches_jax(refine):
    """The 2-D scan at n_pixels_cut = 2 (16 candidates) on a random flow
    field, 1e-4."""
    (jl, jr), (tl, tr) = _fv("ZNCC")
    flow = _idx(6, (H, W, 2), -2, 3)
    want = J.refine_arbitrary_interpolation_2d_disp(
        JF.ZNCC, jr, jl, jnp.asarray(flow), 2, "pyramid", refine)
    got = T.refine_arbitrary_interpolation_2d_disp(
        TF.ZNCC, tr, tl, torch.from_numpy(flow), 2, "pyramid", refine)
    _agree(got, want, 1e-4)


@pytest.mark.parametrize("pad", ["auto", "none", "explicit"])
@pytest.mark.parametrize("filt", ["grpix17r3_filter", "grpix17r4_filter"])
def test_compressed_unfold_matches_jax(filt, pad):
    """`unfold_compressed` with both group-pixel filters (17 features) and
    each padding, and the compressor's margins and sizes, 1e-6."""
    from libstevi_tpu.core.margins import PaddingMargins as JPad
    mask = getattr(TC, filt)()
    assert np.array_equal(mask, getattr(JC, filt)())
    jc, tc = JC.UnFoldCompressor(mask), TC.UnFoldCompressor(mask)
    assert (tc.n_features, tc.height, tc.width, tc.entries) == \
        (jc.n_features, jc.height, jc.width, jc.entries)
    assert tc.margins == to_port(jc.margins) or \
        vars(tc.margins) == vars(jc.margins)
    jp, tp = {"auto": (JPad(), PaddingMargins()),
              "none": (JPad.none(), PaddingMargins.none()),
              "explicit": (JPad.explicit(1, 2, 3, 0),
                           PaddingMargins.explicit(1, 2, 3, 0))}[pad]
    want = np.asarray(JC.unfold_compressed(jc, jnp.asarray(L), jp))
    got = TC.unfold_compressed(tc, torch.from_numpy(L), tp).numpy()
    assert got.shape == want.shape and got.shape[-1] == 17
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
