"""The port's filters and dot-family box cost volume (K1's plain version)
against the JAX package: `box_backend.box_cost_volume` and the Pallas K1
kernel in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF, DispDirection as JDir
from libstevi_tpu.core.search import SearchOffset1 as JSearch1
from libstevi_tpu.core.search import SearchOffset2 as JSearch2
from libstevi_tpu.ops import filters as jfilters
from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
from libstevi_tpu.ops.box_pallas import box_cost_volume_fused_padded
from libstevi_tpu.ops.cost_volume import unfold_based_cost_volume as j_unfold

from libstevi_tpu_torch.core.search import SearchOffset1, SearchOffset2
from libstevi_tpu_torch.ops import filters as tfilters
from libstevi_tpu_torch.ops import box_cost_volume, unfold_based_cost_volume
from libstevi_tpu_torch.ops.box_cuda import (box_cv, box_cv_plain,
                                             window_stats, _prep_inputs)
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
DOT = ["CC", "NCC", "ZCC", "ZNCC"]


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


@pytest.mark.parametrize("name", ["box_filter_2d", "mean_filter_2d",
                                  "sigma_filter"])
@pytest.mark.parametrize("shape,h,v", [((17, 23), 2, 3), ((9, 12, 3), 1, 2)])
def test_filters_match_jax(name, shape, h, v):
    x = np.random.default_rng(0).uniform(0, 1, shape).astype(np.float32)
    want = np.asarray(getattr(jfilters, name)(jnp.asarray(x), h, v))
    got = getattr(tfilters, name)(torch.from_numpy(x), h, v).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("direction", ["RIGHT_TO_LEFT", "LEFT_TO_RIGHT"])
@pytest.mark.parametrize("func", DOT)
def test_box_cost_volume_matches_jax(func, direction):
    L, R = _pair(1, (18, 27))
    want = np.asarray(j_box(JMF[func], jnp.asarray(L), jnp.asarray(R), 2, 3,
                            9, JDir[direction]))
    got = box_cost_volume(to_port(JMF[func]), torch.from_numpy(L),
                          torch.from_numpy(R), 2, 3, 9,
                          to_port(JDir[direction])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", ["offset_search", "multichannel", "bf16"])
def test_box_cost_volume_variants_match_jax(case):
    L, R = _pair(2, (15, 22, 3) if case == "multichannel" else (15, 22))
    args, jkw, tkw = (2, 1), {}, {}
    search_j, search_t = 8, 8
    if case == "offset_search":
        search_j, search_t = JSearch1(-3, 4), SearchOffset1(-3, 4)
    if case == "bf16":
        jkw, tkw = dict(cv_dtype=jnp.bfloat16), dict(cv_dtype=torch.bfloat16)
    want = np.asarray(j_box(JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), *args,
                            search_j, **jkw), np.float32)
    got = box_cost_volume(to_port(JMF.ZNCC), torch.from_numpy(L),
                          torch.from_numpy(R), *args, search_t,
                          **tkw).float().numpy()
    if case == "bf16":
        # one bf16 ulp: independent f32 sums may round to neighbours
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-4)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("func", DOT)
def test_unfold_based_cost_volume_matches_jax(func):
    L, R = _pair(3, (14, 20))
    want = np.asarray(j_unfold(JMF[func], jnp.asarray(L), jnp.asarray(R),
                               3, 3, 7))
    got = unfold_based_cost_volume(to_port(JMF[func]), torch.from_numpy(L),
                                   torch.from_numpy(R), 3, 3, 7).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_non_dot_costs_are_not_ported_yet():
    """Every matching function and search is ported now: the box route
    refuses a function it cannot decompose and a 2-D search, as the JAX
    package does, and `unfold_based_cost_volume` takes a 2-D search on the
    unfold route (it raised before the 2-D volumes were ported), equal to
    JAX's for CENSUS."""
    L, R = (torch.zeros(8, 8),) * 2
    with pytest.raises(ValueError):
        box_cost_volume(to_port(JMF.CENSUS), L, R, 1, 1, 4)
    with pytest.raises(NotImplementedError):
        box_cost_volume(to_port(JMF.SSD), L, R, 1, 1,
                        SearchOffset2(-1, 1, -1, 1))
    Ln, Rn = _pair(9, (8, 8))
    got = unfold_based_cost_volume(to_port(JMF.CENSUS), torch.from_numpy(Ln),
                                   torch.from_numpy(Rn), 1, 1,
                                   SearchOffset2(-1, 1, -1, 1))
    want = j_unfold(JMF.CENSUS, jnp.asarray(Ln), jnp.asarray(Rn), 1, 1,
                    JSearch2(-1, 1, -1, 1))
    assert got.shape == (8, 8, 3, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bake", [False, True], ids=["plain", "pout_baked"])
@pytest.mark.parametrize("func", DOT)
def test_k1_plain_matches_pallas_kernel(func, bake):
    """K1's plain path (the CPU branch of `box_cv`) against the TPU kernel
    run in interpret mode: the Pallas output is (Hp, Dp, Wp), negated for
    SCORE and optionally Pout-baked; un-negate, un-bake and strip the
    padding before comparing."""
    H, W, D, Dp = 16, 24, 7, 8
    L, R = _pair(4, (H, W))
    pout = 100.0
    a = box_cost_volume_fused_padded(JMF[func], jnp.asarray(L),
                                     jnp.asarray(R), 2, 3, D, Dp,
                                     jnp.float32, negate=True,
                                     pout_bake=pout if bake else None,
                                     interpret=True)
    want = np.moveaxis(np.asarray(a)[:H, :D, :W], 1, -1)       # (H, W, D)
    out_of_range = (np.arange(W)[:, None] + np.arange(D)[None, :]) >= W
    if bake:
        assert (want[:, out_of_range] == pout).all()
        want = np.where(out_of_range, 0.0, want)
    got = box_cv(to_port(JMF[func]), torch.from_numpy(L), torch.from_numpy(R),
                 2, 3, D, negate=True).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def _flat_pair(value):
    """A random 24x40 pair with one 14x25 patch of ``value`` in both
    images, as saturated or textureless areas of 8-bit images are."""
    L, R = _pair(6, (24, 40))
    L[5:19, 8:33] = value
    R[5:19, 8:33] = value
    return L, R


FLAT = {"flat_200_255": 200 / 255, "flat_85_255": 85 / 255, "flat_0.7": 0.7}


@pytest.mark.parametrize("patch", list(FLAT))
@pytest.mark.parametrize("func", DOT)
def test_k1_plain_matches_pallas_on_flat_patches(func, patch):
    """K1's plain version against the TPU kernel (interpret mode) on a pair
    with a flat patch, 7x7 windows, D = 7.  ZNCC is ill-conditioned where
    the source or the target window lies wholly inside the patch: s2 - s *
    s / n cancels to a few ulps, the inverse sigma grows large and
    amplifies the rounding noise of zcc, so any other order of the sums
    moves such entries by O(1).  The reference's own two routes disagree
    there: on this pair the Pallas K1 and `box_backend` differ by up to
    0.44 (200/255) and 0.28 (85/255), and the port's plain K1 differs from
    the Pallas K1 by up to 0.57, 0.28 and 1.0 (0.7).  So those entries are
    held to be finite; every other entry, and every entry of CC, NCC and
    ZCC, within 1e-4."""
    H, W, D, h, v = 24, 40, 7, 3, 3
    L, R = _flat_pair(FLAT[patch])
    a = box_cost_volume_fused_padded(JMF[func], jnp.asarray(L),
                                     jnp.asarray(R), h, v, D, 8,
                                     jnp.float32, negate=True,
                                     interpret=True)
    want = np.moveaxis(np.asarray(a)[:H, :D, :W], 1, -1)       # (H, W, D)
    got = box_cv_plain(to_port(JMF[func]), torch.from_numpy(L),
                       torch.from_numpy(R), h, v, D, negate=True).numpy()
    patch_map = np.zeros((H, W), np.float32)
    patch_map[5:19, 8:33] = 1
    inside = tfilters.box_filter_2d(torch.from_numpy(patch_map), h,
                                    v).numpy() == (2 * h + 1) * (2 * v + 1)
    cols = np.arange(W)[:, None] + np.arange(D)
    flat = inside[..., None] | np.where(cols < W,
                                        inside[:, np.minimum(cols, W - 1)],
                                        False)
    assert flat.any() and np.isfinite(got).all()
    keep = ~flat if func == "ZNCC" else np.ones_like(flat)
    np.testing.assert_allclose(got[keep], want[keep], **TOL)


F32 = np.float32


def _emulate_stats(x, h, v, ncc):
    """The statistics kernel's loops in float32 scalars (no FMA): a window
    column's vertical sum from its top row, then the horizontal fold, zero
    outside the image; the variance s2 - (s * s) / n, clamped at 0."""
    H, W = x.shape
    n = F32((2 * h + 1) * (2 * v + 1))

    def px(i, j):
        return x[i, j] if 0 <= i < H and 0 <= j < W else F32(0)

    sums, invs = np.zeros((H, W), F32), np.zeros((H, W), F32)
    for i in range(H):
        for j in range(W):
            vs, vq = [], []
            for c in range(j - h, j + h + 1):
                s = px(i - v, c)
                q = s * s
                for a in range(1, 2 * v + 1):
                    y = px(i - v + a, c)
                    s = s + y
                    q = q + y * y
                vs.append(s)
                vq.append(q)
            s, q = vs[0], vq[0]
            for b in range(1, 2 * h + 1):
                s = s + vs[b]
                q = q + vq[b]
            den = np.sqrt(q) if ncc else np.sqrt(max(q - s * s / n, F32(0)))
            sums[i, j] = s
            invs[i, j] = F32(1) / den if den > 0 else F32(0)
    return sums, invs


def _emulate_volume(kind, src, tgt, stats, h, v, D, negate):
    """The volume kernel's loops in float32 scalars: per entry the
    vertical sums of the 2h + 1 window columns, folded left to right, then
    zcc = cross - (sum_s * sum_t_d) * (1/n) and (zcc * inv_s) * inv_t_d."""
    H, W = src.shape
    sum_s, inv_s, sum_t, inv_t = stats
    inv_n = F32(1.0 / ((2 * h + 1) * (2 * v + 1)))

    def px(x, i, j):
        return x[i, j] if 0 <= i < H and 0 <= j < W else F32(0)

    out = np.zeros((H, W, D), F32)
    for i in range(H):
        for j in range(W):
            for d in range(D):
                if j + d >= W:
                    continue
                cols = []
                for c in range(j - h, j + h + 1):
                    acc = px(src, i - v, c) * px(tgt, i - v, c + d)
                    for a in range(1, 2 * v + 1):
                        acc = acc + px(src, i - v + a, c) * px(tgt, i - v + a,
                                                               c + d)
                    cols.append(acc)
                c = cols[0]
                for b in range(1, 2 * h + 1):
                    c = c + cols[b]
                if kind & 2:
                    c = c - sum_s[i, j] * sum_t[i, j + d] * inv_n
                if kind & 1:
                    c = c * inv_s[i, j] * inv_t[i, j + d]
                out[i, j, d] = -c if negate else c
    return out


@pytest.mark.parametrize("hv", [(3, 3), (2, 1), (0, 2), (6, 1)])
@pytest.mark.parametrize("func", DOT)
def test_k1_plain_is_the_kernels_arithmetic(func, hv):
    """The bitwise contract of K1's two kernels, on the CPU: `_prep_inputs`
    and `box_cv_plain` equal a float32 scalar replay of the kernels' loops
    (`csrc/box_cv.cu`) bit for bit, on a pair with a flat patch (where
    ZNCC cancels) and at window widths the kernel unrolls (5, 7) and does
    not (1, 13)."""
    h, v = hv
    H, W, D = 9, 14, 5
    L, R = _pair(7, (H, W))
    L[2:8, 3:11] = R[2:8, 3:11] = 200 / 255
    f = to_port(JMF[func])
    src, tgt, *stats, n = _prep_inputs(f, torch.from_numpy(L),
                                       torch.from_numpy(R), h, v)
    ncc = func == "NCC"
    want = _emulate_stats(R, h, v, ncc) + _emulate_stats(L, h, v, ncc)
    for got, w in zip(stats, want):
        np.testing.assert_array_equal(got.numpy(), w)
    vol = box_cv_plain(f, torch.from_numpy(L), torch.from_numpy(R), h, v, D,
                       negate=True)
    np.testing.assert_array_equal(
        vol.numpy(), _emulate_volume(DOT.index(func), R, L, want, h, v, D,
                                     True))


def test_k1_wrapper_on_cpu_is_the_plain_version():
    L, R = _pair(5, (10, 13))
    args = (to_port(JMF.ZNCC), torch.from_numpy(L), torch.from_numpy(R),
            1, 2, 6, torch.bfloat16, True)
    before = (box_cv.launches, window_stats.launches)
    np.testing.assert_array_equal(box_cv(*args).float().numpy(),
                                  box_cv_plain(*args).float().numpy())
    for got, want in zip(window_stats(*args[:5]), _prep_inputs(*args[:5])):
        assert got == want if isinstance(got, float) else torch.equal(got,
                                                                      want)
    assert (box_cv.launches, window_stats.launches) == before
