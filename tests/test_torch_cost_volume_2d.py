"""The port's 2-D (flow) cost volumes, 2-D WTA, REVERSED/BOTH truncated
bands, the bidirectional band and the in-bound domain against the JAX
package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.core import DispDirection as JDir
from libstevi_tpu.core import ExtractionStrategy as JStrat
from libstevi_tpu.core import MATCH_TRAITS as J_TRAITS
from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.core import TruncatedCvDirection as JTrunc
from libstevi_tpu.core.search import SearchOffset2 as JSearch2
from libstevi_tpu.ops import cost_volume as jcv

from libstevi_tpu_torch.core import SearchOffset2
from libstevi_tpu_torch.ops import cost_volume as tcv
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

H, W = 11, 14
# searches with negative and positive bounds, one-sided ones, one offset
SEARCHES = [(-2, 1, -3, 2), (0, 2, 1, 3), (-3, -1, -2, 0), (0, 0, -1, 1)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _s(s):
    return JSearch2(*s), SearchOffset2(*s)


def _features(func, seed, C=None):
    """The same normalized (H, W, F) feature volumes for both packages:
    census words as int64 values for the port."""
    rng = np.random.default_rng(seed)
    shape = (H, W) + ((C,) if C else ())
    L, R = (rng.uniform(0.1, 1, shape).astype(np.float32) for _ in range(2))
    j = [jcv.normalize_feature_volume(func, jcv.unfold(1, 1, jnp.asarray(x)))
         for x in (L, R)]
    conv = ((lambda x: np.asarray(x).astype(np.int64))
            if J_TRAITS[func].census else np.asarray)
    return L, R, j, [_t(conv(x)) for x in j]


@pytest.mark.parametrize("search", SEARCHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("func", ["ZNCC", "CC", "SSD", "ZSAD", "CENSUS"])
def test_aggregate_cost_2d_matches_jax(func, search):
    """(H, W, D0, D1) volumes within 1e-5 (CENSUS equal) for the dot, SSD,
    SAD and CENSUS families; the direction's sign is ignored, as in the
    reference's 2-D overload."""
    f = JMF[func]
    _, _, (jl, jr), (tl, tr) = _features(f, 1)
    js, ts = _s(search)
    for d in ("RIGHT_TO_LEFT", "LEFT_TO_RIGHT"):
        want = np.asarray(jcv.aggregate_cost(f, jl, jr, js, JDir[d]))
        got = tcv.aggregate_cost(to_port(f), tl, tr, ts,
                                 to_port(JDir[d])).numpy()
        assert got.shape == want.shape == (H, W, ts.count0, ts.count1)
        if func == "CENSUS":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("func", ["ZNCC", "SAD", "CENSUS"])
def test_unfold_based_2d_volume_and_wta_match_jax(func, channels):
    """`unfold_based_2d_disparity_cost_volume` (and the 1-D entry taking a
    SearchOffset2, which 'auto' sends to the unfold route) within 1e-5,
    and the 2-D WTA indices and disparities equal JAX's."""
    f = JMF[func]
    L, R, _, _ = _features(f, 2, channels)
    js, ts = _s((-2, 2, -1, 3))
    want = np.asarray(jcv.unfold_based_2d_disparity_cost_volume(
        f, jnp.asarray(L), jnp.asarray(R), 1, 1, js))
    got = tcv.unfold_based_2d_disparity_cost_volume(
        to_port(f), _t(L), _t(R), 1, 1, ts)
    got1 = tcv.unfold_based_cost_volume(to_port(f), _t(L), _t(R), 1, 1, ts)
    assert torch.equal(got, got1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    strat = J_TRAITS[f].strategy
    # WTA on the same volume: equal indices, ties to the last (d0, d1)
    wi = np.asarray(jcv.extract_selected_2d_index(jnp.asarray(want), strat))
    gi = tcv.extract_selected_2d_index(_t(want), to_port(strat))
    assert gi.dtype == torch.int32 and gi.shape == (H, W, 2)
    np.testing.assert_array_equal(gi.numpy(), wi)
    np.testing.assert_array_equal(
        tcv.selected_2d_index_to_disp(gi, ts).numpy(),
        np.asarray(jcv.selected_2d_index_to_disp(jnp.asarray(wi), js)))


@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
def test_2d_wta_ties_go_to_the_last_index(strategy):
    """A volume of small integers (many ties): the row-major last optimum
    wins, as JAX's flipped argmin / argmax."""
    rng = np.random.default_rng(5)
    cv = rng.integers(0, 3, (6, 7, 4, 5)).astype(np.float32)
    cv[0, 0] = 1.0                              # all tied: (3, 4)
    s = JStrat[strategy]
    want = np.asarray(jcv.extract_selected_2d_index(jnp.asarray(cv), s))
    got = tcv.extract_selected_2d_index(_t(cv), to_port(s)).numpy()
    np.testing.assert_array_equal(got, want)
    assert tuple(got[0, 0]) == (3, 4)


def _band_case(seed, H2=10, W2=20, D2=6):
    rng = np.random.default_rng(seed)
    cv = rng.uniform(0, 5, (H2, W2, D2)).astype(np.float32)
    sel = rng.integers(0, D2, (H2, W2)).astype(np.int32)
    return cv, sel


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("direction", ["RIGHT_TO_LEFT", "LEFT_TO_RIGHT"],
                         ids=["r2l", "l2r"])
@pytest.mark.parametrize("sdir", ["SAME", "REVERSED", "BOTH"])
def test_truncated_cost_volume_modes_match_jax(sdir, direction, r):
    """SAME, REVERSED and BOTH bands (the reference's validity rules
    verbatim, `tests/test_cost_volume.py`'s direct-loop case): NaN
    patterns equal, values within 1e-5; the in-bound domain equal to
    JAX's and to the band's non-NaN pattern."""
    cv, sel = _band_case(11 + r)
    hr, vr = 2, 1
    kw = dict(direction=JDir[direction], sdir=JTrunc[sdir])
    tkw = {k: to_port(v) for k, v in kw.items()}
    want = np.asarray(jcv.truncated_cost_volume(
        jnp.asarray(cv), jnp.asarray(sel), hr, vr, r, **kw))
    got = tcv.truncated_cost_volume(_t(cv), _t(sel), hr, vr, r, **tkw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-5)

    D2 = cv.shape[-1]
    ib_j = np.asarray(jcv.extract_in_bound_domain(jnp.asarray(sel), D2, hr,
                                                  vr, r, **kw))
    ib = tcv.extract_in_bound_domain(_t(sel), D2, hr, vr, r, **tkw)
    assert ib.dtype == torch.int32
    np.testing.assert_array_equal(ib.numpy(), ib_j)
    np.testing.assert_array_equal(ib.numpy() == 1, ~np.isnan(got))


@pytest.mark.parametrize("radii", [(1, 1), (2, 1), (0, 0), (1, 0)],
                         ids=["r1", "r2x1", "r0", "r1x0"])
def test_truncated_bidirectional_matches_jax(radii):
    """The (2r0+1, 2r1+1) window around a 2-D index, NaN out of range;
    radius 0 reads as 1, and radius1 < 1 takes radius0."""
    rng = np.random.default_rng(sum(radii) + 3)
    cv = rng.uniform(0, 1, (6, 8, 5, 4)).astype(np.float32)
    sel = np.stack([rng.integers(0, 5, (6, 8)), rng.integers(0, 4, (6, 8))],
                   -1).astype(np.int32)
    want = np.asarray(jcv.truncated_bidirectional_cost_volume(
        jnp.asarray(cv), jnp.asarray(sel), *radii))
    got = tcv.truncated_bidirectional_cost_volume(_t(cv), _t(sel),
                                                  *radii).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_array_equal(got[m], want[m])


def test_box_route_refuses_a_2d_search():
    """'box' covers 1-D searches only, in both packages."""
    x = torch.zeros(6, 7)
    with pytest.raises(NotImplementedError):
        tcv.unfold_based_cost_volume(to_port(JMF.SSD), x, x, 1, 1,
                                     SearchOffset2(-1, 1, -1, 1),
                                     backend="box")
