"""The port's remaining matchers against the JAX package on the CPU, after
`tests/test_matchers_extra.py`: DP stereo, fastmatch (on demand and over a
volume), guided cost-volume filtering, template matching and the
on-demand cost / feature volumes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.core import MATCH_TRAITS as J_TRAITS
from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.core.search import SearchOffset1 as JSearch1
from libstevi_tpu.core.search import SearchOffset2 as JSearch2
from libstevi_tpu.ops import on_demand as jod
from libstevi_tpu.ops.cost_volume import normalize_feature_volume as j_norm
from libstevi_tpu.ops.cost_volume import unfold_based_cost_volume as j_ucv
from libstevi_tpu.ops.dp_stereo import dp_stereo as j_dp
from libstevi_tpu.ops.fastmatch import fastmatch as j_fast
from libstevi_tpu.ops.fastmatch import fastmatch_from_cv as j_fast_cv
from libstevi_tpu.ops.guided_filtering import (
    compute_aggregation_weights as j_weights,
    guided_cost_volume_aggregation as j_guided)
from libstevi_tpu.ops.template_matching import match_pattern as j_match
from libstevi_tpu.ops.unfold import unfold as j_unfold

from libstevi_tpu_torch.core import SearchOffset1, SearchOffset2
from libstevi_tpu_torch.ops import on_demand as tod
from libstevi_tpu_torch.ops.dp_stereo import DpStereoResult, dp_stereo
from libstevi_tpu_torch.ops.fastmatch import fastmatch, fastmatch_from_cv
from libstevi_tpu_torch.ops.guided_filtering import (
    compute_aggregation_weights, guided_cost_volume_aggregation)
from libstevi_tpu_torch.ops.template_matching import match_pattern
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(seed, H=24, W=40, d=4):
    """left(i, j) = right(i, j - d) (rolled), a little noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 1, (H, W)).astype(np.float32)
    noise = rng.normal(0, 0.01, (2, H, W)).astype(np.float32)
    return np.roll(base, d, axis=1) + noise[0], base + noise[1]


def _fv(func, img, r=1):
    """The same normalized feature volume for both packages (census words
    as int64 values for the port)."""
    j = j_norm(func, j_unfold(r, r, jnp.asarray(img)))
    conv = ((lambda x: np.array(x).astype(np.int64))
            if J_TRAITS[func].census else np.array)
    return j, _t(conv(j))


# -- DP stereo ----------------------------------------------------------------

@pytest.mark.parametrize("guide", [False, True], ids=["plain", "guided"])
@pytest.mark.parametrize("case", ["zssd_pair", "noisy_volume"])
def test_dp_stereo_matches_jax(case, guide):
    """Path and occlusion mask equal to JAX's: on a ZSSD volume of a
    shifted pair, and on a random volume with a planted optimum, plain and
    with the guide-modulated jump costs."""
    rng = np.random.default_rng(3)
    if case == "zssd_pair":
        L, R = _pair(4, d=3)
        cv = np.array(j_ucv(JMF.ZSSD, jnp.asarray(L), jnp.asarray(R), 1, 1,
                            8))
        P1, P2 = 0.05, 0.2
    else:
        cv = rng.uniform(0.4, 0.6, (8, 16, 5)).astype(np.float32)
        cv[:, :, 2] = 0.1
        cv[4, 8, 4] = 0.0
        P1, P2 = 0.2, 1.0
    g = rng.uniform(0, 1, cv.shape[:2]).astype(np.float32) if guide else None
    want = j_dp(jnp.asarray(cv), P1, P2,
                None if g is None else jnp.asarray(g), 2.0)
    got = dp_stereo(_t(cv), P1, P2, None if g is None else _t(g), 2.0)
    assert isinstance(got, DpStereoResult)
    assert got.disparity.dtype == torch.int32
    assert got.occlusion.dtype == torch.bool
    np.testing.assert_array_equal(got.disparity.numpy(),
                                  np.asarray(want.disparity))
    np.testing.assert_array_equal(got.occlusion.numpy(),
                                  np.asarray(want.occlusion))


# -- fastmatch ----------------------------------------------------------------

@pytest.mark.parametrize("func,search", [
    ("ZSSD", (0, 9)), ("ZNCC", (0, 9)), ("SAD", (-3, 6)), ("CENSUS", 8)],
    ids=["zssd", "zncc_score", "sad_offset", "census_width"])
def test_fastmatch_matches_jax(func, search):
    """The on-demand fastmatch (three candidates a pixel, a full search
    after two jumps) equals JAX's disparities."""
    f = JMF[func]
    L, R = _pair(5, d=5)
    js, ts = _fv(f, R)      # RIGHT_TO_LEFT: source = right, target = left
    jt, tt = _fv(f, L)
    jsearch = JSearch1(*search) if isinstance(search, tuple) else search
    tsearch = (SearchOffset1(*search) if isinstance(search, tuple)
               else search)
    want = np.asarray(j_fast(f, js, jt, jsearch))
    got = fastmatch(to_port(f), ts, tt, tsearch)
    assert got.dtype == torch.int32 and got.shape == (24, 40)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("func", ["ZSSD", "ZNCC"])
def test_fastmatch_from_cv_matches_jax(func):
    """Propagate-or-research over a precomputed volume: equal indices."""
    f = JMF[func]
    L, R = _pair(6, d=3)
    cv = np.array(j_ucv(f, jnp.asarray(L), jnp.asarray(R), 1, 1, 10))
    want = np.asarray(j_fast_cv(f, jnp.asarray(cv)))
    got = fastmatch_from_cv(to_port(f), _t(cv))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# -- guided filtering ---------------------------------------------------------

@pytest.mark.parametrize("guide_channels", [None, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("radius", [1, 2])
def test_guided_cost_volume_aggregation_matches_jax(radius, guide_channels):
    """The bilateral weights and the weighted aggregation within 1e-5."""
    rng = np.random.default_rng(radius)
    H, W, D = 16, 18, 4
    cv = rng.uniform(0, 1, (H, W, D)).astype(np.float32)
    guide = rng.uniform(0, 1, (H, W) + ((guide_channels,) if guide_channels
                                        else ())).astype(np.float32)
    guide[:, 9:] += 0.5                          # an edge
    kw = dict(sigma_spatial=2.0, sigma_value=0.2)
    np.testing.assert_allclose(
        compute_aggregation_weights(_t(guide), radius, **kw).numpy(),
        np.asarray(j_weights(jnp.asarray(guide), radius, **kw)),
        rtol=1e-5, atol=1e-5)
    want = np.asarray(j_guided(jnp.asarray(cv), jnp.asarray(guide), radius,
                               **kw))
    got = guided_cost_volume_aggregation(_t(cv), _t(guide), radius, **kw)
    assert got.shape == cv.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


# -- template matching --------------------------------------------------------

@pytest.mark.parametrize("normalize", [True, False], ids=["norm", "raw"])
@pytest.mark.parametrize("func", ["ZNCC", "SAD", "NCC"])
def test_match_pattern_matches_jax(func, normalize):
    """Score / cost maps within 1e-5; the template is found where it was
    taken (`tests/test_matchers_extra.py`)."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 1, (24, 24)).astype(np.float32)
    jfv = j_unfold(2, 2, jnp.asarray(img))
    tfv = _t(jfv)
    f = JMF[func]
    want = np.asarray(j_match(f, jfv[10, 13], jfv, normalize))
    got = match_pattern(to_port(f), tfv[10, 13], tfv, normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    best = np.argmin(got) if func == "SAD" else np.argmax(got)
    assert np.unravel_index(best, got.shape) == (10, 13)


# -- on-demand volumes -------------------------------------------------------

@pytest.mark.parametrize("func", ["ZNCC", "SSD", "CENSUS"])
def test_on_demand_stereo_volumes_match_jax(func):
    """The cacheless and memoizing stereo volumes: cost fields (invalid
    candidates +-inf), truncated volumes, scalar access (None outside),
    the memoized planes' count and field, and the full volume, against
    JAX (1e-5; CENSUS equal)."""
    f = JMF[func]
    L, R = _pair(7, H=12, W=20, d=2)
    js, ts = _fv(f, R)
    jt, tt = _fv(f, L)
    s = (-1, 5)
    disp = np.random.default_rng(8).integers(-3, 8, (12, 20)).astype(np.int32)

    def same(got, want):
        want = np.asarray(want)
        if func == "CENSUS":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)

    jc = jod.CachelessOnDemandStereoCostVolume(f, js, jt, JSearch1(*s))
    tc = tod.CachelessOnDemandStereoCostVolume(to_port(f), ts, tt,
                                               SearchOffset1(*s))
    assert tc.shape == tuple(jc.shape) == (12, 20, 7)
    same(tc.cost_field(_t(disp)), jc.cost_field(jnp.asarray(disp)))
    same(tc.truncated_cost_volume(_t(disp), 2),
         jc.truncated_cost_volume(jnp.asarray(disp), 2))
    for pos, d in (((3, 4), 2), ((5, 19), 1), ((0, 0), 6), ((6, 7), (3,))):
        jv, tv = jc.cost_value(pos, d), tc.cost_value(pos, d)
        assert (jv is None) == (tv is None)
        if tv is not None:
            same(tv, jv)

    jm = jod.OnDemandStereoCostVolume(f, js, jt, JSearch1(*s))
    tm = tod.OnDemandStereoCostVolume(to_port(f), ts, tt, SearchOffset1(*s))
    same(tm.cost_value((2, 3), 4), jm.cost_value((2, 3), 4))
    same(tm.cost_value((7, 1), 4), jm.cost_value((7, 1), 4))
    assert tm.n_computed_planes == jm.n_computed_planes == 1
    field = np.clip(disp, -1, 5)
    same(tm.cost_field(_t(field), memoize=True),
         jm.cost_field(jnp.asarray(field), memoize=True))
    assert tm.n_computed_planes == jm.n_computed_planes == 7
    same(tm.cost_field(_t(disp)), jm.cost_field(jnp.asarray(disp)))
    same(tm.full_volume(), jm.full_volume())


@pytest.mark.parametrize("func", ["ZNCC", "SAD"])
def test_on_demand_flow_and_feature_volumes_match_jax(func):
    """The flow volume's cost field over (di, dj) candidates, out-of-search
    and off-image candidates included, and the offset feature volume with
    its normalization."""
    f = JMF[func]
    L, R = _pair(9, H=12, W=16, d=1)
    js, ts = _fv(f, R)
    jt, tt = _fv(f, L)
    rng = np.random.default_rng(10)
    flow = np.stack([rng.integers(-3, 4, (12, 16)),
                     rng.integers(-2, 5, (12, 16))], -1).astype(np.int32)
    s = (-2, 2, -1, 3)
    jf = jod.CachelessOnDemandImageFlowVolume(f, js, jt, JSearch2(*s))
    tf = tod.CachelessOnDemandImageFlowVolume(to_port(f), ts, tt,
                                              SearchOffset2(*s))
    np.testing.assert_allclose(tf.cost_field(_t(flow)).numpy(),
                               np.asarray(jf.cost_field(jnp.asarray(flow))),
                               rtol=1e-5, atol=1e-5)

    offsets = [(-1, 0), (0, -2), (0, 0), (2, 1), (1, 3)]
    jv = jod.OnDemandFeaturesVolume(offsets, jnp.asarray(L), f)
    tv = tod.OnDemandFeaturesVolume(offsets, _t(L), to_port(f))
    np.testing.assert_allclose(tv.features.numpy(), np.asarray(jv.features),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tv.feature_vector(3, 4).numpy(),
                               np.asarray(jv.feature_vector(3, 4)),
                               rtol=1e-5, atol=1e-5)
