"""The port's filters and dot-family box cost volume (K1's plain version)
against the JAX package: `box_backend.box_cost_volume` and the Pallas K1
kernel in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF, DispDirection as JDir
from libstevi_tpu.core.search import SearchOffset1 as JSearch1
from libstevi_tpu.ops import filters as jfilters
from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
from libstevi_tpu.ops.box_pallas import box_cost_volume_fused_padded
from libstevi_tpu.ops.cost_volume import unfold_based_cost_volume as j_unfold

from libstevi_tpu_torch.core.search import SearchOffset1, SearchOffset2
from libstevi_tpu_torch.ops import filters as tfilters
from libstevi_tpu_torch.ops import box_cost_volume, unfold_based_cost_volume
from libstevi_tpu_torch.ops.box_cuda import box_cv, box_cv_plain
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
    """Every 1-D matching function is ported now; what is left is the 2-D
    search, and the box route refuses a function it cannot decompose, as
    the JAX package does."""
    L, R = (torch.zeros(8, 8),) * 2
    with pytest.raises(ValueError):
        box_cost_volume(to_port(JMF.CENSUS), L, R, 1, 1, 4)
    with pytest.raises(NotImplementedError):
        box_cost_volume(to_port(JMF.SSD), L, R, 1, 1,
                        SearchOffset2(-1, 1, -1, 1))
    with pytest.raises(NotImplementedError):
        unfold_based_cost_volume(to_port(JMF.CENSUS), L, R, 1, 1,
                                 SearchOffset2(-1, 1, -1, 1))


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


def test_k1_wrapper_on_cpu_is_the_plain_version():
    L, R = _pair(5, (10, 13))
    args = (to_port(JMF.ZNCC), torch.from_numpy(L), torch.from_numpy(R),
            1, 2, 6, torch.bfloat16, True)
    before = box_cv.launches
    np.testing.assert_array_equal(box_cv(*args).float().numpy(),
                                  box_cv_plain(*args).float().numpy())
    assert box_cv.launches == before
