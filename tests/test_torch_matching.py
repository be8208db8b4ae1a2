"""The port's feature comparisons, unfold, census and feature normalization
against the JAX package on the same numpy inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.core.margins import PaddingMargins as JPad
from libstevi_tpu.ops import census as jcensus
from libstevi_tpu.ops import matching as jmatching
from libstevi_tpu.ops.unfold import PatchOrientation as JOrient
from libstevi_tpu.ops.unfold import unfold as j_unfold
from libstevi_tpu.ops.unfold import unfold_offsets as j_unfold_offsets
from libstevi_tpu.ops.unfold import unfold_permutation as j_unfold_perm
from libstevi_tpu.ops.unfold import unfold_sliding_subwindow_idxs as j_subwin
from libstevi_tpu.ops.cost_volume import normalize_feature_volume as j_norm

from libstevi_tpu_torch.core import PaddingMargins
from libstevi_tpu_torch.ops import census as tcensus
from libstevi_tpu_torch.ops import matching as tmatching
from libstevi_tpu_torch.ops import (unfold, unfold_offsets,
                                    unfold_permutation,
                                    unfold_sliding_subwindow_idxs)
from libstevi_tpu_torch.ops.cost_volume import normalize_feature_volume
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
# one matching function per comparison kernel
KERNEL_FUNCS = {"dot": "CC", "ssd": "SSD", "sad": "SAD", "medad": "MEDAD",
                "hamming": "HAMMING", "kermi": "KERMI"}


def _features(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, shape).astype(np.float32),
            rng.uniform(-1, 1, shape).astype(np.float32))


def _words(seed, shape):
    """uint32 census words with every bit pattern likely, bit 31 included."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32))


@pytest.mark.parametrize("F", [8, 9])
@pytest.mark.parametrize("kernel", list(KERNEL_FUNCS))
def test_feature_comparison_matches_jax(kernel, F):
    func = JMF[KERNEL_FUNCS[kernel]]
    if kernel == "hamming":
        s, t = _words(F, (6, 7, F))
        want = np.asarray(jmatching.feature_comparison(func, jnp.asarray(s),
                                                       jnp.asarray(t)))
        got = tmatching.feature_comparison(
            to_port(func), torch.from_numpy(s.astype(np.int64)),
            torch.from_numpy(t.astype(np.int64))).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        return
    s, t = _features(F, (6, 7, F))
    want = np.asarray(jmatching.feature_comparison(func, jnp.asarray(s),
                                                   jnp.asarray(t)))
    got = tmatching.feature_comparison(to_port(func), torch.from_numpy(s),
                                       torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_median_is_the_upper_median():
    s = torch.tensor([[0.0, 0.0, 0.0, 0.0]])
    t = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert tmatching.median_abs_diff(s, t).item() == 3.0


def test_popcount_matches_jax_on_edge_words():
    w = np.array([0, 1, 2 ** 31, 2 ** 32 - 1, 0x80000001, 0x55555555,
                  0xAAAAAAAA, 0x0F0F0F0F], np.uint32)
    got = tmatching.popcount32(torch.from_numpy(w.astype(np.int64))).numpy()
    want = np.array([bin(int(x)).count("1") for x in w])
    np.testing.assert_array_equal(got, want)
    zeros = np.zeros_like(w)
    jwant = np.asarray(jmatching.hamming_distance(jnp.asarray(w[:, None]),
                                                  jnp.asarray(zeros[:, None])))
    np.testing.assert_array_equal(got, jwant)


def test_compare_feature_volumes_matches_jax():
    s, t = _features(3, (5, 6, 12))
    want = np.asarray(jmatching.compare_feature_volumes(
        JMF.ZSAD, jnp.asarray(s), jnp.asarray(t)))
    got = tmatching.compare_feature_volumes(
        to_port(JMF.ZSAD), torch.from_numpy(s), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("radii", [(1, 2), (3, 3)])
@pytest.mark.parametrize("orientation", ["ROTATE_0", "ROTATE_90",
                                         "ROTATE_180", "ROTATE_270"])
@pytest.mark.parametrize("channels", [1, 3])
def test_unfold_matches_jax(channels, orientation, radii):
    h, v = radii
    shape = (9, 11) if channels == 1 else (9, 11, 3)
    img = np.random.default_rng(channels).uniform(0, 1, shape).astype(
        np.float32)
    jo = JOrient[orientation]
    want = np.asarray(j_unfold(h, v, jnp.asarray(img), orientation=jo))
    got = unfold(h, v, torch.from_numpy(img),
                 orientation=to_port(jo)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        unfold_permutation(h, v, channels, to_port(jo)),
        j_unfold_perm(h, v, channels, jo))


@pytest.mark.parametrize("pad", [(0, 0, 0, 0), (2, 1, 0, 3)])
def test_unfold_explicit_padding_matches_jax(pad):
    img = np.random.default_rng(5).uniform(0, 1, (8, 10)).astype(np.float32)
    want = np.asarray(j_unfold(2, 1, jnp.asarray(img), JPad.explicit(*pad)))
    got = unfold(2, 1, torch.from_numpy(img),
                 PaddingMargins.explicit(*pad)).numpy()
    np.testing.assert_array_equal(got, want)


def test_unfold_offsets_and_subwindows_match_jax():
    img = np.random.default_rng(6).uniform(0, 1, (7, 9, 2)).astype(np.float32)
    offs = [(0, 0), (-2, 1), (3, -4, 1), (1, 1, 0)]
    np.testing.assert_array_equal(
        unfold_offsets(offs, torch.from_numpy(img)).numpy(),
        np.asarray(j_unfold_offsets(offs, jnp.asarray(img))))
    for args in ((2, 1, 3, 2, 1), (3, 3, 2, 2, 3), (1, 1, 4, 4)):
        np.testing.assert_array_equal(
            unfold_sliding_subwindow_idxs(*args), j_subwin(*args))


@pytest.mark.parametrize("F", [2, 9, 33, 34, 49, 147])
def test_census_words_match_jax(F):
    fv = np.random.default_rng(F).uniform(0, 1, (5, 6, F)).astype(np.float32)
    fv[0, 0, 1:] = -1.0          # every bit set: bit 31 of a full word
    want = np.asarray(jcensus.census_features(jnp.asarray(fv)))
    got = tcensus.census_features(torch.from_numpy(fv))
    assert got.dtype == torch.int64
    assert got.shape[-1] == (F - 2) // 32 + 1
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_census_transform_2d_matches_jax():
    img = np.random.default_rng(8).uniform(0, 1, (10, 12)).astype(np.float32)
    want = np.asarray(jcensus.census_transform_2d(jnp.asarray(img), 3, 3))
    got = tcensus.census_transform_2d(torch.from_numpy(img), 3, 3).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("func", [f.name for f in JMF])
def test_normalize_feature_volume_matches_jax(func):
    fv = np.random.default_rng(9).uniform(0.1, 1, (6, 7, 25)).astype(
        np.float32)
    want = np.asarray(j_norm(JMF[func], jnp.asarray(fv)))
    got = normalize_feature_volume(to_port(JMF[func]),
                                   torch.from_numpy(fv)).numpy()
    if want.dtype == np.uint32:
        np.testing.assert_array_equal(got, want.astype(np.int64))
    else:
        np.testing.assert_allclose(got, want, **TOL)
