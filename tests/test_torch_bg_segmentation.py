"""The port's disparity estimator with background removal
(`ops.bg_segmentation`) and its entry points against the JAX package's on
the CPU, on the same numpy-seeded scenes: the foreground mask and the
disparities equal (`array_equal`), the background indices too."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.core.search import SearchOffset1 as JSearch
from libstevi_tpu.ops import unfold as j_unfold
from libstevi_tpu.ops.bg_segmentation import \
    DisparityEstimatorWithBackgroundRemoval as JEst
from libstevi_tpu.ops.cost_volume import (
    feature_volume_to_cost_volume as j_fv2cv,
    unfold_based_cost_volume as j_ubcv)

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction, SearchOffset1
from libstevi_tpu_torch.ops import unfold, unfold_based_cost_volume
from libstevi_tpu_torch.ops.bg_segmentation import \
    DisparityEstimatorWithBackgroundRemoval as TEst

torch.set_num_threads(2)


def _scene(seed=42):
    """`tests/test_matchers_extra.py::TestBgSegmentation`'s scene (32x48,
    a textured 10x10 square at disparity 6 over a background at 2)."""
    rng = np.random.default_rng(seed)
    H, W, d_bg, d_fg = 32, 48, 2, 6
    bg = rng.uniform(0.1, 1, (H, W)).astype(np.float32)
    bg_l = np.roll(bg, d_bg, axis=1)
    live_r = bg.copy()
    obj = rng.uniform(0.1, 1, (10, 10)).astype(np.float32)
    live_r[10:20, 20:30] = obj
    live_l = np.roll(live_r, d_bg, axis=1)
    live_l[10:20, 20 + d_fg:30 + d_fg] = obj
    return bg, bg_l, live_l, live_r


@pytest.mark.parametrize("func", ["ZNCC", "NCC", "ZSAD", "SSD"])
def test_estimator_matches_jax(func):
    """The JAX test's calls (unfold r=2, search [0, 8], threshold 0.9,
    tolerance 2; the live volume by `unfold_based_cost_volume`) for a
    score and a cost family each: background indices, the foreground
    mask and the disparities equal, the volumes within 1e-5."""
    bg, bg_l, live_l, live_r = _scene()
    jest = JEst(JMF[func], 0.9, 2)
    assert jest.compute_background_disp(j_unfold(2, 2, jnp.asarray(bg)),
                                        j_unfold(2, 2, jnp.asarray(bg_l)),
                                        JSearch(0, 8))
    jres = jest.compute_disp_and_foreground_mask(j_ubcv(
        JMF[func], jnp.asarray(live_l), jnp.asarray(live_r), 2, 2, 9))

    t = torch.from_numpy
    test = TEst(MatchingFunction[func], 0.9, 2)
    assert test.compute_background_disp(unfold(2, 2, t(bg)),
                                        unfold(2, 2, t(bg_l)),
                                        SearchOffset1(0, 8))
    tres = test.compute_disp_and_foreground_mask(unfold_based_cost_volume(
        MatchingFunction[func], t(live_l), t(live_r), 2, 2, 9))

    np.testing.assert_allclose(test.bg_cv.numpy(), np.asarray(jest.bg_cv),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(test.bg_idx.numpy(), np.asarray(jest.bg_idx))
    assert tres.fg_mask.dtype == torch.bool and tres.disp.dtype == torch.int32
    np.testing.assert_array_equal(tres.fg_mask.numpy(),
                                  np.asarray(jres.fg_mask))
    np.testing.assert_array_equal(tres.disp.numpy(), np.asarray(jres.disp))
    if func == "ZNCC":        # the JAX test's bars
        mask = tres.fg_mask.numpy()
        assert mask[13:18, 23:27].mean() > 0.6 and mask[:6].mean() < 0.1


def test_invalid_search_is_refused():
    bg, bg_l, _, _ = _scene()
    est = TEst(MatchingFunction.ZNCC)
    assert not est.compute_background_disp(
        unfold(1, 1, torch.from_numpy(bg)), unfold(1, 1, torch.from_numpy(bg_l)),
        SearchOffset1(3, 2))
    assert est.bg_cv is None


@pytest.mark.parametrize("seed", [0, 1])
def test_bg_fg_entry_matches_jax_chain(seed):
    """`entry.bg_fg_background` + `entry.bg_fg_forward` (ZNCC r=3, the
    CLI's chain) on a 48x72 `bg_fg_scene` at D = 24, against the JAX
    tool's calls: mask and disparities equal; the mask holds the pasted
    rectangle (>= 0.95 inside; outside only the occlusion band beside
    it)."""
    (bl, br, ll, lr), rect = entry.bg_fg_scene(48, 72, 3, 9, seed)
    func, r, D = JMF.ZNCC, 3, 24
    search = JSearch(0, D - 1)
    jest = JEst(func, relative_threshold=0.9)
    jest.compute_background_disp(j_unfold(r, r, jnp.asarray(br)),
                                 j_unfold(r, r, jnp.asarray(bl)), search)
    jres = jest.compute_disp_and_foreground_mask(j_fv2cv(
        func, j_unfold(r, r, jnp.asarray(ll)), j_unfold(r, r, jnp.asarray(lr)),
        search))

    t = [torch.from_numpy(x) for x in (bl, br, ll, lr)]
    est = entry.bg_fg_background(t[0], t[1], disp_width=D)
    res = entry.bg_fg_forward(t[2], t[3], est)
    got = res.fg_mask.numpy()
    np.testing.assert_array_equal(got, np.asarray(jres.fg_mask))
    np.testing.assert_array_equal(res.disp.numpy(), np.asarray(jres.disp))
    assert got[rect].mean() >= 0.95
    # outside, foreground only within the window radius of the rectangle
    # or in the occlusion band right of it (the background behind the
    # object in the left image, d_fg - d_bg = 6 columns)
    rows, cols = np.nonzero(rect)
    near = np.zeros_like(rect)
    near[rows.min() - r:rows.max() + r + 1,
         cols.min() - r:cols.max() + 6 + r + 1] = True
    assert got[~near].mean() <= 0.01
    assert (res.disp.numpy()[rect] == 9).mean() >= 0.9
