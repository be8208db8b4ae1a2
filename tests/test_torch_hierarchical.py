"""The port's hierarchical matcher and `interpolation` package against the
JAX package on the CPU: average-pooling downsampling, the four
interpolation functions, the guide upsampling (bit for bit), the guided
truncated volume in both directions, the whole coarse-to-fine matcher on
the 96x128 parity fixtures, and the port alone at the PARITY_r05
`hierarchical_d2` bars on the 480x640 fixtures."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.core import DispDirection as JDir
from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.interpolation import (average_pooling_downsample as j_down,
                                        bicubic_sample as j_bicubic,
                                        bilinear_sample as j_bilinear,
                                        interpolate_image as j_interp,
                                        resample_image as j_resample)
from libstevi_tpu.ops.cost_volume import normalize_feature_volume as j_norm
from libstevi_tpu.ops.hierarchical import (
    _bilinear_guide as j_guide, compute_guided_cv as j_guided,
    hierarchical_truncated_cost_volume as j_hier)
from libstevi_tpu.ops.unfold import unfold as j_unfold

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.interpolation import (average_pooling_downsample,
                                              bicubic_sample, bilinear_sample,
                                              interpolate_image,
                                              resample_image)
from libstevi_tpu_torch.io import read_stevimg
from libstevi_tpu_torch.ops.hierarchical import (
    _bilinear_guide, _window_costs, compute_guided_cv,
    hierarchical_truncated_cost_volume)
from libstevi_tpu_torch.reference import to_port
from libstevi_tpu_torch.statistics import inlier_mae, prop_good

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data" / "parity"
# PARITY_r05.json, row hierarchical_d2: prop_good_2.0 minus 0.001 and
# inlier_mae plus 0.01
BARS = {"": (0.9651, 0.2766), "_occ": (0.9529, 0.4715)}


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("shape", [(8, 12), (7, 10), (9, 5), (13, 17)])
@pytest.mark.parametrize("window", [2, 3, (2, 3)], ids=["w2", "w3", "w2x3"])
def test_downsample_matches_jax(window, shape, channels):
    """Output ceil(size / window), the cross-applied offsets (7x10 and 9x5
    crop trailing rows or columns), count-normalized border windows:
    within 1e-6 of JAX."""
    rng = np.random.default_rng(sum(shape))
    img = rng.uniform(0, 1, shape + ((channels,) if channels else ())
                      ).astype(np.float32)
    hw, vw = window if isinstance(window, tuple) else (window, None)
    want = np.asarray(j_down(jnp.asarray(img), hw, vw))
    got = average_pooling_downsample(_t(img), hw, vw).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _coords(rng, H, W, n=(9, 11)):
    """Sample positions reaching past every border."""
    ci = rng.uniform(-1.5, H + 0.5, n)
    cj = rng.uniform(-1.5, W + 0.5, n)
    return np.stack([ci, cj], -1).astype(np.float32)


@pytest.mark.parametrize("zero_border", [False, True], ids=["clamp", "zero"])
@pytest.mark.parametrize("channels", [None, 3], ids=["gray", "rgb"])
@pytest.mark.parametrize("fn", ["bilinear", "bicubic", "interpolate",
                                "resample"])
def test_interpolation_matches_jax(fn, channels, zero_border):
    """The four sampling functions within 1e-5 of JAX, off-image too."""
    rng = np.random.default_rng(3)
    H, W = 10, 13
    img = rng.uniform(0, 1, (H, W) + ((channels,) if channels else ())
                      ).astype(np.float32)
    c = _coords(rng, H, W)
    ji, jc, ti, tc = jnp.asarray(img), jnp.asarray(c), _t(img), _t(c)
    if fn == "bilinear":
        want, got = j_bilinear(ji, jc, zero_border), bilinear_sample(
            ti, tc, zero_border)
    elif fn == "bicubic":
        want, got = j_bicubic(ji, jc, zero_border), bicubic_sample(
            ti, tc, zero_border)
    elif fn == "interpolate":
        want, got = (j_interp(ji, jc, "bicubic", zero_border),
                     interpolate_image(ti, tc, "bicubic", zero_border))
    else:
        want, got = j_resample(ji, jc, "bicubic"), resample_image(
            ti, tc, "bicubic")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        interpolate_image(ti, tc, "lanczos")


@pytest.mark.parametrize("shapes", [
    ((3, 4), (6, 8)), ((5, 7), (9, 13)), ((60, 80), (120, 160)),
    ((240, 320), (480, 640)), ((90, 160), (180, 320)),
    ((360, 640), (720, 1280))],
    ids=lambda s: f"{s[0][0]}x{s[0][1]}")
def test_bilinear_guide_bitwise(shapes):
    """The upsampled guide equals JAX's bit for bit (its floor, ceil and
    half-to-even rounding decide the guided window's center)."""
    (hg, wg), (h, w) = shapes
    rng = np.random.default_rng(hg * wg)
    g = rng.integers(0, 60, (hg, wg)).astype(np.int32)
    want = np.asarray(j_guide(jnp.asarray(g), h, w))
    got = _bilinear_guide(_t(g), h, w).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.round(got), np.asarray(jnp.round(want)))


def _shifted_pair(seed, H, W, d):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 1, (H, W)).astype(np.float32)
    noise = rng.normal(0, 0.01, (H, W)).astype(np.float32)
    return np.roll(base, d, axis=1) + noise, base


@pytest.mark.parametrize("direction", ["RIGHT_TO_LEFT", "LEFT_TO_RIGHT"],
                         ids=["r2l", "l2r"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("func", ["ZNCC", "SAD", "CENSUS"])
def test_guided_cv_matches_jax(func, r, direction):
    """compute_guided_cv on the same normalized feature volumes and guide:
    disp_estimate equal wherever the best and second-best costs of the
    first window differ by more than 1e-4 or are exactly equal (two slots
    past the border compare with the same zero vector), everywhere for
    CENSUS, and the truncated volume within 1e-4 (CENSUS equal) where the
    estimates agree."""
    f = JMF[func]
    L, R = _shifted_pair(7, 24, 40, 3)
    jl = j_norm(f, j_unfold(2, 2, jnp.asarray(L)))
    jr = j_norm(f, j_unfold(2, 2, jnp.asarray(R)))
    conv = (lambda x: np.asarray(x).astype(np.int64)) if func == "CENSUS" \
        else np.asarray
    tl, tr = _t(conv(jl)), _t(conv(jr))
    guide = np.random.default_rng(1).integers(0, 4, (12, 20)).astype(np.int32)
    jd = JDir[direction]
    want = j_guided(f, jl, jr, jnp.asarray(guide), r, jd)
    got = compute_guided_cv(to_port(f), tl, tr, _t(guide), r, to_port(jd))
    wd = np.asarray(want.disp_estimate)
    gd = got.disp_estimate.numpy()
    assert gd.dtype == np.int32 and gd.shape == (24, 40)

    # the first window's gap between its best and second-best costs
    src, tgt = (tr, tl) if direction == "RIGHT_TO_LEFT" else (tl, tr)
    sign = to_port(jd).delta_sign
    d0 = (sign * torch.round(_bilinear_guide(_t(guide), 24, 40))).int()
    c0 = _window_costs(to_port(f), src, tgt, d0, r, torch.float32)
    top2 = torch.topk(c0, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    clear = (gap > 1e-4) | (gap == 0)
    if func == "CENSUS":
        np.testing.assert_array_equal(gd, wd)
    else:
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(gd[clear], wd[clear])
    same = gd == wd
    wt = np.asarray(want.truncated_cost_volume)
    gt = got.truncated_cost_volume.numpy()
    assert gt.shape == wt.shape == (24, 40, 2 * r + 1)
    if func == "CENSUS":
        np.testing.assert_array_equal(gt, wt)
    else:
        np.testing.assert_allclose(gt[same], wt[same], rtol=1e-4, atol=1e-4)


def _small(suffix):
    return [read_stevimg(str(DATA / f"{s}{suffix}_small.stevimg"))
            for s in ("left", "right")]


@pytest.mark.parametrize("case", [
    dict(func="ZNCC", depth=1, r=3),
    dict(func="ZNCC", depth=2, r=3),
    dict(func="ZNCC", depth=2, r=[1, 2, 3]),
    dict(func="ZNCC", depth=2, r=3, bf16=True),
    dict(func="ZSAD", depth=2, r=2),
    dict(func="CENSUS", depth=2, r=2),
    dict(func="ZNCC", depth=1, r=2, direction="LEFT_TO_RIGHT"),
], ids=["zncc_d1", "zncc_d2", "zncc_d2_radius_list", "zncc_d2_bf16",
        "zsad_d2", "census_d2", "zncc_d1_l2r"])
@pytest.mark.parametrize("suffix", ["", "_occ"], ids=["warp", "occluded"])
def test_hierarchical_matches_jax(case, suffix):
    """The whole matcher on the 96x128 fixtures: disp_estimate equal to
    JAX's on >= 0.995 of pixels (the coarsest volumes come from two box
    routes that add in different orders), and the truncated volume within
    1e-4 (a bf16 ulp for bf16) where the estimates agree."""
    L, R = _small(suffix)
    f = JMF[case["func"]]
    jd = JDir[case.get("direction", "RIGHT_TO_LEFT")]
    bf16 = case.get("bf16", False)
    r = case["r"]
    want = j_hier(f, jnp.asarray(L), jnp.asarray(R), r, r, 24,
                  depth=case["depth"], direction=jd,
                  cv_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    got = hierarchical_truncated_cost_volume(
        to_port(f), _t(L), _t(R), r, r, 24, depth=case["depth"],
        direction=to_port(jd),
        cv_dtype=torch.bfloat16 if bf16 else torch.float32)
    wd = np.asarray(want.disp_estimate)
    gd = got.disp_estimate.numpy()
    assert gd.shape == wd.shape == (96, 128) and gd.dtype == np.int32
    same = gd == wd
    assert same.mean() >= 0.995, same.mean()
    wt = np.asarray(want.truncated_cost_volume.astype(jnp.float32))
    gt = got.truncated_cost_volume.float().numpy()
    assert gt.shape == wt.shape == (96, 128, 5)
    tol = 2 ** -7 if bf16 else 1e-4
    np.testing.assert_allclose(gt[same], wt[same], rtol=tol, atol=tol)


@pytest.mark.parametrize("suffix", ["", "_occ"], ids=["warp", "occluded"])
def test_hierarchical_forward_meets_parity_bars(suffix):
    """`entry.hierarchical_forward` (ZNCC 7x7, D=120, depth 2) on the
    480x640 fixtures meets the PARITY_r05 `hierarchical_d2` bars."""
    L, R = (torch.from_numpy(read_stevimg(str(DATA / f"{s}{suffix}.stevimg")))
            for s in ("left", "right"))
    gt = read_stevimg(str(DATA / f"gt{suffix}.stevimg"))
    disp = entry.hierarchical_forward(L, R)
    assert disp.shape == (480, 640) and disp.dtype == torch.int32
    d = disp.float().numpy()
    pg_bar, mae_bar = BARS[suffix]
    assert prop_good(d, gt, 2.0) >= pg_bar
    assert inlier_mae(d, gt, 2.0) <= mae_bar


def test_hierarchical_refuses_depth_0():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError):
        hierarchical_truncated_cost_volume(to_port(JMF.ZNCC), x, x, 1, 1, 4,
                                           depth=0)
