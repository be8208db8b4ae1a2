"""The port's `sparse` chain against the JAX package's on the CPU, on the
same numpy-seeded inputs: Harris (plain, windowed, masked, 3-channel) at
rtol = atol = 1e-5 of the score's range, FAST maps exactly, the
non-local-maximum selection exactly on one score map (JAX's), orientation
and the descriptors at keypoints on and near the border (BRIEF words
exactly, oriented BRIEF off near-ties, whitened and circular-FFT at 1e-4),
and the `tie_points` chain on the 96x128 parity pair with JAX's RANSAC
index sets replayed."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from libstevi_tpu.sparse import corners as JCo
from libstevi_tpu.sparse import descriptors as JD
from libstevi_tpu.sparse import nms as JN
from libstevi_tpu.sparse import orientation as JO

from libstevi_tpu_torch.cli import tie_points as tp_cli
from libstevi_tpu_torch.io import read_image
from libstevi_tpu_torch.sparse import corners as TCo
from libstevi_tpu_torch.sparse import descriptors as TD
from libstevi_tpu_torch.sparse import nms as TN
from libstevi_tpu_torch.sparse import orientation as TO

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data" / "parity"


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(x)


def _texture(seed, shape=(40, 52), sigma=1.2):
    """A smooth random texture in [0, 1] with corners everywhere."""
    n = np.random.default_rng(seed).uniform(0, 1, shape)
    t = gaussian_filter(n, sigma, axes=(0, 1))
    return ((t - t.min()) / (t.max() - t.min())).astype(np.float32)


def _close(got, want, rel=1e-5):
    """Within rel of the map's range (det / trace cancels to ulps of the
    structure tensor's entries)."""
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * np.abs(want).max())


# -- corners ---------------------------------------------------------------

@pytest.mark.parametrize("low_pass", [0, 1, 3])
@pytest.mark.parametrize("channels", [False, True])
def test_harris_matches_jax(low_pass, channels):
    img = _texture(1, (40, 52, 3) if channels else (40, 52))
    want = _np(JCo.harris_corner_score(jnp.asarray(img), low_pass))
    got = TCo.harris_corner_score(_t(img), low_pass).numpy()
    _close(got, want)
    for g, w in zip(TCo.harris_m_mat(_t(img[..., 0] if channels else img),
                                     low_pass),
                    JCo.harris_m_mat(jnp.asarray(img[..., 0] if channels
                                                 else img), low_pass)):
        _close(g.numpy(), _np(w))


@pytest.mark.parametrize("window,low_pass", [(1, 0), (2, 0), (2, 1)])
def test_windowed_and_masked_harris_match_jax(window, low_pass):
    """Windowed and masked Harris; the mask's zeros score 0, and a flat
    patch (trace 0: 0 / 0) scores 0 in both."""
    img = _texture(2)
    img[:12, :12] = 0.5
    mask = np.random.default_rng(3).random(img.shape) > 0.3
    want = _np(JCo.windowed_harris_corner_score(jnp.asarray(img), window,
                                                low_pass))
    got = TCo.windowed_harris_corner_score(_t(img), window, low_pass).numpy()
    _close(got, want)
    want = _np(JCo.masked_harris_corner_score(jnp.asarray(img),
                                              jnp.asarray(mask), window,
                                              low_pass))
    got = TCo.masked_harris_corner_score(_t(img), _t(mask), window,
                                         low_pass).numpy()
    _close(got, want)
    assert (got[~mask] == 0).all() and np.isfinite(got).all()


@pytest.mark.parametrize("threshold,n", [(0.02, 12), (0.05, 12), (0.05, 9),
                                         (0.1, 9)])
def test_fast_matches_jax(threshold, n):
    """The corner map exactly, the 3-px border ring False."""
    img = _texture(4, sigma=0.8)
    want = _np(JCo.fast_corner_detection(jnp.asarray(img), threshold, n))
    got = TCo.fast_corner_detection(_t(img), threshold, n).numpy()
    assert got.dtype == bool and want.any()
    np.testing.assert_array_equal(got, want)


# -- non-local-maximum selection -------------------------------------------

@pytest.mark.parametrize("radius,n_points,threshold", [
    (4.0, 24, 0.0), (1.5, 64, -np.inf), (6.3, 500, 0.0), (2.0, 0, 0.0),
    (0.5, 40, 1e-3)])
def test_nms_matches_jax(radius, n_points, threshold):
    """On JAX's own Harris score: coordinates, values and the valid flags
    exactly, unfilled slots included (500 asks for more points than the
    map has); a FAST map (bool scores, many ties) too."""
    img = _texture(5)
    score = _np(JCo.harris_corner_score(jnp.asarray(img), 1))
    fast = _np(JCo.fast_corner_detection(jnp.asarray(img), 0.05))
    for s in (score, fast):
        want = [_np(a) for a in JN.non_local_maximum_point_selection(
            jnp.asarray(s), radius, n_points, threshold)]
        got = [a.numpy() for a in TN.non_local_maximum_point_selection(
            _t(s), radius, n_points, threshold)]
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    if n_points == 500:
        assert not want[2].all()


# -- orientation and descriptors -------------------------------------------

def _keypoints(H, W, r):
    """(row, col) keypoints inside, on the border, within r of it, and
    (for the orientation) past it."""
    rng = np.random.default_rng(6)
    inner = np.stack([rng.integers(0, H, 30), rng.integers(0, W, 30)], 1)
    edge = np.array([[0, 0], [0, W - 1], [H - 1, 0], [H - 1, W - 1],
                     [r - 1, W // 2], [H - r, 3], [5, W - r + 1],
                     [H // 2, 1], [2, 2]])
    return np.concatenate([inner, edge]).astype(np.int32)


@pytest.mark.parametrize("radius", [3, 4])
@pytest.mark.parametrize("channels", [False, True])
def test_orientation_matches_jax(radius, channels):
    """Unit directions at 1e-5, windows placed as `lax.dynamic_slice`
    places them: keypoints on and near the border, and past it (a negative
    start counts from the end of the padded axis)."""
    img = _texture(7, (30, 41, 2) if channels else (30, 41))
    kp = _keypoints(30, 41, radius)
    kp = np.concatenate([kp, [[-3, 5], [40, 50], [12, -8]]]).astype(np.int32)
    want = _np(JO.intensity_oriented_coordinates(jnp.asarray(kp),
                                                 jnp.asarray(img), radius))
    got = TO.intensity_oriented_coordinates(_t(kp), _t(img), radius).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_sampling_patterns_equal_jax():
    np.testing.assert_array_equal(TD.random_sampling_pattern(100, 4, 7),
                                  JD.random_sampling_pattern(100, 4, 7))
    np.testing.assert_array_equal(TD.dense_sampling_pattern(3),
                                  JD.dense_sampling_pattern(3))
    np.testing.assert_array_equal(TD.radial_sampling_pattern(4, 16, 6.0),
                                  JD.radial_sampling_pattern(4, 16, 6.0))


def _desc_inputs(channels=False):
    img = _texture(8, (32, 44, 3) if channels else (32, 44))
    kp = _keypoints(32, 44, 4).astype(np.float32)
    kp[:10] += np.random.default_rng(9).uniform(-0.5, 0.5, (10, 2))
    dirs = _np(JO.intensity_oriented_coordinates(
        jnp.asarray(kp.astype(np.int32)), jnp.asarray(img), 3))
    return img, kp, dirs


@pytest.mark.parametrize("n_pairs", [256, 100])
@pytest.mark.parametrize("oriented", [False, True])
def test_brief_matches_jax(n_pairs, oriented):
    """Words equal (uint32 values in int64), 100 pairs pad the last word.
    Oriented pairs rotate by JAX's directions; cos / sin of the angle and
    the rotated offsets differ by ulps between the packages, so a bit is
    held where JAX's two samples differ by more than 1e-5 (samples agree
    to ~1e-6; a pair closer than that is a tie either way may break)."""
    img, kp, dirs = _desc_inputs()
    pairs = JD.random_sampling_pattern(n_pairs, 4, seed=7)
    jdirs = jnp.asarray(dirs) if oriented else None
    want = _np(JD.brief_descriptor(jnp.asarray(kp), jnp.asarray(img), pairs,
                                   jdirs)).astype(np.int64)
    got = TD.brief_descriptor(_t(kp), _t(img), pairs,
                              _t(dirs) if oriented else None)
    assert got.dtype == torch.int64 and got.shape == want.shape
    if not oriented:
        np.testing.assert_array_equal(got.numpy(), want)
        return
    rot = JD._rot(jdirs)
    s0, s1 = (_np(JD._sample(jnp.asarray(img), jnp.asarray(kp),
                             jnp.asarray(pairs[:, e]), rot)) for e in (0, 1))
    held = np.pad(np.abs(s0 - s1) > 1e-5, ((0, 0), (0, -n_pairs % 32)))
    mask = (held.reshape(len(kp), -1, 32).astype(np.int64)
            << np.arange(32)).sum(-1)
    assert (~held[:, :n_pairs]).mean() < 0.01
    np.testing.assert_array_equal(got.numpy() & mask, want & mask)


@pytest.mark.parametrize("kind", ["whitened", "oriented", "circular"])
@pytest.mark.parametrize("channels", [False, True])
def test_float_descriptors_match_jax(kind, channels):
    """Whitened, oriented whitened and circular-FFT descriptors at 1e-4
    (population standard deviations, as `jnp.std`), at keypoints on and
    near the border (clamped bilinear samples)."""
    img, kp, dirs = _desc_inputs(channels)
    ja, ta = (jnp.asarray(kp), jnp.asarray(img)), (_t(kp), _t(img))
    if kind == "whitened":
        want = JD.whitened_pixels_descriptor(*ja, radius=3)
        got = TD.whitened_pixels_descriptor(*ta, radius=3)
    elif kind == "oriented":
        want = JD.oriented_whitened_pixels_descriptor(*ja, jnp.asarray(dirs),
                                                      radius=4)
        got = TD.oriented_whitened_pixels_descriptor(*ta, _t(dirs), radius=4)
    else:
        want = JD.circular_fft_descriptor(*ja)
        got = TD.circular_fft_descriptor(*ta)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


# -- the chain -------------------------------------------------------------

def _jax_tool(argv, tmp_path, capsys):
    """The JAX tool's report with its matches (written through -o)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_tie_points", REPO / "cli" / "tie_points.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "j.json"
    assert mod.main(argv + ["-o", str(out)]) == 0
    capsys.readouterr()
    return json.loads(out.read_text())


def _pair():
    return [torch.from_numpy(np.asarray(read_image(str(DATA / f"{s}.stevimg"),
                                                   np.float32)))
            for s in ("left_small", "right_small")]


@pytest.mark.parametrize("descriptor", ["whitened", "brief"])
def test_tie_points_chain_matches_jax(descriptor, tmp_path, capsys):
    """`tie_points` on the parity pair (`tests/test_cli.py`'s -n 96
    --f 120) with JAX's RANSAC index sets (`jax.random.split` of
    PRNGKey(3), `choice` of 8) replayed: the counts and every match pair
    equal, the inlier count equal, rotation and translation within 1e-4."""
    argv = [str(DATA / "left_small.stevimg"),
            str(DATA / "right_small.stevimg"),
            "-n", "96", "--f", "120", "--descriptor", descriptor]
    want = _jax_tool(argv, tmp_path, capsys)
    n = want["n_matches"]
    sets = np.stack([np.asarray(jax.random.choice(k, n, (8,), replace=False))
                     for k in jax.random.split(jax.random.PRNGKey(3), 256)])
    got, pl, pr = tp_cli.tie_points(*_pair(), 96, "harris", descriptor, 4,
                                    120.0, draw=lambda: sets)
    for k in ("n_left", "n_right", "n_matches", "n_inliers"):
        assert got[k] == want[k], k
    np.testing.assert_array_equal(np.concatenate([pl, pr], -1),
                                  np.asarray(want["matches"], np.float32))
    assert abs(got["inlier_ratio"] - want["inlier_ratio"]) < 1e-9
    np.testing.assert_allclose(got["rotation"], want["rotation"], atol=1e-4)
    np.testing.assert_allclose(got["translation"], want["translation"],
                               atol=1e-4)


def test_tie_points_chain_takes_an_empty_keypoint_set(tmp_path, capsys):
    """FAST finds no left corner on the pair: the JAX tool's counts, no
    pose, and no error."""
    argv = [str(DATA / "left_small.stevimg"),
            str(DATA / "right_small.stevimg"),
            "-n", "96", "--f", "120", "--detector", "fast"]
    want = _jax_tool(argv, tmp_path, capsys)
    got, pl, pr = tp_cli.tie_points(*_pair(), 96, "fast", "whitened", 4,
                                    120.0)
    assert want["n_left"] == 0 and want["n_right"] > 0
    assert got == {k: want[k] for k in ("n_left", "n_right", "n_matches")}
    assert pl.shape == pr.shape == (0, 2)
