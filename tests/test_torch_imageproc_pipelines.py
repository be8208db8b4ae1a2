"""The port's image-processing pipelines against the JAX package's on the
CPU, on the same numpy-seeded inputs: Fourier transforms (rtol 1e-5),
inpainting (the nearest fill exactly, diffusion within 1e-5), mean shift
(modes within 1e-4, labels exactly) and intrinsic decomposition (the
texture chains' pairs exactly and coefficients within rtol 1e-6, the
non-local retinex's shading within rtol 1e-3 with R * S = the image within
1e-4, the FFT retinex at the L0 tolerance of `test_torch_optim.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.imageproc import fourier as JFo
from libstevi_tpu.imageproc import inpainting as JIn
from libstevi_tpu.imageproc import intrinsic_decomposition as JID
from libstevi_tpu.imageproc import meanshift as JMs

from libstevi_tpu_torch.imageproc import fourier as TFo
from libstevi_tpu_torch.imageproc import inpainting as TIn
from libstevi_tpu_torch.imageproc import intrinsic_decomposition as TID
from libstevi_tpu_torch.imageproc import meanshift as TMs

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return np.asarray(x)


# -- Fourier -------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(16, 16), (15, 22)])
def test_fourier_matches_jax(shape):
    """Forward / backward, the real pair (odd widths back through
    ``shape``), amplitude and phase: rtol 1e-5 (atol 1e-5 of the largest
    magnitude, for the entries near 0)."""
    img = np.random.default_rng(3).uniform(0, 1, shape).astype(np.float32)
    jf, tf = JFo.FourierTransformCalculator(), TFo.FourierTransformCalculator()
    jF, tF = jf.forward(jnp.asarray(img)), tf.forward(_t(img))
    assert tF.dtype == torch.complex64
    scale = float(np.abs(_np(jF)).max())
    tol = dict(rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(tF.numpy(), _np(jF), **tol)
    np.testing.assert_allclose(tf.backward(tF).numpy(),
                               _np(jf.backward(jF)), rtol=1e-5, atol=1e-6)
    jR, tR = jf.forward_real(jnp.asarray(img)), tf.forward_real(_t(img))
    np.testing.assert_allclose(tR.numpy(), _np(jR), **tol)
    np.testing.assert_allclose(tf.backward_real(tR, shape).numpy(),
                               _np(jf.backward_real(jR, shape)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tf.amplitude(tF).numpy(),
                               _np(jf.amplitude(jF)), **tol)
    big = np.abs(_np(jF)) > 1e-3 * scale       # phases of the non-tiny
    np.testing.assert_allclose(tf.phase(tF).numpy()[big],
                               _np(jf.phase(jF))[big], rtol=1e-5, atol=1e-5)


# -- inpainting ----------------------------------------------------------------

def _holes(seed, shape, p=0.35):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 1, shape).astype(np.float32)
    mask = rng.uniform(0, 1, shape[:2]) < p
    mask[5:12, 4:15] = True                 # a block: many equidistant ties
    return img, mask


@pytest.mark.parametrize("case", ["gray", "rgb", "capped"])
def test_nearest_inpainting_matches_jax(case):
    """Random holes plus a 7x11 block (ties between equidistant
    neighbours go by the neighbour order): equal to the JAX fill, in gray,
    RGB and with ``max_iters`` cutting the sweeps."""
    img, mask = _holes(4, (20, 24, 3) if case == "rgb" else (20, 24))
    cap = 2 if case == "capped" else None
    want = _np(JIn.nearest_neighbor_inpainting(jnp.asarray(img),
                                               jnp.asarray(mask), cap))
    got = TIn.nearest_neighbor_inpainting(_t(img), _t(mask), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    if case != "capped":
        assert (got.numpy() != 0).all()


@pytest.mark.parametrize("case", ["gray", "rgb"])
def test_diffusion_inpainting_matches_jax(case):
    img, mask = _holes(5, (16, 20, 3) if case == "rgb" else (16, 20))
    want = _np(JIn.diffusion_inpainting(jnp.asarray(img), jnp.asarray(mask),
                                        iters=120))
    got = TIn.diffusion_inpainting(_t(img), _t(mask), iters=120)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


# -- mean shift ----------------------------------------------------------------

@pytest.mark.parametrize("case", ["two_2d", "three_rgb"])
def test_mean_shift_matches_jax(case):
    """`TestMeanShift`'s two 2-D clusters, and three RGB clusters of
    different sizes (a 0.1 bandwidth): modes within 1e-4, labels equal."""
    rng = np.random.default_rng(6)
    if case == "two_2d":
        x = np.concatenate([rng.normal(0.0, 0.05, (30, 2)),
                            rng.normal(3.0, 0.05, (30, 2))])
        bw = 0.5
    else:
        centers = np.array([[0.2, 0.3, 0.8], [0.7, 0.6, 0.1],
                            [0.5, 0.9, 0.5]])
        x = np.concatenate([rng.normal(c, 0.02, (n, 3))
                            for c, n in zip(centers, (40, 25, 60))])
        bw = 0.1
    x = x.astype(np.float32)
    jm, jl = JMs.mean_shift_clustering(jnp.asarray(x), bw)
    tm, tl = TMs.mean_shift_clustering(_t(x), bw)
    np.testing.assert_allclose(tm.numpy(), _np(jm), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tl.numpy(), _np(jl))
    assert len(set(tl.tolist())) == (2 if case == "two_2d" else 3)


# -- intrinsic decomposition ---------------------------------------------------

def _ramp_image(seed, H=32, W=32, blocks=4):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.2, 1.0, (blocks, blocks, 3))
    refl = np.kron(base, np.ones((H // blocks, W // blocks, 1)))[:H, :W]
    shading = np.linspace(0.3, 1.0, W, dtype=np.float32)[None, :, None]
    return (refl * shading).astype(np.float32), shading


def _chains_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


@pytest.mark.parametrize("rot", [0, 1, 2, 3])
def test_texture_chains_match_jax(rot):
    """`test_texture_chains_rotation_invariant`'s scene (a patch and its
    90k-degree rotated copy): pairs equal, coefficients and b values
    within rtol 1e-6."""
    img = np.full((20, 20, 3), 0.5, np.float32)
    patch = np.random.default_rng(5).uniform(0.2, 0.9,
                                             (5, 5, 3)).astype(np.float32)
    img[3:8, 3:8] = patch
    img[12:17, 12:17] = np.rot90(patch, k=rot) if rot else patch
    log = np.log(np.maximum(img, 1e-8))
    want = JID._texture_chains(JID._rg_chromaticity(log), log, 0.002)
    got = TID._texture_chains(TID._rg_chromaticity(log), log, 0.002)
    assert len(got[0]) > 0
    _chains_equal(got, want)


def test_nonlocal_retinex_matches_jax():
    """`TestIntrinsic`'s 32x32 ramp under 4x4 reflectance blocks: the
    chains equal, the shading within rtol 1e-3 of JAX's after the 600 CG
    steps, R * S = the image within 1e-4, the JAX test's bars."""
    img, shading = _ramp_image(42)
    log = np.log(np.maximum(img, 1e-8))
    chains = TID._texture_chains(TID._rg_chromaticity(log), log, 0.01)
    _chains_equal(chains, JID._texture_chains(JID._rg_chromaticity(log),
                                              log, 0.01))
    want = JID.retinex_with_nonlocal_texture_constraint(jnp.asarray(img),
                                                        2e-3)
    got = TID.retinex_with_nonlocal_texture_constraint(_t(img), 2e-3,
                                                       _chains=chains)
    S, R = got.shading.numpy(), got.reflectance.numpy()
    np.testing.assert_allclose(S, _np(want.shading), rtol=1e-3)
    np.testing.assert_allclose(R, _np(want.reflectance), rtol=1e-3)
    np.testing.assert_allclose(R * S, img, atol=1e-4)
    prof = S[:, :, 0].mean(0)
    assert np.corrcoef(prof, shading[0, :, 0])[0, 1] > 0.95


def test_auto_retinex_matches_jax():
    """`test_auto_retinex_sweeps_thresholds`'s 24x24 image (12 thresholds,
    the minimum-entropy shading): within rtol 1e-3 of JAX's pick, which
    `perform_intrinsic_image_decomposition` makes for RGB."""
    rng = np.random.default_rng(42)
    refl = np.kron(rng.uniform(0.3, 1.0, (3, 3, 3)),
                   np.ones((8, 8, 1)))[:24, :24]
    sh = np.linspace(0.4, 1.0, 24, dtype=np.float32)[:, None, None]
    img = (refl * sh * 255).astype(np.float32)
    want = JID.auto_retinex_with_nonlocal_texture_constraint(jnp.asarray(img))
    got = TID.perform_intrinsic_image_decomposition(_t(img))
    np.testing.assert_allclose(got.shading.numpy(), _np(want.shading),
                               rtol=1e-3)
    np.testing.assert_allclose(got.reflectance.numpy() * got.shading.numpy(),
                               img, rtol=1e-4)


@pytest.mark.parametrize("case", ["gray", "rgb", "odd"])
def test_retinex_fft_matches_jax(case):
    """The FFT retinex (mirrored Poisson solve, L0 on the gray
    reflectance) at the L0 tolerance of `test_torch_optim.py` (within 1e-3
    on >= 0.99 of the values); the `retinex_with_non_local_texture_
    constraint` alias and the gray dispatch of
    `perform_intrinsic_image_decomposition` take this path."""
    img, _ = _ramp_image(7)
    if case == "gray":
        img = img.mean(-1)
    elif case == "odd":
        img = img[:27, :30].mean(-1)
    want = JID.retinex_fft(jnp.asarray(img))
    got = (TID.retinex_with_non_local_texture_constraint(_t(img))
           if case == "gray" else TID.perform_intrinsic_image_decomposition(
               _t(img), gradient_threshold=0.15))
    for g, w in ((got.shading, want.shading),
                 (got.reflectance, want.reflectance)):
        assert g.shape == w.shape
        close = np.isclose(g.numpy(), _np(w), rtol=0, atol=1e-3)
        assert close.mean() >= 0.99, close.mean()
    s = got.shading.numpy()
    assert s[:, -4:].mean() > s[:, :4].mean() * 1.2


def test_jax_pipeline_tests_scene_through_the_port():
    """`TestIntrinsic.test_separates_shading_gradient`'s gray block image
    through the port's `perform_intrinsic_image_decomposition`: the JAX
    test's bar holds."""
    rng = np.random.default_rng(42)
    rng.random((32, 32))
    refl = np.kron(np.where(rng.random((8, 8)) > 0.5, 0.9, 0.3),
                   np.ones((4, 4))).astype(np.float32)
    shading = np.linspace(0.4, 1.0, 32, dtype=np.float32)[None, :].repeat(
        32, 0)
    dec = TID.perform_intrinsic_image_decomposition(_t(refl * shading))
    s = dec.shading.numpy()
    assert s[:, -4:].mean() > s[:, :4].mean() * 1.2
    assert np.isfinite(dec.reflectance.numpy()).all()
