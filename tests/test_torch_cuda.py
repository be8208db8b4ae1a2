"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``cuda``; they skip where no CUDA device is present.  On a
machine with a card, where JAX is absent (``tests/conftest.py`` imports
it): ``python -m pytest tests/test_torch_cuda.py --noconftest``."""

import numpy as np
import pytest
import torch

from libstevi_tpu_torch.core import MatchingFunction, Margins
from libstevi_tpu_torch.ops import (dense_sgm_stereo, sgm_cost_volume,
                                    InterpolationKernel)
from libstevi_tpu_torch.ops.box_cuda import box_cv, box_cv_plain
from libstevi_tpu_torch.ops.sgm import SgmDirection, directions_for
from libstevi_tpu_torch.ops.sgm_cuda import (sgm_pass, sgm_pass_plain,
                                             sgm_wta, sgm_wta_plain)
from libstevi_tpu_torch.core import SearchOffset1
from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                               fused_fv_cost_volume_plain)
from libstevi_tpu_torch.ops.patchmatch import (_patch_match_stereo_cv,
                                               cost_oriented_volume)
from libstevi_tpu_torch.ops.patchmatch_cuda import (probe, probe_plain,
                                                    sweep, sweep_plain)

pytestmark = pytest.mark.cuda

SHAPES = [(37, 101, 13), (64, 96, 40)]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(dev, H, W, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0, 1, (H, W))
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("func", ["CC", "NCC", "ZCC", "ZNCC"])
def test_k1_matches_plain(dev, func, shape, dtype):
    H, W, D = shape
    L, R = _pair(dev, H, W)
    f = MatchingFunction[func]
    got = box_cv(f, L, R, 3, 2, D, dtype, negate=True).float()
    want = box_cv_plain(f, L, R, 3, 2, D, torch.float32, negate=True)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:   # one bf16 ulp of the f32 value
        _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
        ulp = torch.ldexp(torch.ones_like(want), (e - 8).int())
        assert ((got - want).abs() <= ulp + 1e-4).all()


def _volume(dev, shape, dtype, seed=1):
    H, W, D = shape
    L, R = _pair(dev, H, W, seed)
    return box_cv(MatchingFunction.ZNCC, L, R, 3, 3, D, dtype, negate=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_matches_plain(dev, shape, dtype):
    cv = _volume(dev, shape, dtype)
    acc = torch.empty(cv.shape, device=dev)
    acc2 = torch.empty(cv.shape, device=dev)
    for k, d in enumerate(directions_for(8)):
        sgm_pass(cv, acc, d, 0.1, 0.5, 100.0, accumulate=k > 0)
        sgm_pass_plain(cv, acc2, d, 0.1, 0.5, 100.0, accumulate=k > 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(acc, acc2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_matches_plain(dev, shape, dtype):
    cv = _volume(dev, shape, dtype)
    acc = torch.zeros(cv.shape, device=dev)
    for d in directions_for(8):
        if d is not SgmDirection.RIGHT2LEFT:
            sgm_pass(cv, acc, d, 0.1, 0.5, 100.0)
    i1, b1, d1 = sgm_wta(cv, acc, 0.1, 0.5, 100.0, 1, 3, 3, True)
    i2, b2, d2 = sgm_wta_plain(cv, acc, 0.1, 0.5, 100.0, 1, 3, 3, True)
    torch.cuda.synchronize()
    same = i1 == i2
    assert same.float().mean().item() >= 0.999
    torch.testing.assert_close(b1[same], b2[same], rtol=1e-4, atol=1e-4)
    assert torch.equal(torch.isnan(d1[same]), torch.isnan(d2[same]))
    f = same & torch.isfinite(d2)
    torch.testing.assert_close(d1[f], d2[f], rtol=1e-4, atol=1e-4)


def test_dense_path_matches_cpu(dev):
    """The kernel path on the card against the plain path on the CPU."""
    L, R = _pair(dev, 48, 80, seed=2)
    kw = dict(refine_kernel=InterpolationKernel.PARABOLA)
    counts = (box_cv.launches, sgm_pass.launches, sgm_wta.launches)
    dg, ig, tg = dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 3, 3, 20,
                                  0.1, 0.5, **kw)
    assert (box_cv.launches, sgm_pass.launches, sgm_wta.launches) == \
        (counts[0] + 1, counts[1] + 7, counts[2] + 1)
    dc, ic, tc = dense_sgm_stereo(MatchingFunction.ZNCC, L.cpu(), R.cpu(),
                                  3, 3, 20, 0.1, 0.5, **kw)
    same = ig.cpu() == ic
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                               atol=1e-4, equal_nan=True)


def test_sgm_cost_volume_runs_the_kernel(dev):
    cv = _volume(dev, (30, 44, 11), torch.float32)
    before = sgm_pass.launches
    got = sgm_cost_volume(cv, 0.1, 0.5, n_directions=8)
    assert sgm_pass.launches == before + 8
    want = sgm_cost_volume(cv.cpu(), 0.1, 0.5, n_directions=8)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", ["16_directions", "p2_below_p1", "margins",
                                  "ssd"])
def test_unsupported_configurations_raise(dev, case):
    cv = torch.zeros(8, 9, 4, device=dev)
    L, R = _pair(dev, 8, 9)
    with pytest.raises(NotImplementedError):
        if case == "16_directions":
            sgm_cost_volume(cv, 0.1, 0.5, n_directions=16)
        elif case == "p2_below_p1":
            dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 1, 1, 4, 0.5, 0.1)
        elif case == "margins":
            sgm_cost_volume(cv, 0.1, 0.5, Margins(1, 1, 1, 1))
        else:
            dense_sgm_stereo(MatchingFunction.SSD, L, R, 1, 1, 4, 0.1, 0.5)


def _ulp_close(got, want):
    """Within one bf16 ulp of the f32 value, plus 1e-5."""
    _, e = torch.frexp(torch.maximum(got.abs(), want.abs()))
    ulp = torch.ldexp(torch.ones_like(want), (e - 8).int())
    assert ((got - want).abs() <= ulp + 1e-5).all()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifts", [list(range(13)), [-d for d in range(9)],
                                    list(range(-4, 17))],
                         ids=["r2l", "l2r", "offset"])
@pytest.mark.parametrize("F", [49, 147])
@pytest.mark.parametrize("kernel", ["dot", "ssd", "sad"])
def test_k5_matches_plain(dev, kernel, F, shifts, dtype):
    g = torch.Generator(device=dev).manual_seed(F)
    H, W = (37, 101) if F == 49 else (20, 45)
    src = torch.rand(H, W, F, generator=g, device=dev) - 0.5
    tgt = torch.rand(H, W, F, generator=g, device=dev) - 0.5
    before = fused_fv_cost_volume.launches
    got = fused_fv_cost_volume(kernel, src, tgt, shifts, dtype)
    assert fused_fv_cost_volume.launches == before + 1
    want = fused_fv_cost_volume_plain(kernel, src, tgt, shifts)
    torch.cuda.synchronize()
    assert got.shape == (H, W, len(shifts)) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _ulp_close(got.float(), want)


def test_k5_refuses_what_it_does_not_take(dev):
    fv = torch.zeros(4, 5, 3, device=dev)
    with pytest.raises(NotImplementedError):
        fused_fv_cost_volume("medad", fv, fv, [0, 1])
    big = torch.zeros(2, 40, 400, device=dev)
    with pytest.raises(NotImplementedError):
        fused_fv_cost_volume("dot", big, big, list(range(200)))


def _pm_state(dev, shape, seed):
    H, W, D = shape
    L, R = _pair(dev, H, W, seed)
    cv = box_cv(MatchingFunction.NCC, L, R, 2, 2, D)
    costc = cost_oriented_volume(MatchingFunction.NCC, cv, 0)
    g = torch.Generator(device=dev).manual_seed(seed)
    disp = torch.randint(-2, D + 2, (H, W), generator=g, device=dev,
                         dtype=torch.int32)
    cost = probe_plain(costc, disp, disp, torch.full((H, W), float("inf"),
                                                     device=dev), 0)[1]
    return costc, disp, cost, g


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_k6_equals_plain(dev, axis, reverse, shape):
    costc, disp, cost, _ = _pm_state(dev, shape, 3)
    before = sweep.launches
    got = sweep(costc, disp, cost, 0, axis, reverse)
    assert sweep.launches == before + 1
    want = sweep_plain(costc, disp, cost, 0, axis, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("K", [1, 4])
def test_k7_equals_plain(dev, K, shape):
    costc, disp, cost, g = _pm_state(dev, shape, 4)
    D = shape[2]
    cand = torch.randint(-3, D + 3, (K,) + shape[:2], generator=g,
                         device=dev, dtype=torch.int32)
    cand[0, :3] = disp[:3]                       # ties with the current cost
    before = probe.launches
    got = probe(costc, cand, disp, cost, 0)
    assert probe.launches == before + 1
    want = probe_plain(costc, cand, disp, cost, 0)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_cv_patchmatch_matches_cpu_with_one_draw_stream(dev):
    """The CV route on the card against the plain route on the CPU, one
    volume and one replayed candidate stream: equal disparities."""
    L, R = _pair(dev, 40, 64, seed=5)
    cv = box_cv(MatchingFunction.NCC, L, R, 3, 3, 24)

    def drawer():
        rng = np.random.default_rng(9)
        return lambda shape, lo, hi: torch.from_numpy(
            rng.integers(lo, hi, shape).astype(np.int32))

    def run(vol, device):
        draw = drawer()
        return _patch_match_stereo_cv(
            MatchingFunction.NCC, None, None, SearchOffset1(0, 23), 5, 4,
            cv=vol, draw=lambda *a: draw(*a).to(device))

    counts = (sweep.launches, probe.launches)
    got = run(cv, dev)
    assert (sweep.launches, probe.launches) == (counts[0] + 10,
                                                counts[1] + 6)
    want = run(cv.cpu(), "cpu")
    assert torch.equal(got.cpu(), want)
