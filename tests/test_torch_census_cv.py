"""The census cost volume (`ops/census_cuda`, `csrc/census_cv.cu`): its
plain version against the unfold route of `unfold_based_cost_volume`, the
census path of `dense_sgm_stereo` against the general route, and, marked
``cuda`` (they skip where no CUDA device is present), the kernels bitwise
against their plain versions.  On a machine with a card, where JAX is
absent (``tests/conftest.py`` imports it):
``python -m pytest tests/test_torch_census_cv.py --noconftest``."""

import pytest
import torch
import torch.nn.functional as F

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.ops import (census_transform_2d, dense_sgm_stereo,
                                    sgm_wta_truncated,
                                    unfold_based_cost_volume)
from libstevi_tpu_torch.ops import census_cuda, cost_volume
from libstevi_tpu_torch.ops.census_cuda import (census_cv, census_cv_plain,
                                                census_words,
                                                census_words_plain, n_words)
from libstevi_tpu_torch.ops.matching import popcount32
from libstevi_tpu_torch.ops.sgm import dense_sgm_buffers
from libstevi_tpu_torch.utils.profiling import counters, reset_counters

CENSUS = MatchingFunction.CENSUS

# (h, v): 5x5 (24 bits, one word), 7x7 (48 bits, two), 9x7 (62 bits, two
# words, the second nearly full)
WINDOWS = [(2, 2), (3, 3), (4, 3)]


def _pair(H, W, seed=0, device="cpu"):
    """A random pair with a flat patch in both images (equal samples: no
    bit set) and exact zeros (equal to the padding)."""
    g = torch.Generator().manual_seed(seed)
    L, R = torch.rand((H, W), generator=g), torch.rand((H, W), generator=g)
    L[1:5, 2:9] = 0.5
    R[2:6, 1:7] = 0.5
    L[-2:, :3] = 0.0
    return L.to(device), R.to(device)


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()


@pytest.mark.parametrize("h,v", WINDOWS)
@pytest.mark.parametrize("H,W,D", [(13, 17, 9), (15, 21, 21), (9, 11, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_volume_equals_the_unfold_route(h, v, H, W, D, dtype):
    """Odd shapes, D up to and past W (every target word out of range).
    The volume is also the kernels' two stages written out: the words,
    then popcount(src ^ tgt_d) summed over them, tgt 0 past W."""
    L, R = _pair(H, W, seed=H + W + D)
    got = census_cv(L, R, h, v, D, dtype)
    want = unfold_based_cost_volume(CENSUS, L, R, h, v, D, cv_dtype=dtype,
                                    backend="unfold")
    assert got.dtype == dtype and got.shape == (H, W, D)
    assert torch.equal(got, want)
    src, tgt = census_words(L, R, h, v)
    tgt = F.pad(tgt, (0, D))
    hamming = torch.stack([popcount32(src ^ tgt[..., d:d + W]).sum(0)
                           for d in range(D)], dim=-1)
    assert torch.equal(got, hamming.float().to(dtype))
    assert float(got.max()) <= 32 * n_words(h, v)


@pytest.mark.parametrize("h,v", WINDOWS)
def test_plain_words_are_the_census_transform(h, v):
    L, R = _pair(11, 19, seed=3)
    words = census_words(L, R, h, v)
    assert words.shape == (2, n_words(h, v), 11, 19)
    for k, img in enumerate((R, L)):        # [0] source (right), [1] target
        assert torch.equal(words[k], census_transform_2d(img, h, v)
                           .permute(2, 0, 1))


def test_words_count_and_refusals():
    assert [n_words(h, v) for h, v in WINDOWS] == [1, 2, 2]
    assert n_words(0, 1) == 1 and n_words(7, 7) == 7
    with pytest.raises(ValueError):
        n_words(0, 0)
    L, R = _pair(6, 8)
    with pytest.raises(ValueError):
        census_cv(L, R, 1, 1, 4, out=torch.empty(6, 8, 5))


def test_out_receives_the_volume():
    L, R = _pair(7, 13, seed=1)
    out = torch.full((7, 13, 6), -1.0)
    got = census_cv(L, R, 1, 2, 6, out=out)
    assert got is out and torch.equal(out, census_cv_plain(L, R, 1, 2, 6))


def _general_route(L, R, cfg, D):
    """The general route of `dense_sgm_stereo`: the unfold route's volume,
    then `sgm_wta_truncated`."""
    cv = unfold_based_cost_volume(CENSUS, L, R, cfg["h_radius"],
                                  cfg["v_radius"], D, backend="unfold")
    return sgm_wta_truncated(cv, cfg["P1"], cfg["P2"],
                             n_directions=cfg["n_directions"],
                             h_radius=cfg["h_radius"],
                             v_radius=cfg["v_radius"],
                             cost_vol_radius=cfg["cost_vol_radius"])


@pytest.mark.parametrize("H,W,D,route", [
    (23, 41, 24, "scan"),       # K2 / K3's plain versions
    (7, 345, 336, "lane"),      # past D = 320: K4b's plain version
])
def test_census_path_equals_the_general_route(H, W, D, route):
    """Integer costs and penalties: both routes' sums are exact, so the
    WTA index and the truncated volume agree bit for bit."""
    L, R = _pair(H, W, seed=D)
    cfg = dict(entry.KITTI_CENSUS, disp_width=D)
    _, idx, tcv = dense_sgm_stereo(CENSUS, L, R, **cfg)
    assert counters()["route." + route] == 1
    idx_g, tcv_g = _general_route(L, R, cfg, D)
    assert torch.equal(idx, idx_g)
    assert torch.equal(tcv.nan_to_num(-1.0), tcv_g.nan_to_num(-1.0))


def test_census_path_never_runs_the_shifted_compare_loop(monkeypatch):
    """On the CPU the loop runs only as the census kernel's plain version
    (`census_cv_plain`); on the card the kernel takes its place
    (`test_card_path_equals_the_cpu_path`)."""
    inside_plain = []
    loop = cost_volume._shifted_compare_scan

    def refuse(*args, **kwargs):
        if not inside_plain:
            raise AssertionError("the shifted-compare loop ran")
        return loop(*args, **kwargs)

    def plain(*args, **kwargs):
        inside_plain.append(True)
        try:
            return census_cv_plain(*args, **kwargs)
        finally:
            inside_plain.pop()
    monkeypatch.setattr(cost_volume, "_shifted_compare_scan", refuse)
    monkeypatch.setattr(census_cuda, "census_cv_plain", plain)
    L, R = _pair(12, 40, seed=4)
    disp, _, _ = dense_sgm_stereo(CENSUS, L, R,
                                  **dict(entry.KITTI_CENSUS, disp_width=16))
    assert disp.shape == (12, 40)
    # the dense route (P2 < P1) keeps the general route, the loop on the CPU
    with pytest.raises(AssertionError, match="shifted-compare"):
        dense_sgm_stereo(CENSUS, L, R, **dict(entry.KITTI_CENSUS,
                                              disp_width=16, P1=4.0, P2=1.0))


def test_census_path_takes_the_preallocated_buffers():
    L, R = _pair(12, 40, seed=5)
    cfg = dict(entry.KITTI_CENSUS, disp_width=16)
    buffers = dense_sgm_buffers(L, 16, 8, torch.float32)
    got = dense_sgm_stereo(CENSUS, L, R, **cfg, **buffers)
    want = dense_sgm_stereo(CENSUS, L, R, **cfg)
    for a, b in zip(got, want):
        assert torch.equal(a.nan_to_num(-1.0), b.nan_to_num(-1.0))
    with pytest.raises(ValueError):     # the general route refuses them
        dense_sgm_stereo(CENSUS, L[..., None], R[..., None], **cfg,
                         **buffers)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _values(words):
    """The uint32 values of words held as int32 bits (the kernel's) or as
    int64 values (the plain version's)."""
    return words.long() & 0xFFFFFFFF


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D,h,v", [
    (375, 1242, 192, 3, 3),     # KITTI 2015
    (13, 17, 9, 2, 2), (15, 21, 21, 3, 3), (37, 101, 300, 4, 3),
    (9, 11, 16, 1, 0), (20, 70, 600, 7, 7),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_equal_their_plain_versions(dev, H, W, D, h, v, dtype):
    L, R = _pair(H, W, seed=H * W)
    words = census_words(L.to(dev), R.to(dev), h, v)
    assert words.dtype == torch.int32
    assert torch.equal(_values(words.cpu()),
                       census_words_plain(L, R, h, v))
    got = census_cv(L.to(dev), R.to(dev), h, v, D, dtype)
    torch.cuda.synchronize()
    c = counters()
    assert c["launches.census_words"] == 2 and c["launches.census_cv"] == 1
    assert torch.equal(got.cpu(), census_cv_plain(L, R, h, v, D, dtype))


@pytest.mark.cuda
def test_unfold_route_takes_the_kernel_on_the_card(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the shifted-compare loop ran")
    monkeypatch.setattr(cost_volume, "_shifted_compare_scan", refuse)
    L, R = _pair(31, 77, seed=9)
    got = unfold_based_cost_volume(CENSUS, L.to(dev), R.to(dev), 3, 3, 40)
    assert counters()["launches.census_cv"] == 1
    monkeypatch.undo()      # the plain version is the loop on the CPU
    assert torch.equal(got.cpu(), census_cv_plain(L, R, 3, 3, 40))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,D", [(40, 96, 24), (12, 345, 336)])
def test_card_path_equals_the_cpu_path(dev, monkeypatch, H, W, D):
    """The census kernel, then K2x7 / K3x7 (scan) or K4b (lane): integer
    sums, so the card's index and band equal the CPU's bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("the shifted-compare loop ran")
    monkeypatch.setattr(cost_volume, "_shifted_compare_scan", refuse)
    L, R = _pair(H, W, seed=D)
    cfg = dict(entry.KITTI_CENSUS, disp_width=D)
    dg, ig, tg = dense_sgm_stereo(CENSUS, L.to(dev), R.to(dev), **cfg)
    c = counters()
    assert c["launches.census_words"] == 1 and c["launches.census_cv"] == 1
    assert not c["launches.box_cv"]
    monkeypatch.undo()      # the plain census volume is the loop on the CPU
    dc, ic, tc = dense_sgm_stereo(CENSUS, L, R, **cfg)
    assert torch.equal(ig.cpu(), ic)
    assert torch.equal(tg.cpu().nan_to_num(-1.0), tc.nan_to_num(-1.0))
    torch.testing.assert_close(dg.cpu(), dc, rtol=0, atol=1e-5,
                               equal_nan=True)
