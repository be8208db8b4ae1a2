"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``cuda``; they skip where no CUDA device is present.  On a
machine with a card, where JAX is absent (``tests/conftest.py`` imports
it): ``python -m pytest tests/test_torch_cuda.py --noconftest``."""

import numpy as np
import pytest
import torch

from libstevi_tpu_torch.core import (ExtractionStrategy, MatchingFunction,
                                     Margins)
from libstevi_tpu_torch.ops import (dense_sgm_stereo, sgm_cost_volume,
                                    InterpolationKernel)
from libstevi_tpu_torch.ops.box_cuda import (box_cv, box_cv_plain,
                                             window_stats, _prep_inputs)
from libstevi_tpu_torch.ops import sgm_wta_truncated
from libstevi_tpu_torch.ops.sgm import (SgmDirection, directions_for,
                                        _KNIGHT_DIRS)
from libstevi_tpu_torch.ops.sgm import knight_adj
from libstevi_tpu_torch.ops.sgm_cuda import (_acc_sum, direction_volumes,
                                             add_knight_volumes,
                                             knight_volumes,
                                             knight_volumes_plain,
                                             sgm_accumulate, sgm_pass,
                                             sgm_pass_plain, sgm_wta,
                                             sgm_wta_plain, sgm_shard_pass,
                                             sgm_shard_pass_plain,
                                             sgm_knight_shard_pass,
                                             sgm_knight_shard_pass_plain)
from libstevi_tpu_torch.core import SearchOffset1
from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                               fused_fv_cost_volume_plain)
from libstevi_tpu_torch.ops.patchmatch import (_patch_match_stereo_cv,
                                               cost_oriented_volume)
from libstevi_tpu_torch.ops.patchmatch_cuda import (probe, probe_plain,
                                                    search_probe,
                                                    search_probe_plain,
                                                    sweep, sweep_plain)
from libstevi_tpu_torch.ops import sgm_lane_cuda as lane

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


def _flat_pair(dev, H, W, seed=0):
    """A random pair with a flat patch of 200/255 in both images, offset
    between them: windows wholly inside it cancel in ZNCC."""
    L, R = _pair(dev, H, W, seed)
    L[H // 8:H // 8 + H // 2 + 2, W // 8:W // 2] = 200 / 255
    R[H // 6:H // 6 + H // 2 + 2, W // 6:W // 2 + 9] = 200 / 255
    return L, R


@pytest.mark.parametrize("pair", ["random", "flat"])
@pytest.mark.parametrize("shape", SHAPES + [(12, 700, 640)])
@pytest.mark.parametrize("func", ["CC", "NCC", "ZCC", "ZNCC"])
def test_k1_matches_plain(dev, func, shape, pair):
    """K1's two kernels against their plain versions, bit for bit: the
    statistics kernel against `_prep_inputs`, the f32 volume against
    `box_cv_plain`, the bf16 volume against the plain f32 rounded once;
    one statistics launch and one volume launch a call, any D (640 too)."""
    H, W, D = shape
    L, R = (_flat_pair if pair == "flat" else _pair)(dev, H, W)
    f = MatchingFunction[func]
    before = (box_cv.launches, window_stats.launches)
    got = window_stats(f, L, R, 3, 2)
    for a, b in zip(got, _prep_inputs(f, L, R, 3, 2)):
        assert a == b if isinstance(a, float) else torch.equal(a, b)
    want = box_cv_plain(f, L, R, 3, 2, D, torch.float32, negate=True)
    assert torch.equal(box_cv(f, L, R, 3, 2, D, negate=True), want)
    assert torch.equal(box_cv(f, L, R, 3, 2, D, torch.bfloat16, negate=True),
                       want.to(torch.bfloat16))
    assert (box_cv.launches, window_stats.launches) == (before[0] + 2,
                                                        before[1] + 3)


@pytest.mark.parametrize("hv", [(0, 2), (1, 0), (5, 4), (6, 1)])
def test_k1_window_widths_match_plain(dev, hv):
    """K1 at window widths its ring is unrolled for (3, 11) and not (1,
    13), bitwise."""
    h, v = hv
    L, R = _flat_pair(dev, 40, 150, 2)
    for f in MatchingFunction.CC, MatchingFunction.ZNCC:
        assert torch.equal(box_cv(f, L, R, h, v, 37),
                           box_cv_plain(f, L, R, h, v, 37))


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


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(37, 101, 13), (23, 57, 331),
                                   (12, 40, 330), (9, 30, 300)])
def test_k2_any_d_and_unaligned_match_plain(dev, shape, dtype, offset):
    """K2 past D = 320 (the shared-memory instance) and on volumes whose
    pixels are not 16-byte aligned (odd D, or a view one element into its
    storage): the ring stages the aligned cover of each vector."""
    H, W, D = shape
    g = torch.Generator(device=dev).manual_seed(D)
    flat = (torch.rand(H * W * D + 1, generator=g, device=dev) * 2 - 1).to(
        dtype)
    cv = flat[offset:offset + H * W * D].view(H, W, D)
    acc = torch.empty(cv.shape, device=dev)
    acc2 = torch.empty(cv.shape, device=dev)
    before = sgm_pass.launches
    for k, d in enumerate(directions_for(8)):
        sgm_pass(cv, acc, d, 0.1, 0.5, 100.0, accumulate=k > 0)
        sgm_pass_plain(cv, acc2, d, 0.1, 0.5, 100.0, accumulate=k > 0)
    assert sgm_pass.launches == before + 8
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


def _path_counts():
    """The launch counts of K1, K2 (one direction a launch), K2 (up to 7
    directions in one launch), K2k and K3."""
    return (box_cv.launches, sgm_pass.launches, direction_volumes.launches,
            knight_volumes.launches, sgm_wta.launches)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(9, 30, 300)])
def test_k2_one_launch_matches_plain(dev, shape, dtype):
    """`direction_volumes`: the 7 directions of the WTA path in one K2
    launch, a volume each, against each direction's plain volume at 1e-4,
    summed in order equal to 7 launches into one accumulator bitwise; more
    than 7 directions in one launch raise."""
    cv = _volume(dev, shape, dtype)
    dirs = [d for d in directions_for(8) if d is not SgmDirection.RIGHT2LEFT]
    before = (sgm_pass.launches, direction_volumes.launches)
    stack = direction_volumes(cv, dirs, 0.1, 0.5, 100.0)
    assert (sgm_pass.launches, direction_volumes.launches) == \
        (before[0], before[1] + 1)
    for d, a in zip(dirs, stack):
        want = sgm_pass_plain(cv, torch.empty_like(a), d, 0.1, 0.5, 100.0,
                              accumulate=False)
        torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-4)
    seq = sgm_accumulate(cv, dirs, 0.1, 0.5, 100.0)
    assert torch.equal(_acc_sum(stack), seq)
    with pytest.raises(RuntimeError):
        direction_volumes(cv, directions_for(8), 0.1, 0.5, 100.0)


def test_dense_path_matches_cpu(dev):
    """The kernel path on the card against the plain path on the CPU."""
    L, R = _pair(dev, 48, 80, seed=2)
    kw = dict(refine_kernel=InterpolationKernel.PARABOLA)
    counts = _path_counts()
    dg, ig, tg = dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 3, 3, 20,
                                  0.1, 0.5, **kw)
    # K1, the 7 K2 directions in one launch (the volumes fit), K3
    assert _path_counts() == (counts[0] + 1, counts[1], counts[2] + 1,
                              counts[3], counts[4] + 1)
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


def test_unsupported_configurations_raise(dev):
    """Distributed 16-direction SGM at D > 320 was the one SGM
    configuration the card refused; it runs now (K4c relayed, then the
    knights through K2s) and equals the single-device route (K4b and K2k's
    any-D instance) bit for bit and the CPU run at 1e-4.  What the card
    still refuses: K3 past D = 320 (`sgm_route` sends it to the lane
    route)."""
    from libstevi_tpu_torch.parallel.sgm_dist import distributed_sgm_routed
    L, R = _pair(dev, 8, 340)
    counts = (lane.fused_rows_pass.launches, knight_volumes.launches)
    disp, idx, _ = dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 1, 1, 330,
                                    0.1, 0.5, n_directions=16)
    # the 8 knight volumes fit: two K2k launches for all of them
    assert (lane.fused_rows_pass.launches, knight_volumes.launches) == \
        (counts[0] + 2, counts[1] + 2)
    assert idx.shape == (8, 340)
    cv = torch.rand(8, 20, 330, device=dev)
    before = (lane.fused_rows_shard_pass.launches,
              sgm_knight_shard_pass.launches)
    got = torch.cat(distributed_sgm_routed(list(cv.split(4)), 0.1, 0.5,
                                           n_directions=16))
    assert lane.fused_rows_shard_pass.launches == before[0] + 4
    assert sgm_knight_shard_pass.launches == before[1] + 32
    assert torch.equal(got, sgm_cost_volume(cv, 0.1, 0.5, n_directions=16))
    want = torch.cat(distributed_sgm_routed(list(cv.cpu().split(4)), 0.1,
                                            0.5, n_directions=16))
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    with pytest.raises(NotImplementedError, match="D <= 320"):
        sgm_wta(cv, torch.zeros_like(cv), 0.1, 0.5, 100.0, 1, 1, 1, False)


@pytest.mark.parametrize("n_dirs", [4, 8, 16])
def test_distributed_sgm_past_d320_matches_cpu(dev, n_dirs):
    """`distributed_sgm` (4 directions) and `distributed_sgm_fused_dhw` at
    D = 330 on 3 virtual shards of the card (K2 and K2s, any D) against
    the same engines on the CPU at 1e-4, and against the single-device
    K2/K2k sum (`sgm_accumulate`) bit for bit."""
    from libstevi_tpu_torch.ops.sgm_cuda import sgm_accumulate
    from libstevi_tpu_torch.parallel.sgm_dist import (
        distributed_sgm, distributed_sgm_fused_dhw)
    g = torch.Generator(device=dev).manual_seed(33)
    cv = torch.rand((17, 23, 330), generator=g, device=dev) * 4
    sizes = [6, 4, 7]
    fns = [lambda s: distributed_sgm_fused_dhw(s, 0.3, 1.1, 7.0, n_dirs)]
    if n_dirs == 4:
        fns.append(lambda s: distributed_sgm(s, 0.3, 1.1, 7.0))
    ref = cv + sgm_accumulate(cv, directions_for(n_dirs), 0.3, 1.1, 7.0)
    for fn in fns:
        before = sgm_shard_pass.launches
        got = torch.cat(fn(_shards(cv, sizes)))
        assert sgm_shard_pass.launches > before
        assert torch.equal(got, ref)
        want = torch.cat(fn(_shards(cv.cpu(), sizes)))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_aggregate_cost_auto_past_k5_tile_matches_cpu(dev):
    """ZSAD at r = 5 (F = 121) over D = 448: K5's tile needs 249,600 bytes
    of shared memory, so 'auto' takes the shifted-compare loop (no K5
    launch) and equals the CPU; 'fused' still raises."""
    from libstevi_tpu_torch.ops import unfold_based_cost_volume
    from libstevi_tpu_torch.ops.cost_volume import aggregate_cost
    L, R = _pair(dev, 14, 470, seed=5)
    before = fused_fv_cost_volume.launches
    got = unfold_based_cost_volume(MatchingFunction.ZSAD, L, R, 5, 5, 448)
    assert fused_fv_cost_volume.launches == before
    want = unfold_based_cost_volume(MatchingFunction.ZSAD, L.cpu(), R.cpu(),
                                    5, 5, 448)
    assert got.is_cuda and got.shape == (14, 470, 448)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    fv = torch.zeros(4, 5, 121, device=dev)
    with pytest.raises(NotImplementedError):
        aggregate_cost(MatchingFunction.ZSAD, fv, fv, 448, backend="fused")


@pytest.mark.parametrize("n_dirs", [4, 8, 16])
def test_p2_below_p1_runs_plain_on_the_card(dev, n_dirs):
    """P2 < P1 runs the dense-penalty steps as torch ops on the card, with
    no kernel launch, and equals the CPU run."""
    L, R = _pair(dev, 24, 40, seed=7)
    counts = (sgm_pass.launches, knight_volumes.launches, sgm_wta.launches,
              lane.fused_rows_pass.launches)
    dg, ig, tg = dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 2, 2, 8, 0.5,
                                  0.1, n_directions=n_dirs)
    assert (sgm_pass.launches, knight_volumes.launches, sgm_wta.launches,
            lane.fused_rows_pass.launches) == counts
    assert ig.is_cuda
    dc, ic, tc = dense_sgm_stereo(MatchingFunction.ZNCC, L.cpu(), R.cpu(), 2,
                                  2, 8, 0.5, 0.1, n_directions=n_dirs)
    same = ig.cpu() == ic
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                               atol=1e-4, equal_nan=True)


# (6, 1400, 360): 11 columns a K4b block, 96 KiB of shared memory (past the
# 48 KiB a block gets without opting in)
LANE_SHAPES = [(37, 101, 333), (18, 7, 5), (5, 21, 40), (30, 300, 352),
               (6, 1400, 360)]


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("neg", [False, True])
def test_k4a_equals_plain(dev, shape, neg):
    x = torch.rand(shape, device=dev)
    before = lane.shift_rows.launches
    S = lane.shear(x, neg)
    assert lane.shift_rows.launches == before + 1
    H = shape[0]
    pad = torch.nn.functional.pad(x, (0, 0, H - 1, H), value=float("inf"))
    args = (shape[1] + H - 1, H - 1, -1) if neg else (shape[1] + H - 1, 0, 1)
    assert torch.equal(S, lane.shift_rows_plain(pad, *args))
    assert torch.equal(lane.unshear(S, shape[1], neg), x)


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4b_rows_equal_plain(dev, shape, diag, reverse):
    """K4b's row sweep, fresh and accumulating, with a column offset and
    image width for Pout: equal to the plain version to the bit."""
    cv = torch.rand(shape, device=dev) * 3
    acc = torch.rand(shape, device=dev)
    kw = dict(col0=3, W_pout=shape[1] + 5, P1=0.3, P2=1.1, Pout=7.0)
    got = lane.fused_rows_pass(cv, None, reverse, diag, **kw)
    want = lane.fused_rows_pass_plain(cv, None, reverse, diag, **kw)
    assert torch.equal(got, want)
    want = lane.fused_rows_pass_plain(cv, acc.clone(), reverse, diag, **kw)
    assert torch.equal(lane.fused_rows_pass(cv, acc, reverse, diag, **kw),
                       want)


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("reverse", [False, True])
def test_k4b_cols_equal_plain(dev, shape, reverse):
    cv = torch.rand(shape, device=dev) * 3
    acc = torch.rand(shape, device=dev)
    kw = dict(col0=0, W_pout=shape[1], P1=0.3, P2=1.1, Pout=7.0)
    want = lane.fused_cols_pass_plain(cv, acc.clone(), reverse, **kw)
    assert torch.equal(lane.fused_cols_pass(cv, acc, reverse, **kw), want)
    i1, b1 = lane.fused_cols_wta(cv, acc, 1, **kw)
    i2, b2 = lane.fused_cols_wta_plain(cv, acc, 1, **kw)
    assert torch.equal(i1, i2) and torch.equal(b1, b2)


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("n_dirs", [4, 8])
def test_fused_and_chunked_adj_match_grouped(dev, shape, n_dirs):
    """`fused_adj` (also in separate mode) and `chunked_adj` with small
    chunks against the plain grouped directions, within 1e-4."""
    from libstevi_tpu_torch.ops.sgm import _grouped_adj
    cv = torch.rand(shape, device=dev) * 3
    want = _grouped_adj(cv, 0.3, 1.1, 7.0, n_dirs, 2, shape[1] + 4)
    before = (lane.fused_rows_pass.launches, lane.chunked_sweep.launches)
    for got in (lane.fused_adj(cv, 2, shape[1] + 4, 0.3, 1.1, 7.0, n_dirs),
                lane.fused_adj(cv, 2, shape[1] + 4, 0.3, 1.1, 7.0, n_dirs,
                               separate=True),
                lane.chunked_adj(cv, 2, shape[1] + 4, 0.3, 1.1, 7.0, n_dirs,
                                 cw=32)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # K4d: one launch a sweep, whatever the number of chunks
    assert (lane.fused_rows_pass.launches, lane.chunked_sweep.launches) == \
        (before[0] + 4, before[1] + (4 if n_dirs == 8 else 2))


def _sweep_kw(H, W, kind, accumulate, vertical=None):
    """`chunked_sweep`'s arguments for one of `chunked_adj`'s four sweep
    kinds (`chunk_sweeps`: SE, NE, SW, NW), with a column offset and image
    width for Pout; ``vertical`` overrides the kind's vertical family."""
    kw = dict(lane.chunk_sweeps(H, W, 8)[kind], col0=3, W_pout=W + 5,
              P1=0.3, P2=1.1, Pout=7.0, accumulate=accumulate)
    if vertical is not None:
        kw["with_vertical"] = vertical
    return kw


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("vertical", [False, True])
@pytest.mark.parametrize("shift_down", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4d_pass_equals_plain(dev, reverse, shift_down, vertical,
                               accumulate):
    """K4d's one-launch sweep (`chunked_sweep`) at 40x300x352 with the
    card's chunk width (3 columns, 100 chunks) against its sweep-level
    plain version with `torch.equal`, reverse x shift_down x
    with_vertical, writing and accumulating, ten runs with the same bits,
    one launch each."""
    H, W, D = 40, 300, 352
    g = torch.Generator(device=dev).manual_seed(31)
    cv = torch.rand((H, W, D), generator=g, device=dev) * 3
    acc = torch.rand((H, W, D), generator=g, device=dev)
    kind = ("SE" if not reverse else "NE") if shift_down else \
        ("SW" if not reverse else "NW")
    kw = _sweep_kw(H, W, kind, accumulate, vertical)
    cw = lane.chunk_width(D, 8, W)
    assert cw == 3
    want = lane.chunked_sweep_plain(cv, acc.clone(), cw=W, **kw)
    before = lane.chunked_sweep.launches
    got = _ten_runs(lambda: (lane.chunked_sweep(cv, acc.clone(), cw=cw,
                                                **kw),))
    assert lane.chunked_sweep.launches == before + 10
    assert torch.equal(got[0], want)


# K4d's sweeps at the edges of its design: D not a multiple of 32 with
# H = 1, more chunks (150) than the card has SMs, so the ticket order is
# exercised, a 1-column chunk, a vertical-only sweep (4 directions), and
# the instance whose carries lie in global memory, past a one-column
# chunk's shared memory (D = 11700 with the diagonal, 29100 without);
# (H, W, D, cw, vertical-only)
K4D_CASES = {"d333_one_row": (1, 300, 333, None, False),
             "more_chunks_than_sms": (12, 300, 40, 2, False),
             "one_column": (9, 50, 333, 1, False),
             "four_directions": (20, 300, 333, None, True),
             "global_carries": (6, 40, 11700, None, False),
             "global_carries_four_directions": (4, 20, 29100, None, True)}


@pytest.mark.parametrize("case", list(K4D_CASES))
def test_k4d_sweeps_equal_plain_ten_runs(dev, case):
    """Each of K4d's four sweep kinds (one launch, all chunks) against its
    sweep-level plain version at the widest chunk, with `torch.equal`, ten
    runs with the same bits."""
    H, W, D, cw, vertical_only = K4D_CASES[case]
    cw = cw or lane.chunk_width(D, 4 if vertical_only else 8, W)
    assert lane.chunk_layout(D, cw, True, not vertical_only).spill is \
        case.startswith("global")
    g = torch.Generator(device=dev).manual_seed(H + W + D)
    cv = torch.rand((H, W, D), generator=g, device=dev) * 3
    acc = torch.rand((H, W, D), generator=g, device=dev)
    for kind in (("SE", "NE") if vertical_only else ("SE", "NE", "SW", "NW")):
        for accumulate in (False, True):
            kw = _sweep_kw(H, W, kind, accumulate)
            if vertical_only:
                kw.update(with_vertical=True, with_diag=False)
            want = lane.chunked_sweep_plain(cv, acc.clone(), cw=W, **kw)
            got = _ten_runs(lambda: (lane.chunked_sweep(
                cv, acc.clone(), cw=cw, **kw),))
            assert torch.equal(got[0], want), (kind, accumulate)


def test_past_the_column_scan_limit_runs_the_kernels_on_the_card(dev):
    """4-direction `sgm_wta_truncated` at W <= 132 and D just past the WTA
    column scan's shared memory (14461): K4b's rows fit (`fused_fits`), so
    the scan was launched and refused with cudaErrorInvalidValue; now the
    scan keeps its carries in global memory (`cols_spills`), and the card
    runs K4b's two row sweeps and both column scans and returns the CPU
    run's bits (the plain versions, held to JAX's on the CPU)."""
    from libstevi_tpu_torch.ops.sgm import sgm_route
    D = 14461
    assert lane.fused_fits(3, D, 4) and lane.cols_spills(D, True)
    assert sgm_route(D, 4, 0.3, 1.1, True) == "lane"
    g = torch.Generator(device=dev).manual_seed(5)
    cv = torch.rand((2, 3, D), generator=g, device=dev) * 3
    counters = (lane.fused_rows_pass, lane.fused_cols_pass,
                lane.fused_cols_wta, lane.chunked_sweep)
    before = [fn.launches for fn in counters]
    ig, tg = sgm_wta_truncated(cv, 0.3, 1.1, Pout=7.0, n_directions=4)
    torch.cuda.synchronize()
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [2, 1, 1, 0]
    ic, tc = sgm_wta_truncated(cv.cpu(), 0.3, 1.1, Pout=7.0, n_directions=4)
    assert torch.equal(ig.cpu(), ic)
    torch.testing.assert_close(tg.cpu(), tc, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("n_dirs,shape", [(8, (2, 3, 12000)),
                                          (16, (2, 3, 12000)),
                                          (16, (5, 7, 9700)),
                                          (4, (3, 2, 30000))])
def test_past_the_shared_memory_equals_plain(dev, n_dirs, shape):
    """Past the D whose carries fit a block's shared memory (K4d's
    one-column chunk, K2k's any-D ring, the WTA column scan), the lane
    route's kernels run with their carries in global memory: K4d's sweeps
    (one launch each), K4b's column scans and, with 16 directions, K2k's
    knights, launched and equal to the plain versions on the CPU bit for
    bit, `sgm_cost_volume` and `sgm_wta_truncated` alike."""
    D = shape[-1]
    g = torch.Generator(device=dev).manual_seed(D + n_dirs)
    cv = torch.rand(shape, generator=g, device=dev) * 3
    counters = (lane.chunked_sweep, lane.fused_cols_pass,
                lane.fused_cols_wta, knight_volumes)
    before = [fn.launches for fn in counters]
    got = sgm_cost_volume(cv, 0.3, 1.1, Pout=7.0, n_directions=n_dirs)
    ig, tg = sgm_wta_truncated(cv, 0.3, 1.1, Pout=7.0, n_directions=n_dirs)
    torch.cuda.synchronize()
    sweeps = 4 if n_dirs >= 8 else 2
    knights = 4 if n_dirs == 16 else 0
    assert [fn.launches - b for fn, b in zip(counters, before)] == \
        [2 * sweeps, 3, 1, knights]
    assert torch.equal(got.cpu(), sgm_cost_volume(cv.cpu(), 0.3, 1.1,
                                                  Pout=7.0,
                                                  n_directions=n_dirs))
    ic, tc = sgm_wta_truncated(cv.cpu(), 0.3, 1.1, Pout=7.0,
                               n_directions=n_dirs)
    assert torch.equal(ig.cpu(), ic)
    torch.testing.assert_close(tg.cpu(), tc, rtol=0, atol=0, equal_nan=True)


def test_wide_path_matches_cpu(dev):
    """D > 320 through `dense_sgm_stereo` on the card (K1 in one launch,
    K4b with WTA) against the CPU run."""
    L, R = _pair(dev, 20, 400, seed=8)
    kw = dict(n_directions=8, refine_kernel=InterpolationKernel.PARABOLA)
    counts = (box_cv.launches, lane.fused_rows_pass.launches,
              lane.fused_cols_wta.launches)
    dg, ig, tg = dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 3, 3, 330,
                                  0.1, 0.5, **kw)
    assert (box_cv.launches, lane.fused_rows_pass.launches,
            lane.fused_cols_wta.launches) == (counts[0] + 1, counts[1] + 2,
                                              counts[2] + 1)
    dc, ic, tc = dense_sgm_stereo(MatchingFunction.ZNCC, L.cpu(), R.cpu(),
                                  3, 3, 330, 0.1, 0.5, **kw)
    same = ig.cpu() == ic
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                               atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(18, 7, 5), (5, 21, 5)])
@pytest.mark.parametrize("direction", _KNIGHT_DIRS, ids=lambda d: d.name)
def test_k2k_matches_plain(dev, direction, shape, dtype):
    """K2k with one direction in its grid (the memory fallback's form):
    the volume equals the plain lane form bit for bit, in two launches,
    and `knight_adj`'s line form (another sum order where lines overlap)
    within 1e-4."""
    cv = _volume(dev, shape, dtype)
    want = knight_volumes_plain(cv, [direction], 0.1, 0.5, 100.0)
    before = knight_volumes.launches
    got = knight_volumes(cv, [direction], 0.1, 0.5, 100.0)
    assert knight_volumes.launches == before + 2
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got[0], knight_adj(cv.float(), direction, 0.1,
                                                  0.5, 100.0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 96, 120), (24, 70, 300),
                                   (20, 52, 330), (24, 60, 384)],
                         ids=lambda s: f"D{s[2]}")
def test_knight_volumes_equal_plain(dev, shape, dtype):
    """All 8 knight directions in one pair of launches, at D = 120 and 300
    (the register instance) and 330 and 384 (the any-D instance): equal to
    the plain version bit for bit, the same on a second run, every entry
    written by phase 0 (``out`` filled with NaN first), and summed into an
    accumulator equal to the one-direction-at-a-time memory fallback bit
    for bit."""
    g = torch.Generator(device=dev).manual_seed(shape[2])
    cv = (torch.rand(shape, generator=g, device=dev) * 3).to(dtype)
    want = knight_volumes_plain(cv, _KNIGHT_DIRS, 0.1, 0.5, 100.0)
    out = torch.full((8,) + shape, float("nan"), device=dev)
    before = knight_volumes.launches
    got = knight_volumes(cv, _KNIGHT_DIRS, 0.1, 0.5, 100.0, out=out)
    assert knight_volumes.launches == before + 2 and got is out
    assert torch.equal(got, want)
    assert torch.equal(knight_volumes(cv, _KNIGHT_DIRS, 0.1, 0.5, 100.0), got)
    acc = torch.rand(shape, generator=g, device=dev)
    one = add_knight_volumes(cv, acc.clone(), _KNIGHT_DIRS, 0.1, 0.5, 100.0,
                             one_launch=True)
    before = knight_volumes.launches
    fallback = add_knight_volumes(cv, acc.clone(), _KNIGHT_DIRS, 0.1, 0.5,
                                  100.0, one_launch=False)
    assert knight_volumes.launches == before + 16
    assert torch.equal(one, fallback)


def test_k2k_is_deterministic(dev):
    cv = _volume(dev, (64, 96, 40), torch.float32)
    runs = [knight_volumes(cv, _KNIGHT_DIRS, 0.1, 0.5, 100.0)
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES + [(9, 30, 300)])
def test_k3_over_15_volumes_matches_plain(dev, shape, dtype):
    """SGM-16's one-launch form: the 7 K2 volumes and the 8 knight volumes
    in one stack; K3 over it equals K3 over the sequential accumulator
    (`sgm_accumulate`) bit for bit, and its plain version within 1e-4
    (idx on >= 0.999 of the pixels)."""
    cv = _volume(dev, shape, dtype)
    dirs = [d for d in directions_for(16) if d is not SgmDirection.RIGHT2LEFT]
    stack = torch.empty((15,) + tuple(cv.shape), device=dev)
    direction_volumes(cv, dirs[:7], 0.1, 0.5, 100.0, out=stack[:7])
    knight_volumes(cv, dirs[7:], 0.1, 0.5, 100.0, out=stack[7:])
    seq = sgm_accumulate(cv, dirs, 0.1, 0.5, 100.0)
    assert torch.equal(_acc_sum(stack), seq)
    for a, b in zip(sgm_wta(cv, stack, 0.1, 0.5, 100.0, 1, 3, 3, True),
                    sgm_wta(cv, seq, 0.1, 0.5, 100.0, 1, 3, 3, True)):
        assert torch.equal(torch.nan_to_num(a, 9.0), torch.nan_to_num(b, 9.0))
    i1, b1, _ = sgm_wta(cv, stack, 0.1, 0.5, 100.0, 1, 3, 3, True)
    i2, b2, _ = sgm_wta_plain(cv, stack, 0.1, 0.5, 100.0, 1, 3, 3, True)
    same = i1 == i2
    assert same.float().mean().item() >= 0.999
    torch.testing.assert_close(b1[same], b2[same], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [300, 320])
def test_d300_kernels_match_plain(dev, D, dtype):
    """K1 (bitwise), K2, K2k and K3 at D = 300 and 320 (K = 10 values a
    lane in K2, K2k and K3; at 320 every slice of every lane is full)."""
    H, W = 24, 340
    L, R = _pair(dev, H, W, 3)
    cv = box_cv(MatchingFunction.ZNCC, L, R, 3, 3, D, dtype, negate=True)
    want = box_cv_plain(MatchingFunction.ZNCC, L, R, 3, 3, D, torch.float32,
                        negate=True)
    assert torch.equal(cv, want.to(dtype))
    acc = torch.empty(cv.shape, device=dev)
    acc2 = torch.empty(cv.shape, device=dev)
    for k, d in enumerate(directions_for(8)):
        if d is not SgmDirection.RIGHT2LEFT:
            sgm_pass(cv, acc, d, 0.1, 0.5, 100.0, accumulate=k > 0)
            sgm_pass_plain(cv, acc2, d, 0.1, 0.5, 100.0, accumulate=k > 0)
    vols = knight_volumes(cv, _KNIGHT_DIRS, 0.1, 0.5, 100.0)
    assert torch.equal(vols, knight_volumes_plain(cv, _KNIGHT_DIRS, 0.1, 0.5,
                                                  100.0))
    for v in vols:
        acc.add_(v)
        acc2.add_(v)
    torch.testing.assert_close(acc, acc2, rtol=1e-4, atol=1e-4)
    i1, b1, d1 = sgm_wta(cv, acc, 0.1, 0.5, 100.0, 1, 3, 3, True)
    i2, b2, d2 = sgm_wta_plain(cv, acc, 0.1, 0.5, 100.0, 1, 3, 3, True)
    same = i1 == i2
    assert same.float().mean().item() >= 0.999
    torch.testing.assert_close(b1[same], b2[same], rtol=1e-4, atol=1e-4)
    f = same & torch.isfinite(d2)
    torch.testing.assert_close(d1[f], d2[f], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_dirs", [8, 16])
def test_margins_match_cpu(dev, n_dirs):
    cv = _volume(dev, (30, 44, 11), torch.float32)
    m = Margins(2, 1, 3, 2)
    got = sgm_cost_volume(cv, 0.1, 0.5, m, n_directions=n_dirs)
    want = sgm_cost_volume(cv.cpu(), 0.1, 0.5, m, n_directions=n_dirs)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[:1].cpu(), cv[:1].cpu())    # outside: untouched
    # with margins: sgm_cost_volume (K2 x8, K2k) -> WTA -> band, as in JAX
    counts = (sgm_pass.launches, knight_volumes.launches, sgm_wta.launches)
    ig, tg = sgm_wta_truncated(cv, 0.1, 0.5, m, n_directions=n_dirs,
                               h_radius=2, v_radius=1)
    assert (sgm_pass.launches, knight_volumes.launches,
            sgm_wta.launches) == (counts[0] + 8,
                                  counts[1] + (2 if n_dirs == 16 else 0),
                                  counts[2])
    ic, tc = sgm_wta_truncated(cv.cpu(), 0.1, 0.5, m, n_directions=n_dirs,
                               h_radius=2, v_radius=1)
    same = ig.cpu() == ic
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                               atol=1e-4, equal_nan=True)


@pytest.mark.parametrize("func,n_dirs", [("CENSUS", 8), ("SAD", 8),
                                         ("ZNCC", 16)])
def test_dense_routes_match_cpu(dev, func, n_dirs):
    """The census / SAD route (volume, then K2 and K3) and the 16-direction
    path on the card against the plain path on the CPU."""
    L, R = _pair(dev, 40, 72, seed=6)
    P1, P2 = (1.0, 4.0) if func == "CENSUS" else (0.1, 0.5)
    kw = dict(n_directions=n_dirs, refine_kernel=InterpolationKernel.PARABOLA)
    counts = _path_counts()
    f = MatchingFunction[func]
    dg, ig, tg = dense_sgm_stereo(f, L, R, 3, 3, 16, P1, P2, **kw)
    # K2 in one launch; 16 directions: and the knights in two
    sixteen = n_dirs == 16
    assert _path_counts()[1:] == (counts[1], counts[2] + 1,
                                  counts[3] + (2 if sixteen else 0),
                                  counts[4] + 1)
    dc, ic, tc = dense_sgm_stereo(f, L.cpu(), R.cpu(), 3, 3, 16, P1, P2, **kw)
    same = ig.cpu() == ic
    assert same.float().mean().item() > 0.999
    torch.testing.assert_close(tg.cpu()[same], tc[same], rtol=1e-4,
                               atol=1e-4, equal_nan=True)
    torch.testing.assert_close(dg.cpu()[same], dc[same], rtol=1e-4,
                               atol=1e-4, equal_nan=True)


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


def _flood_state(L, S, D, lower, seed):
    """In sweep order (lines first): the first line's value v0 runs across
    the lines up to 2L/3, whose own values all differ from v0 and from
    their neighbours, so no run breaks by equality: one run of ~100 lines
    a chain; the line at 2L/3 rejects v0.  Each cost is
    its pixel's own volume value."""
    rng = np.random.default_rng(seed)
    v0 = D // 2
    k = (np.arange(L)[:, None] * 5 + np.arange(S)[None] * 3) % (D - 1)
    k[k >= v0] += 1
    k[0] = v0
    cv = rng.uniform(1, 2, (L, S, D)).astype(np.float32)
    cv[:, :, v0] = 0.5
    cv[2 * L // 3, :, v0] = 3.0
    cost = np.take_along_axis(cv, k[..., None], -1)[..., 0]
    return cv, (k + lower).astype(np.int32), cost


def _k6_case(case, axis, reverse, dev):
    """(cv, disp, cost, lower) of one K6 edge case as (H, W) images."""
    rng = np.random.default_rng(7)
    lower = 0
    if case == "flood":
        L, S, D, lower = 150, 45, 40, -7
        cv, disp, cost = _flood_state(L, S, D, lower, 8)
        if reverse:
            cv, disp, cost = cv[::-1], disp[::-1], cost[::-1]
        if axis == 1:
            cv, disp, cost = cv.swapaxes(0, 1), disp.T, cost.T
    else:
        # (lines, chains, D): one line, two lines, chains not a multiple
        # of the 32-chain block, lines past a 32-line tile
        L, S, D = {"L1": (1, 45, 13), "L2": (2, 45, 13),
                   "odd": (77, 45, 13), "neg_lower": (70, 33, 21),
                   "inf_ties": (67, 38, 9),
                   "random_cost": (65, 70, 30)}[case]
        H, W = (L, S) if axis == 0 else (S, L)
        if case == "neg_lower":
            lower = -11
        if case == "inf_ties":      # small integers: many ties, and +inf
            cv = rng.integers(0, 3, (H, W, D)).astype(np.float32)
            cv[rng.uniform(size=cv.shape) < 0.15] = np.inf
        else:
            cv = rng.uniform(0, 1, (H, W, D)).astype(np.float32)
            cv[rng.uniform(size=cv.shape) < 0.05] = np.inf
        disp = rng.integers(lower - 2, lower + D + 2, (H, W)).astype(
            np.int32)
        if case == "random_cost":   # not the pixels' own volume values
            cost = rng.uniform(0, 1, (H, W)).astype(np.float32)
        else:
            k = np.clip(disp - lower, 0, D - 1)
            cost = np.take_along_axis(cv, k[..., None], -1)[..., 0]
            cost = np.where((disp >= lower) & (disp < lower + D), cost,
                            np.float32(np.inf))
            if case == "inf_ties":
                cost = np.minimum(cost, 2).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (cv, disp, cost)) + (lower,)


@pytest.mark.parametrize("case", ["L1", "L2", "odd", "neg_lower", "inf_ties",
                                  "flood", "random_cost"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_k6_edge_cases_equal_plain(dev, axis, reverse, case):
    """K6's three launches against `sweep_plain`, both planes bitwise, in
    all four directions: sweeps of one and two lines, chains not a
    multiple of the block, a negative `lower`, +inf entries and ties, a
    flood whose run crosses 2/3 of every line (many batches in A), and
    costs that are not the pixels' own volume values."""
    cv, disp, cost, lower = _k6_case(case, axis, reverse, dev)
    before = sweep.launches
    got = sweep(cv, disp, cost, lower, axis, reverse)
    assert sweep.launches == before + 1
    want = sweep_plain(cv, disp, cost, lower, axis, reverse)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if case == "flood":             # the run did cross 100 lines
        lines = want[0].t() if axis == 1 else want[0]
        lines = lines.flip(0) if reverse else lines
        assert bool((lines[1:100] == lines[0]).all())


def _probe_inputs(dev, shape, K, seed):
    """A volume of small integers (ties) with +inf, a state reaching past
    either end of the range, and K raw draws in the search range."""
    H, W, D = shape
    rng = np.random.default_rng(seed)
    cv = rng.integers(0, 4, (H, W, D)).astype(np.float32)
    cv[rng.uniform(size=cv.shape) < 0.1] = np.inf
    disp = rng.integers(-3, D + 3, (H, W)).astype(np.int32)
    cost = rng.integers(0, 4, (H, W)).astype(np.float32)
    draws = rng.integers(0, D, (K, H, W)).astype(np.int32)
    draws[0, :3] = disp[:3]            # scaled to the current value: moved
    return tuple(torch.from_numpy(x).to(dev)
                 for x in (cv, disp, cost, draws))


@pytest.mark.parametrize("shape", [(37, 101, 13), (64, 96, 40)])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7, 8, 11])
def test_k7_and_search_probe_equal_plain(dev, K, shape):
    """K7 at K = 1 to 8 (one launch) and 11 (two), as `probe` and as
    `search_probe` (candidates formed in the kernel: the floor of negative
    differences, forced off the current value), bitwise against their
    plain versions, with out-of-range candidates, +inf and ties; an odd
    pixel count takes the scalar path."""
    cv, disp, cost, draws = _probe_inputs(dev, shape, K, K)
    D = shape[2]
    cand = draws.clone()
    cand[-1, ::5] = D + 2                          # out of range
    cand[0, 1::5] = -1
    for fn, plain, args in ((probe, probe_plain, (cand, disp, cost, 0)),
                            (search_probe, search_probe_plain,
                             (draws, disp, cost, 0, K))):
        before = probe.launches
        got = fn(cv, *args)
        assert probe.launches == before + (K + 7) // 8
        want = plain(cv, *args)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert not torch.equal(got[0], disp)


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


# -- K2s, K4c, the any-D K2k and the distributed paths -----------------------

K2S_SHAPES = [(13, 37, 24), (9, 20, 300), (6, 11, 5), (7, 19, 330)]
PRINCIPAL = [d for d in directions_for(8) if d.step[0] != 0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K2S_SHAPES)
@pytest.mark.parametrize("direction", PRINCIPAL, ids=lambda d: d.name)
def test_k2s_equals_plain(dev, direction, shape, dtype):
    """K2s on a shard at an odd global row (rows [5, 5 + H) of H + 12),
    from random carries, accumulating and not: acc and the carries out
    equal the plain version's to the bit."""
    H, W, D = shape
    g = torch.Generator(device=dev).manual_seed(H * W)
    cv = (torch.rand(shape, generator=g, device=dev) * 3).to(dtype)
    carry = torch.rand((W, D), generator=g, device=dev) * 2
    for accumulate in (True, False):
        acc = torch.rand(shape, generator=g, device=dev)
        acc_p = acc.clone()
        before = sgm_shard_pass.launches
        co = sgm_shard_pass(cv, acc, direction, 0.3, 1.1, 7.0, accumulate,
                            carry, 5, H + 12)
        assert sgm_shard_pass.launches == before + 1
        co_p = sgm_shard_pass_plain(cv, acc_p, direction, 0.3, 1.1, 7.0,
                                    accumulate, carry, 5, H + 12)
        assert torch.equal(acc, acc_p) and torch.equal(co, co_p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", K2S_SHAPES + [(12, 30, 384)])
@pytest.mark.parametrize("direction", _KNIGHT_DIRS, ids=lambda d: d.name)
def test_k2s_knight_equals_plain(dev, direction, shape, dtype):
    """K2s for a knight direction on a block at an odd global offset along
    its primary axis (rows [5, 5 + H) of H + 12, or columns [3, 3 + W) of
    W + 10 with the Pout test at that offset), from random carries of both
    seed phases; D = 384 runs the any-D instance.  acc and the carries out
    equal the lane-form plain version's to the bit."""
    H, W, D = shape
    vert = direction.steps[0][0] != 0
    g = torch.Generator(device=dev).manual_seed(H + W)
    cv = (torch.rand(shape, generator=g, device=dev) * 3).to(dtype)
    X = W if vert else H
    carries = torch.rand((2, X, D), generator=g, device=dev) * 2
    kw = (dict(s0=5, N_img=H + 12) if vert
          else dict(s0=3, N_img=W + 10, col0=3, W_pout=W + 10))
    acc = torch.rand(shape, generator=g, device=dev)
    acc_p = acc.clone()
    before = sgm_knight_shard_pass.launches
    co = sgm_knight_shard_pass(cv, acc, direction, 0.3, 1.1, 7.0, carries,
                               **kw)
    assert sgm_knight_shard_pass.launches == before + 2
    co_p = sgm_knight_shard_pass_plain(cv, acc_p, direction, 0.3, 1.1, 7.0,
                                       carries, **kw)
    assert torch.equal(acc, acc_p) and torch.equal(co, co_p)


@pytest.mark.parametrize("direction", _KNIGHT_DIRS, ids=lambda d: d.name)
def test_k2k_any_d_matches_plain(dev, direction):
    """K2k past D = 320 (the shared-memory instance) on a whole image, one
    direction in the grid: equal to the lane-form plain version bitwise,
    added once to an accumulator equal to the shard pass's plain version
    bitwise, and within 1e-4 of `knight_adj`'s line form (another sum
    order where lines overlap)."""
    cv = _volume(dev, (24, 60, 384), torch.float32)
    acc = torch.rand(cv.shape, device=dev)
    got = knight_volumes(cv, [direction], 0.1, 0.5, 100.0)
    assert torch.equal(got, knight_volumes_plain(cv, [direction], 0.1, 0.5,
                                                 100.0))
    lane_form = acc.clone()
    sgm_knight_shard_pass_plain(cv, lane_form, direction, 0.1, 0.5, 100.0)
    assert torch.equal(acc + got[0], lane_form)
    torch.testing.assert_close(got[0], knight_adj(cv, direction, 0.1, 0.5,
                                                  100.0),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", LANE_SHAPES)
@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4c_equals_plain(dev, shape, diag, reverse):
    """K4c: K4b's row sweep on rows [3, 3 + H) of H + 9 from random carries,
    fresh and accumulating: the adj volume and the carries out equal the
    plain version's to the bit."""
    H, W, D = shape
    g = torch.Generator(device=dev).manual_seed(W)
    cv = torch.rand(shape, generator=g, device=dev) * 3
    carries = torch.rand((3 if diag else 1, W, D), generator=g,
                         device=dev) * 2
    kw = dict(col0=0, W_pout=W, P1=0.3, P2=1.1, Pout=7.0)
    for acc in (None, torch.rand(shape, generator=g, device=dev)):
        want = lane.fused_rows_shard_pass_plain(
            cv, None if acc is None else acc.clone(), carries, 3, H + 9,
            reverse, diag, **kw)
        before = lane.fused_rows_shard_pass.launches
        got = lane.fused_rows_shard_pass(cv, acc, carries, 3, H + 9, reverse,
                                         diag, **kw)
        assert lane.fused_rows_shard_pass.launches == before + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# The redesigned row sweep (K4b rows, K4c) and column scans at the main
# paths' shapes (480x640x384: 8 ring stages of cv and acc; 720x1280x640:
# 2 cv stages, acc loaded), a ragged width (D = 333, 11 parts a column),
# H = 1, W < 132 (fewer blocks than SMs), and the direct-load instance that
# a budget of the fit rule's bytes forces (one part, no stored minima)
K4_CASES = {"wide": (480, 640, 384, None), "hd_wide": (720, 1280, 640, None),
            "ragged": (37, 101, 333, None), "one_row": (1, 640, 384, None),
            "narrow": (20, 100, 333, None),
            "direct": (37, 101, 333, (2 * 3 + 2) * 333 * 4)}


def _ten_runs(fn):
    """fn() ten times, every run's tensors equal to the first's bit for
    bit; returns the first run's."""
    first = fn()
    for _ in range(9):
        for a, b in zip(first, fn()):
            assert torch.equal(a, b)
    return first


@pytest.mark.parametrize("part", ["rows", "k4c", "cols", "wta"])
@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4b_k4c_equal_plain_ten_runs(dev, case, part):
    """K4b's row sweeps (fresh and accumulating, down and up, with a
    column offset), K4c (rows [3, 3 + H) of H + 9, random carries in and
    out), both column scans and the WTA scan, the reverse scans with and
    without a stack of 1 and 8 knight volumes, equal to their plain
    versions with `torch.equal`, ten runs each with the same bits."""
    H, W, D, budget = K4_CASES[case]
    g = torch.Generator(device=dev).manual_seed(H + W + D)
    cv = torch.rand((H, W, D), generator=g, device=dev) * 3
    acc = torch.rand((H, W, D), generator=g, device=dev)
    kw = dict(col0=3, W_pout=W + 5, P1=0.3, P2=1.1, Pout=7.0)
    if part == "rows":
        for rev in (False, True):
            for a in (None, acc):
                want = lane.fused_rows_pass_plain(
                    cv, None if a is None else a.clone(), rev, True, **kw)
                before = lane.fused_rows_pass.launches
                got = _ten_runs(lambda: (lane.fused_rows_pass(
                    cv, None if a is None else a.clone(), rev, True,
                    budget=budget, **kw),))
                assert lane.fused_rows_pass.launches == before + 10
                assert torch.equal(got[0], want), (rev, a is None)
    elif part == "k4c":
        carries = torch.rand((3, W, D), generator=g, device=dev) * 2
        for rev in (False, True):
            for a in (None, acc):
                args = (carries, 3, H + 9, rev, True)
                want = lane.fused_rows_shard_pass_plain(
                    cv, None if a is None else a.clone(), *args, **kw)
                got = _ten_runs(lambda: lane.fused_rows_shard_pass(
                    cv, None if a is None else a.clone(), *args,
                    budget=budget, **kw))
                assert torch.equal(got[0], want[0]), (rev, a is None)
                assert torch.equal(got[1], want[1]), (rev, a is None)
    else:
        for n in (0, 1, 8):
            k = (torch.rand((n, H, W, D), generator=g, device=dev)
                 if n else None)
            if part == "wta":
                want = lane.fused_cols_wta_plain(cv, acc, 1, knights=k, **kw)
                got = _ten_runs(lambda: lane.fused_cols_wta(
                    cv, acc, 1, knights=k, **kw))
                assert torch.equal(got[0], want[0]), n
                assert torch.equal(got[1], want[1]), n
                continue
            for rev in ((False, True) if n == 0 else (True,)):
                want = lane.fused_cols_pass_plain(cv, acc.clone(), rev,
                                                  knights=k, **kw)
                got = _ten_runs(lambda: (lane.fused_cols_pass(
                    cv, acc.clone(), rev, knights=k, **kw),))
                assert torch.equal(got[0], want), (n, rev)
            del k


def test_fused_adj_sixteen_stack_equals_in_place(dev):
    """`fused_adj` with 16 directions: the knight volumes as a stack that
    the last scan sums (the card's form where they fit) equal the in-place
    adds bit for bit, volume and WTA, with two K2k launches a call."""
    cv = torch.rand(30, 140, 333, device=dev) * 3
    args = (cv, 1, 143, 0.3, 1.1, 7.0, 16)
    before = knight_volumes.launches
    assert torch.equal(lane.fused_adj(*args, one_launch=True),
                       lane.fused_adj(*args, one_launch=False))
    assert knight_volumes.launches == before + 2 + 16
    for a, b in zip(lane.fused_adj(*args, wta_radius=1, one_launch=True),
                    lane.fused_adj(*args, wta_radius=1, one_launch=False)):
        assert torch.equal(a, b)


def _shards(x, sizes):
    return list(x.split(sizes))


def _first_past_ring(elt, n_acc):
    from libstevi_tpu_torch.ops.sgm_cuda import MAX_D, ring_fits
    D = MAX_D + 1
    while ring_fits(D, elt, n_acc):
        D += 1
    return D


@pytest.mark.parametrize("dtype,accumulate", [(torch.float32, True),
                                              (torch.float32, False),
                                              (torch.bfloat16, True)],
                         ids=["f32_acc", "f32_write", "bf16_acc"])
def test_k2_past_the_ring_equals_plain(dev, dtype, accumulate):
    """C6's shapes: K2 at the first D past the ring of its first any-D
    form (`ring_fits`: 9641, 14461, 11569; now `pass_layout`'s shared
    instance, `test_k2_any_d_instances_equal_plain` reaches the device
    one): every principal direction, one launch each, and (writing) the 7
    of the WTA path in one launch, bitwise against the plain passes."""
    D = _first_past_ring(2 if dtype == torch.bfloat16 else 4,
                         1 if accumulate else 0)
    g = torch.Generator(device=dev).manual_seed(D)
    cv = (torch.rand((5, 7, D), generator=g, device=dev) * 4).to(dtype)
    for d in directions_for(8):
        acc = torch.rand(cv.shape, generator=g, device=dev)
        acc_p = acc.clone()
        before = sgm_pass.launches
        sgm_pass(cv, acc, d, 0.3, 1.1, 7.0, accumulate)
        assert sgm_pass.launches == before + 1
        sgm_pass_plain(cv, acc_p, d, 0.3, 1.1, 7.0, accumulate)
        torch.cuda.synchronize()
        assert torch.equal(acc, acc_p), d.name
    if not accumulate:
        dirs = [d for d in directions_for(8)
                if d is not SgmDirection.RIGHT2LEFT]
        got = direction_volumes(cv, dirs, 0.3, 1.1, 7.0)
        for d, a in zip(dirs, got):
            want = torch.empty(cv.shape, device=dev)
            sgm_pass_plain(cv, want, d, 0.3, 1.1, 7.0, accumulate=False)
            assert torch.equal(a, want), d.name


@pytest.mark.parametrize("direction", PRINCIPAL, ids=lambda d: d.name)
def test_k2s_past_the_ring_equals_plain(dev, direction):
    """C6's shape: K2s at D = 9641 (f32; the shared instance) on rows
    [2, 6) of 9 from random carries: the accumulator and the carries out
    bitwise."""
    D = _first_past_ring(4, 1)
    g = torch.Generator(device=dev).manual_seed(5)
    cv = torch.rand((4, 6, D), generator=g, device=dev) * 4
    acc = torch.rand(cv.shape, generator=g, device=dev)
    acc_p = acc.clone()
    carry = torch.rand((6, D), generator=g, device=dev)
    co = sgm_shard_pass(cv, acc, direction, 0.3, 1.1, 7.0, True, carry, 2, 9)
    co_p = sgm_shard_pass_plain(cv, acc_p, direction, 0.3, 1.1, 7.0, True,
                                carry, 2, 9)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_p) and torch.equal(co, co_p)


@pytest.mark.parametrize("n_dirs", [8, 16])
def test_distributed_sgm_past_the_ring_equals_plain(dev, n_dirs):
    """C6: `distributed_sgm_routed` over 2 row shards at D = 9641 takes
    the K2s engine (K4c's carries do not fit) and returns the volume the
    plain passes give, bitwise: the principal directions in order, then
    the knights' lane form (`sgm_accumulate`'s order)."""
    from libstevi_tpu_torch.parallel.sgm_dist import distributed_sgm_routed
    D = _first_past_ring(4, 1)
    g = torch.Generator(device=dev).manual_seed(n_dirs)
    cv = torch.rand((6, 9, D), generator=g, device=dev) * 4
    dirs = directions_for(n_dirs)
    acc = torch.empty(cv.shape, device=dev)
    principal = [d for d in dirs if not d.knight]
    for k, d in enumerate(principal):
        sgm_pass_plain(cv, acc, d, 0.3, 1.1, 7.0, accumulate=k > 0)
    for d in dirs:
        if d.knight:
            acc.add_(knight_volumes_plain(cv, [d], 0.3, 1.1, 7.0)[0])
    before = sgm_shard_pass.launches
    got = torch.cat(distributed_sgm_routed(_shards(cv, [3, 3]), 0.3, 1.1,
                                           7.0, n_dirs))
    assert sgm_shard_pass.launches > before
    torch.cuda.synchronize()
    assert torch.equal(got, cv + acc)


@pytest.mark.parametrize("n_dirs", [4, 8, 16])
def test_distributed_sgm_equals_single_device(dev, n_dirs):
    """Distributed SGM on 4 virtual shards of the card (odd and unequal
    shard heights, an odd width) equals the single-device
    `sgm_cost_volume` bit for bit: K2s relayed (D <= 320), and for 4 and 8
    directions at D = 330 K4c relayed."""
    from libstevi_tpu_torch.parallel.sgm_dist import (
        distributed_sgm_fused, distributed_sgm_fused_dhw,
        distributed_sgm_routed)
    g = torch.Generator(device=dev).manual_seed(n_dirs)
    cv = torch.rand((29, 37, 24), generator=g, device=dev) * 4
    sizes = [7, 9, 5, 8]
    want = sgm_cost_volume(cv, 0.3, 1.1, Pout=7.0, n_directions=n_dirs)
    before = (sgm_shard_pass.launches, sgm_knight_shard_pass.launches)
    got = torch.cat(distributed_sgm_fused_dhw(_shards(cv, sizes), 0.3, 1.1,
                                              7.0, n_dirs))
    assert sgm_shard_pass.launches > before[0]
    assert (sgm_knight_shard_pass.launches > before[1]) == (n_dirs == 16)
    assert torch.equal(got, want)
    if n_dirs == 16:
        return
    wide = torch.rand((21, 30, 330), generator=g, device=dev) * 4
    want = sgm_cost_volume(wide, 0.3, 1.1, Pout=7.0, n_directions=n_dirs)
    before = lane.fused_rows_shard_pass.launches
    for fn in (distributed_sgm_fused, distributed_sgm_routed):
        got = torch.cat(fn(_shards(wide, [5, 6, 4, 6]), 0.3, 1.1, 7.0,
                           n_dirs))
        assert torch.equal(got, want)
    assert lane.fused_rows_shard_pass.launches == before + 16


@pytest.mark.parametrize("n_dirs", [4, 8, 16])
def test_distributed_steps_match_cpu(dev, n_dirs):
    """`distributed_full_step` (batch 2, tile 2, dsh 2) and
    `distributed_dense_stereo_step` (batch 2, tile 4) on 8 virtual shards
    of the card against the same steps on the CPU."""
    from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
    from libstevi_tpu_torch.parallel.stereo import (
        distributed_dense_stereo_step, distributed_full_step)
    g = torch.Generator(device=dev).manual_seed(3)
    ls = torch.rand((2, 32, 48), generator=g, device=dev)
    rs = torch.rand((2, 32, 48), generator=g, device=dev)
    for step, spec in ((distributed_full_step, MeshSpec(2, 2, 2)),
                       (distributed_dense_stereo_step, MeshSpec(2, 4))):
        outs = []
        for d in (dev, torch.device("cpu")):
            mesh = make_stereo_mesh(spec, [d] * 8)
            fn = step(mesh, MatchingFunction.ZNCC, 2, 2, 12, 0.1, 0.5,
                      n_directions=n_dirs)
            outs.append(fn(ls.to(d), rs.to(d)).cpu())
        assert outs[0].shape == (2, 32, 48)
        assert (outs[0] == outs[1]).float().mean().item() > 0.999


# the any-D K2's instances (`pass_layout`): the registers instance from
# D = 321 (K = 4) and from 1025 (K = 8), shared carries from 8193, device
# carries from 28545; the first D of each and one past it, and the
# relay's D = 330, the 4K step's 384, and 640, 641, 1000
ANY_D = [321, 322, 330, 384, 640, 641, 1000, 1024, 1025, 1026, 8192, 8193,
         8194, 28544, 28545, 28546]


def _any_d_shape(D):
    """Small H x W, so the plain passes stay quick at D = 28546."""
    return (5, 7, D) if D > 8192 else (9, 13, D) if D > 1024 else (11, 17, D)


@pytest.mark.parametrize("accumulate", [True, False], ids=["acc", "write"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", ANY_D)
def test_k2_any_d_instances_equal_plain(dev, D, dtype, accumulate):
    """The any-D K2 in each of its instances: every principal direction,
    one launch each, onto a random accumulator (or writing it), against
    the plain pass at 1e-4; with ``accumulate`` False also the WTA path's
    7 directions in one launch (a volume each)."""
    from libstevi_tpu_torch.ops.sgm_cuda import pass_layout
    n_acc = 1 if accumulate else 0
    elt = 2 if dtype == torch.bfloat16 else 4
    want_inst = ("registers" if D <= 8192 else
                 "shared" if D <= 28544 else "device")
    assert pass_layout(D, elt, n_acc).carries == want_inst
    g = torch.Generator(device=dev).manual_seed(D)
    cv = (torch.rand(_any_d_shape(D), generator=g, device=dev) * 4).to(dtype)
    for d in directions_for(8):
        acc = torch.rand(cv.shape, generator=g, device=dev)
        acc_p = acc.clone()
        before = sgm_pass.launches
        sgm_pass(cv, acc, d, 0.3, 1.1, 7.0, accumulate)
        assert sgm_pass.launches == before + 1
        assert sgm_pass.layout.carries == want_inst
        sgm_pass_plain(cv, acc_p, d, 0.3, 1.1, 7.0, accumulate)
        torch.cuda.synchronize()
        torch.testing.assert_close(acc, acc_p, rtol=1e-4, atol=1e-4)
    if not accumulate:
        dirs = [d for d in directions_for(8)
                if d is not SgmDirection.RIGHT2LEFT]
        got = direction_volumes(cv, dirs, 0.3, 1.1, 7.0)
        for d, a in zip(dirs, got):
            want = torch.empty(cv.shape, device=dev)
            sgm_pass_plain(cv, want, d, 0.3, 1.1, 7.0, accumulate=False)
            torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", ANY_D)
def test_k2s_any_d_instances_equal_plain(dev, D, dtype):
    """K2s in each any-D instance: the six vertical and diagonal
    directions on rows [3, 3 + H) of an image H + 5 rows high, from random
    carries, the accumulator and the carries out bitwise."""
    g = torch.Generator(device=dev).manual_seed(D + 1)
    shape = _any_d_shape(D)
    H, W, _ = shape
    cv = (torch.rand(shape, generator=g, device=dev) * 4).to(dtype)
    for d in PRINCIPAL:
        acc = torch.rand(shape, generator=g, device=dev)
        acc_p = acc.clone()
        carry = torch.rand((W, D), generator=g, device=dev)
        co = sgm_shard_pass(cv, acc, d, 0.3, 1.1, 7.0, True, carry, 3, H + 5)
        co_p = sgm_shard_pass_plain(cv, acc_p, d, 0.3, 1.1, 7.0, True, carry,
                                    3, H + 5)
        torch.cuda.synchronize()
        assert torch.equal(acc, acc_p), d.name
        assert torch.equal(co, co_p), d.name


# launches of some 4000 lines, as the distributed 4K step's shards give the
# any-D K2 (3840 to 4379 lines a pass): rings of 2 stages a warp on an H100
SHALLOW_RING = {"k2_left_to_right": (4000, 5, "LEFT2RIGHT"),
                "k2s_top_to_bottom": (5, 4000, "UP2DOWN"),
                "k2s_diagonal": (5, 4000, "UPLEFT2DOWNRIGHT")}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(SHALLOW_RING), ids=str)
def test_any_d_shallow_ring_equals_plain(dev, case, dtype):
    """The any-D K2 at D = 384 where the launch's lines leave its ring the
    fewest stages: the layout the launcher reports equals `pass_layout`'s
    at the launch's lines and the card's SMs, and the pass equals its plain
    version (K2 at 1e-4 onto a random accumulator, K2s bitwise from random
    carries on rows [3, 8) of an image 12 rows high)."""
    from libstevi_tpu_torch.ops.sgm_cuda import pass_layout
    H, W, name = SHALLOW_RING[case]
    d, D = SgmDirection[name], 384
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lines = H if d.step[0] == 0 else W if d.step[1] == 0 else H + W - 1
    g = torch.Generator(device=dev).manual_seed(D)
    cv = (torch.rand((H, W, D), generator=g, device=dev) * 4).to(dtype)
    acc = torch.rand(cv.shape, generator=g, device=dev)
    acc_p = acc.clone()
    elt = 2 if dtype == torch.bfloat16 else 4
    if d.step[0] == 0:
        sgm_pass(cv, acc, d, 0.3, 1.1, 7.0)
        sgm_pass_plain(cv, acc_p, d, 0.3, 1.1, 7.0)
        used = sgm_pass.layout
        torch.cuda.synchronize()
        torch.testing.assert_close(acc, acc_p, rtol=1e-4, atol=1e-4)
    else:
        carry = torch.rand((W, D), generator=g, device=dev)
        co = sgm_shard_pass(cv, acc, d, 0.3, 1.1, 7.0, True, carry, 3, 12)
        co_p = sgm_shard_pass_plain(cv, acc_p, d, 0.3, 1.1, 7.0, True, carry,
                                    3, 12)
        used = sgm_shard_pass.layout
        torch.cuda.synchronize()
        assert torch.equal(acc, acc_p) and torch.equal(co, co_p)
    assert used == pass_layout(D, elt, 1, lines, sms)
    if sms == 132:
        assert used.carries == "registers" and used.stages == 2, used


K5_SHIFTS = {"r2l": list(range(120)), "l2r": [-d for d in range(57)],
             "offset": list(range(-9, 191)), "nonunit": list(range(0, 90, 3))}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shifts", list(K5_SHIFTS), ids=str)
@pytest.mark.parametrize("F", [49, 121, 147])
@pytest.mark.parametrize("kernel", ["dot", "ssd", "sad"])
def test_k5_instances_equal_plain(dev, kernel, F, shifts, dtype):
    """K5's two instances (`fv_instance`): the register tiles along
    unit-step lists (RIGHT_TO_LEFT, LEFT_TO_RIGHT, an offset range of 200
    shifts, two blocks of d-tiles), the general form on a list of step 3,
    at W = 301 (not a multiple of either column tile), against
    `fused_fv_cost_volume_plain`: f32 at 1e-5, bf16 within one ulp."""
    from libstevi_tpu_torch.ops.fv_backend import fv_instance
    sh = K5_SHIFTS[shifts]
    assert fv_instance(sh) == ("general" if shifts == "nonunit" else "tiled")
    g = torch.Generator(device=dev).manual_seed(F)
    H, W = 3, 301
    src = torch.rand(H, W, F, generator=g, device=dev) - 0.5
    tgt = torch.rand(H, W, F, generator=g, device=dev) - 0.5
    before = fused_fv_cost_volume.launches
    got = fused_fv_cost_volume(kernel, src, tgt, sh, dtype)
    assert fused_fv_cost_volume.launches == before + 1
    want = fused_fv_cost_volume_plain(kernel, src, tgt, sh)
    torch.cuda.synchronize()
    assert got.shape == (H, W, len(sh)) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        _ulp_close(got.float(), want)


def _hier_counts():
    return (window_stats.launches, box_cv.launches,
            fused_fv_cost_volume.launches)


@pytest.mark.parametrize("func,depth,D", [("ZNCC", 2, 40), ("ZNCC", 3, 64),
                                          ("ZSAD", 2, 40)])
def test_hierarchical_frame_matches_cpu(dev, func, depth, D):
    """The hierarchical matcher on the card against the same call on the
    CPU: disp_estimate equal on >= 0.999 of pixels, the truncated volume
    within 1e-4 where they agree.  ZNCC's coarsest level is one K1
    statistics and one K1 volume launch; ZSAD's one K5 launch."""
    from libstevi_tpu_torch.ops.hierarchical import (
        hierarchical_truncated_cost_volume as hier)
    f = MatchingFunction[func]
    L, R = _pair(dev, 96, 160, seed=4)
    before = _hier_counts()
    g = hier(f, L, R, 3, 3, D, depth=depth)
    after = _hier_counts()
    want = (1, 1, 0) if func == "ZNCC" else (0, 0, 1)
    assert tuple(a - b for a, b in zip(after, before)) == want
    c = hier(f, L.cpu(), R.cpu(), 3, 3, D, depth=depth)
    same = g.disp_estimate.cpu() == c.disp_estimate
    assert same.float().mean().item() >= 0.999
    torch.testing.assert_close(g.truncated_cost_volume.cpu()[same],
                               c.truncated_cost_volume[same], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("shapes", [((120, 160), (240, 320)),
                                    ((360, 640), (720, 1280)),
                                    ((45, 80), (90, 160))])
def test_hierarchical_guide_is_device_independent(dev, shapes):
    """The upsampled guide and the downsampled pyramid have the same bits
    on the card as on the CPU (the positions divide by a tensor; the
    window sums are elementwise adds)."""
    from libstevi_tpu_torch.interpolation import average_pooling_downsample
    from libstevi_tpu_torch.ops.hierarchical import _bilinear_guide
    (hg, wg), (h, w) = shapes
    g = torch.randint(0, 120, (hg, wg), dtype=torch.int32)
    assert torch.equal(_bilinear_guide(g.to(dev), h, w).cpu(),
                       _bilinear_guide(g, h, w))
    img = torch.rand(h + 1, w + 3)
    assert torch.equal(average_pooling_downsample(img.to(dev), 2).cpu(),
                       average_pooling_downsample(img, 2))


def test_new_matchers_match_cpu(dev):
    """DP stereo, fastmatch (on demand, CENSUS, and over a volume) and a
    2-D volume with its WTA and refinement on the card against the CPU on
    the same inputs; `patch_match_flow` with one replayed draw stream."""
    from libstevi_tpu_torch.core import SearchOffset2
    from libstevi_tpu_torch.ops import (
        extract_selected_2d_index, normalize_feature_volume,
        patch_match_flow, refine_disp_2d_cost_interpolation,
        truncated_bidirectional_cost_volume, unfold,
        unfold_based_2d_disparity_cost_volume, unfold_based_cost_volume)
    from libstevi_tpu_torch.ops.dp_stereo import dp_stereo
    from libstevi_tpu_torch.ops.fastmatch import fastmatch, fastmatch_from_cv
    from libstevi_tpu_torch.ops.guided_filtering import (
        guided_cost_volume_aggregation)
    L, R = _pair(dev, 40, 64, seed=5)
    cv = unfold_based_cost_volume(MatchingFunction.ZSSD, L, R, 2, 2, 16)
    g, c = dp_stereo(cv, 0.05, 0.2), dp_stereo(cv.cpu(), 0.05, 0.2)
    assert torch.equal(g.disparity.cpu(), c.disparity)
    assert torch.equal(g.occlusion.cpu(), c.occlusion)
    assert torch.equal(fastmatch_from_cv(MatchingFunction.ZSSD, cv).cpu(),
                       fastmatch_from_cv(MatchingFunction.ZSSD, cv.cpu()))
    torch.testing.assert_close(
        guided_cost_volume_aggregation(cv, L, 2).cpu(),
        guided_cost_volume_aggregation(cv.cpu(), L.cpu(), 2), rtol=1e-5,
        atol=1e-5)
    CENSUS = MatchingFunction.CENSUS
    fs, ft = (normalize_feature_volume(CENSUS, unfold(2, 2, x))
              for x in (R, L))
    assert torch.equal(fastmatch(CENSUS, fs, ft, 16).cpu(),
                       fastmatch(CENSUS, fs.cpu(), ft.cpu(), 16))

    s2 = SearchOffset2(-3, 3, -2, 4)
    v = unfold_based_2d_disparity_cost_volume(MatchingFunction.ZNCC, L, R, 2,
                                              2, s2)
    torch.testing.assert_close(
        v.cpu(), unfold_based_2d_disparity_cost_volume(
            MatchingFunction.ZNCC, L.cpu(), R.cpu(), 2, 2, s2),
        rtol=1e-5, atol=1e-5)
    idx = extract_selected_2d_index(v, ExtractionStrategy.SCORE)
    assert torch.equal(idx.cpu(), extract_selected_2d_index(
        v.cpu(), ExtractionStrategy.SCORE))
    band = truncated_bidirectional_cost_volume(v, idx)
    ref = refine_disp_2d_cost_interpolation(InterpolationKernel.PARABOLA,
                                            -band, idx)
    torch.testing.assert_close(
        ref.cpu(), refine_disp_2d_cost_interpolation(
            InterpolationKernel.PARABOLA, -band.cpu(), idx.cpu()),
        rtol=1e-5, atol=1e-5)

    def flow(a, b, device):
        rng = np.random.default_rng(3)

        def draw(shape, lo, hi):
            return torch.from_numpy(rng.integers(lo, hi, shape).astype(
                np.int32)).to(device)
        return patch_match_flow(CENSUS, a, b, s2, 3, 2, draw=draw)

    assert torch.equal(flow(fs, ft, dev).cpu(), flow(fs.cpu(), ft.cpu(),
                                                     "cpu"))


# -- the small-system solver and the image-level refinement ------------------

@pytest.mark.parametrize("k", [1, 2, 3, 7])
def test_small_lstsq_cuda_matches_cpu_on_rank_deficient(dev, k):
    """`optim.lsq.small_lstsq` on the card against the CPU (the same
    float64 arithmetic): full-rank, rank-1 (exact multiples) and all-zero
    systems of 49 rows in one batch, within 1e-5; zero where the system
    is zero, never NaN."""
    from libstevi_tpu_torch.optim.lsq import small_lstsq
    rng = np.random.default_rng(k)
    A = rng.normal(size=(3000, 49, k)).astype(np.float32)
    A[1000:2000] = A[1000:2000, :, :1] * np.arange(1, k + 1)
    A[2000:] = 0
    b = rng.normal(size=(3000, 49)).astype(np.float32)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    got = small_lstsq(At.to(dev), bt.to(dev)).cpu()
    want = small_lstsq(At, bt)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not got[2000:].any()


@pytest.mark.parametrize("method", ["barycentric", "barycentric-symmetric",
                                    "cost-symmetric"])
def test_refined_frame_480x640_matches_cpu(dev, method):
    """`entry.stereo_refine_forward` (ZNCC 7x7, D = 120, one K5 launch) at
    480x640 on a random pair with a flat patch, against the CPU run of the
    same call: |diff| <= 1e-3 px on >= 0.999 of the pixels, < 1 px
    everywhere."""
    from libstevi_tpu_torch import entry
    L, R = _pair(dev, 480, 640, seed=31)
    L[100:200, 300:420] = 0.5
    R[100:200, 300:420] = 0.5
    fused_fv_cost_volume.launches = 0
    got = entry.stereo_refine_forward(L, R, method)
    assert fused_fv_cost_volume.launches == 1
    want = entry.stereo_refine_forward(L.cpu(), R.cpu(), method)
    d = (got.cpu() - want).abs()
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got.cpu()), fin)
    assert (d[fin] <= 1e-3).float().mean().item() >= 0.999
    assert (d[fin] < 1).all()
