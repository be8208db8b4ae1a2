"""K3's layout (`sgm_cuda.wta_layout`, the Python twin of `wta_layout` in
csrc/sgm_scan.cu) and `sgm_wta`'s argument checks, on the CPU.  The
kernel runs only on the card (tests/test_torch_cuda.py holds the layout it
reports to this twin there)."""

import re
from pathlib import Path

import pytest
import torch

import libstevi_tpu_torch
from libstevi_tpu_torch.ops import sgm_cuda as sc
from libstevi_tpu_torch.ops.sgm_cuda import sgm_wta, wta_layout

SM_BYTES = 233472      # an H100 SM's shared memory
BLOCK_BYTES = 232448   # the most a block can opt into (227 KB)
RESERVED = 1024        # the shared memory the card keeps a block
HEIGHTS = (1, 2, 131, 132, 133, 375, 480, 528, 529, 720, 1080, 2160, 5000)


def _cu_constants():
    """``constexpr int NAME = expr;`` of csrc/sgm_scan.cu, evaluated."""
    src = (Path(libstevi_tpu_torch.__file__).parent / "csrc" / "sgm_scan.cu"
           ).read_text()
    consts = {}
    for k, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        consts[k] = eval(expr, {}, dict(consts))
    return consts


def test_wta_layout_constants_match_the_cuda_source():
    c = _cu_constants()
    for k in ("WTA_REDUCE", "WTA_PACE", "WTA_WARPS_SM", "WTA_CHUNK",
              "WTA_CHUNKS", "WTA_BARS", "RING", "SMEM_MAX", "MAX_ACC"):
        assert getattr(sc, k) == c[k], k


@pytest.mark.parametrize("n_acc", range(1, 16))
@pytest.mark.parametrize("elt", (2, 4))
def test_wta_layout_fits_every_shape(elt, n_acc):
    """For every D <= 320 and heights from 1 to 5000 rows: at least one
    reduce warp of 2 to RING stages, the block within 227 KB with its
    static barriers, the rows an SM plans to hold within its 228 KB and its
    warp budget, two adj slots a reduce warp, and scan chunks of at least
    one pixel and at most WTA_CHUNK bytes of cost vectors (one pixel where
    a vector is longer)."""
    for D in range(1, sc.MAX_D + 1):
        for H in HEIGHTS:
            ly = wta_layout(D, elt, n_acc, H)
            block = ly.smem + 8 * sc.WTA_BARS
            assert 1 <= ly.reduce_warps <= sc.WTA_REDUCE, (D, H, ly)
            assert 2 <= ly.stages <= sc.RING, (D, H, ly)
            assert block <= BLOCK_BYTES, (D, H, ly)
            assert ly.rows_sm * (block + RESERVED) <= SM_BYTES, (D, H, ly)
            assert (1 + ly.reduce_warps) * ly.rows_sm <= sc.WTA_WARPS_SM
            assert ly.adj_slots == 2 * ly.reduce_warps
            assert ly.scan_chunks == sc.WTA_CHUNKS
            assert ly.scan_pixels >= 1
            assert (ly.scan_pixels == 1
                    or ly.scan_pixels * D * elt <= sc.WTA_CHUNK)
            assert (sc.WTA_CHUNKS + 2 * ly.adj_slots
                    + ly.reduce_warps * ly.stages) <= sc.WTA_BARS


def _plans(D, elt, n_acc, H, sms=sc.H100_SMS):
    """Every count of rows an SM could plan, as {n: (waves, R)}: the rows
    whose share of SMEM_SM holds the scan ring and one reduce warp of two
    stages (one row always), R the reduce warps that share and the warp
    budget give a row."""
    vec = 128 * -(-D // 32)
    stage = sc._r16(D * elt + 15) + n_acc * sc._r16(4 * D + 15)
    P = max(1, sc.WTA_CHUNK // (D * elt))
    scan = sc.WTA_CHUNKS * sc._r16(P * D * elt + 15)
    warp = 2 * stage + 3 * vec
    plans = {}
    for n in range(1, sc.WTA_WARPS_SM // 2 + 1):
        share = min(int(sc.SMEM_SM / n), sc.SMEM_MAX)
        if n > 1 and scan + warp > share:
            break
        if scan + warp > share:
            share = sc.SMEM_MAX
        R = min((share - scan) // warp, sc.WTA_REDUCE,
                sc.WTA_WARPS_SM // n - 1)
        plans[n] = (-(-H // (n * sms)), R)
    return plans


@pytest.mark.parametrize("elt,n_acc", [(2, 7), (4, 7), (4, 15), (2, 1)])
def test_wta_layout_leaves_no_row_or_pixel_unassigned(elt, n_acc):
    """A launch is H blocks of one row each, so every row is a block's; an
    SM plans the count of rows whose waves over their pace (the reduce
    warps a row has, up to WTA_PACE) are fewest, the fewest rows among
    equals, so where one wave at full pace fits the SMs plan to hold all
    H rows; and the reduce warps' turns (warp q takes scan steps q,
    q + R, ...: (W - 1 - q) // R + 1 of them where q < W) take every step
    of a row once, for rows narrower than the block's warps too."""
    for D in (1, 33, 120, 192, 320):
        for H in HEIGHTS:
            ly = wta_layout(D, elt, n_acc, H)
            plans = _plans(D, elt, n_acc, H)
            cost = {n: w / min(R, sc.WTA_PACE) for n, (w, R) in plans.items()}
            best = min(cost.values())
            assert ly.rows_sm == min(n for n in cost if cost[n] == best)
            assert ly.reduce_warps == plans[ly.rows_sm][1], (D, H, ly)
            if any(w == 1 and R >= sc.WTA_PACE for w, R in plans.values()):
                assert ly.rows_sm * sc.H100_SMS >= H, (D, H, ly)
            R = ly.reduce_warps
            for W in (1, 2, R - 1, R, R + 1, 7, 640, 1242):
                if W < 1:
                    continue
                steps = sorted(q + u * R for q in range(min(R, W))
                               for u in range((W - 1 - q) // R + 1))
                assert steps == list(range(W)), (D, H, W, ly)


def test_wta_layout_of_the_benchmark_shapes():
    """The VGA flagship (480x640x120 bf16, 7 volumes) and KITTI
    (375x1242x192 f32, 7 volumes) each run in one wave on an H100, 4 and
    3 rows an SM, with 4 reduce warps a row.  Past one wave at full pace
    the plan is the one the card ran fastest: the HD entry's 720 rows of
    D = 320 over 7 volumes take 2 rows an SM with 4 reduce warps (3
    waves), over SGM-16's 15 one row with 4 (6 waves), and 1080 rows of
    D = 192 over 7 take 3 rows with 4 (3 waves)."""
    def plan(*args):
        ly = wta_layout(*args)
        return ly.rows_sm, ly.reduce_warps, ly.stages

    assert plan(120, 2, 7, 480) == (4, 4, 2)
    assert plan(192, 4, 7, 375) == (3, 4, 2)
    assert plan(320, 2, 7, 720) == (2, 4, 2)
    assert plan(320, 2, 15, 720) == (1, 4, 2)
    assert plan(192, 2, 7, 1080) == (3, 4, 2)


def test_wta_layout_is_a_function_of_its_arguments():
    """More rows an SM never means more shared memory a block, and the
    SM count enters only through the waves, ceil(H / (n sms))."""
    for D in (1, 120, 192, 320):
        for n_acc in (1, 7, 15):
            a = wta_layout(D, 4, n_acc, 480, sms=132)
            assert a == wta_layout(D, 4, n_acc, 480, sms=132)
            assert a == wta_layout(D, 4, n_acc, 4 * 114, sms=114 + 6)
            one = wta_layout(D, 4, n_acc, 1)
            assert one.smem >= a.smem and one.rows_sm == 1


@pytest.mark.parametrize("D,n_acc", [(0, 7), (321, 7), (120, 0), (120, 16)])
def test_wta_layout_refuses_what_k3_does_not_take(D, n_acc):
    with pytest.raises(ValueError):
        wta_layout(D, 4, n_acc, 480)


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("case", ["wide", "refine_r0", "r_negative",
                                  "stack_strided", "sixteen", "device"])
def test_sgm_wta_argument_checks(case):
    """`sgm_wta` refuses, before it allocates or launches, what K3 does not
    take: D > 320, refine with r < 1, r < 0, a stack that is not one
    contiguous block, more than 15 volumes; and a volume off the card (a
    `meta` tensor here stands for a device tensor: the CPU's run the plain
    version)."""
    cv, stack = _meta(4, 6, 40), _meta(7, 4, 6, 40)
    args = dict(P1=0.1, P2=0.5, Pout=100.0, r=1, h_radius=3, v_radius=3,
                refine=True)
    want = ValueError
    if case == "wide":
        cv, stack, want = _meta(4, 6, 321), _meta(7, 4, 6, 321), \
            NotImplementedError
    elif case == "refine_r0":
        args["r"] = 0
    elif case == "r_negative":
        args.update(r=-1, refine=False)
    elif case == "stack_strided":
        stack = _meta(14, 4, 6, 40)[::2]
        assert all(a.is_contiguous() for a in stack)
    elif case == "sixteen":
        stack = _meta(16, 4, 6, 40)
    with pytest.raises(want):
        sgm_wta(cv, stack, **args)


def test_sgm_wta_takes_r0_without_refine_on_the_cpu():
    """r = 0 without refine is K3's narrowest band: the wrapper's plain
    version on the CPU gives one entry a pixel, C at idx."""
    g = torch.Generator().manual_seed(3)
    cv = torch.rand((3, 9, 5), generator=g)
    acc = torch.rand((2, 3, 9, 5), generator=g)
    idx, bands, disp = sgm_wta(cv, acc, 0.1, 0.5, 100.0, 0, 0, 0, False)
    assert disp is None and bands.shape == (3, 9, 1)
    wide_idx, wide, _ = sgm_wta(cv, acc, 0.1, 0.5, 100.0, 1, 0, 0, False)
    assert torch.equal(idx, wide_idx)
    assert torch.equal(bands[..., 0], wide[..., 1])
