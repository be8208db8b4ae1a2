"""The port's SGM (plain versions of K2 and K3) against the JAX package:
the XLA scan path, and the Pallas DHW kernels in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import (ExtractionStrategy as JES, Margins as JMargins,
                               MatchingFunction as JMF)
from libstevi_tpu.ops import (sgm_cost_volume as j_sgm, sgm_wta_truncated as
                              j_wta, extract_selected_index as j_extract)
from libstevi_tpu.ops import sgm_pallas_dhw as dhw
from libstevi_tpu.ops.box_pallas import box_cost_volume_fused_padded
from libstevi_tpu.ops.refinement import (InterpolationKernel as JInterp,
                                         refine_disp_cost_interpolation as
                                         j_refine, refine_cost_triplet as
                                         j_triplet)
from libstevi_tpu.ops.sgm import _tcv_from_bands as j_tcv_from_bands
from libstevi_tpu.ops.sgm import directions_for as j_directions_for

from libstevi_tpu_torch.core import Margins
from libstevi_tpu_torch.ops import (sgm_cost_volume, sgm_wta_truncated,
                                    extract_selected_index, directions_for,
                                    refine_cost_triplet,
                                    refine_disp_cost_interpolation)
from libstevi_tpu_torch.ops.sgm import SgmDirection, _tcv_from_bands
from libstevi_tpu_torch.ops.sgm_cuda import (sgm_pass, sgm_wta, sgm_wta_fused,
                                             sgm_wta_plain)
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cv(seed, shape, hi=1.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(np.float32)


def _clear_gap(sgm, strategy=JES.COST, gap=1e-4):
    """Pixels whose best and second-best SGM values differ by more than
    ``gap``: there the WTA index is decided by more than rounding."""
    v = np.sort(np.asarray(sgm) * (1 if strategy is JES.COST else -1), -1)
    return (v[..., 1] - v[..., 0]) > gap


def test_directions_match_jax():
    for n in (4, 8, 16):
        assert [d.name for d in directions_for(n)] == \
            [d.name for d in j_directions_for(n)]


@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
@pytest.mark.parametrize("n_dirs", [4, 8])
def test_sgm_cost_volume_matches_xla(n_dirs, strategy):
    cv = _cv(0, (13, 17, 6))
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.1, 0.4, Pout=7.0,
                            n_directions=n_dirs, strategy=JES[strategy],
                            backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), 0.1, 0.4, Pout=7.0,
                          n_directions=n_dirs,
                          strategy=to_port(JES[strategy])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("case", ["margins", "p2_below_p1", "pout_w_lt_d",
                                  "tall", "wide"])
def test_sgm_cost_volume_cases_match_xla(case):
    shape, P1, P2, m = (12, 15, 5), 0.2, 0.7, (0, 0, 0, 0)
    if case == "margins":
        m = (2, 1, 3, 2)
    elif case == "p2_below_p1":
        P1, P2 = 0.5, 0.2
    elif case == "pout_w_lt_d":
        shape = (6, 4, 6)
    elif case == "tall":
        shape = (18, 7, 5)
    elif case == "wide":
        shape = (5, 21, 5)
    cv = _cv(1, shape)
    want = np.asarray(j_sgm(jnp.asarray(cv), P1, P2, JMargins(*m), Pout=5.0,
                            n_directions=8, backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), P1, P2, Margins(*m),
                          Pout=5.0, n_directions=8).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
@pytest.mark.parametrize("n_dirs", [4, 8])
def test_sgm_wta_truncated_matches_xla(n_dirs, strategy):
    cv = _cv(2, (14, 19, 7), hi=3.0)
    kw = dict(Pout=7.0, n_directions=n_dirs, h_radius=2, v_radius=1)
    i_j, t_j = j_wta(jnp.asarray(cv), 0.3, 1.1, strategy=JES[strategy],
                     backend="xla", **kw)
    i_t, t_t = sgm_wta_truncated(torch.from_numpy(cv), 0.3, 1.1,
                                 strategy=to_port(JES[strategy]), **kw)
    sgm = j_sgm(jnp.asarray(cv), 0.3, 1.1, Pout=7.0, n_directions=n_dirs,
                strategy=JES[strategy], backend="xla")
    clear = _clear_gap(sgm, JES[strategy])
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    same = i_t == i_j
    t_j, t_t = np.asarray(t_j)[same], t_t.numpy()[same]
    np.testing.assert_array_equal(np.isnan(t_t), np.isnan(t_j))
    np.testing.assert_allclose(t_t, t_j, **TOL)


@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
def test_tie_last_wta_on_exact_ties(strategy):
    """Exact ties resolve to the LAST index, as the reference's <= / >=
    scans do; torch's argmin/argmax alone would take the first."""
    rng = np.random.default_rng(3)
    cv = rng.integers(0, 3, (9, 11, 8)).astype(np.float32)   # many ties
    want = np.asarray(j_extract(jnp.asarray(cv), JES[strategy]))
    got = extract_selected_index(torch.from_numpy(cv),
                                 to_port(JES[strategy])).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32


def test_tie_last_wta_in_the_fused_sgm_pass():
    """A constant volume with Pout = 0: every step's adj is exactly 0, so
    all disparities tie after SGM; the K3 plain version picks the last
    index, as the JAX chain does."""
    H, W, D = 7, 10, 6
    cv = np.full((H, W, D), 0.25, np.float32)
    idx, bands, _ = sgm_wta_fused(torch.from_numpy(cv), 0.1, 0.5, 0.0, 8, 1,
                                  0, 0, refine=False)
    sgm = j_sgm(jnp.asarray(cv), 0.1, 0.5, Pout=0.0, n_directions=8,
                backend="xla")
    want = np.asarray(j_extract(sgm, JES.COST))
    np.testing.assert_array_equal(want, np.full((H, W), D - 1))
    np.testing.assert_array_equal(idx.numpy(), want)
    assert (bands[..., 2] == np.inf).all() and (bands[..., :2] == 0.25).all()


@pytest.mark.parametrize("kernel", list(JInterp), ids=lambda k: k.name)
def test_refinement_matches_jax(kernel):
    rng = np.random.default_rng(4)
    tcv = rng.uniform(0.1, 2.0, (6, 7, 3)).astype(np.float32)
    tcv[0, 0, 0] = np.nan
    raw = rng.integers(0, 9, (6, 7)).astype(np.int32)
    want = np.asarray(j_refine(kernel, jnp.asarray(tcv), jnp.asarray(raw)))
    got = refine_disp_cost_interpolation(to_port(kernel),
                                         torch.from_numpy(tcv),
                                         torch.from_numpy(raw)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    c = [torch.from_numpy(tcv[..., k]) for k in range(3)]
    np.testing.assert_allclose(
        refine_cost_triplet(to_port(kernel), *c).numpy(),
        np.asarray(j_triplet(kernel, *[jnp.asarray(tcv[..., k])
                                       for k in range(3)])),
        rtol=1e-5, atol=1e-5)


def _native(func, L, R, h, v, D, Dp, pout):
    """The Pallas K1 volume in the DHW kernels' padded native layouts."""
    a = box_cost_volume_fused_padded(func, jnp.asarray(L), jnp.asarray(R),
                                     h, v, D, Dp, jnp.float32, negate=True,
                                     pout_bake=pout, interpret=True)
    return a, jnp.transpose(a, (2, 1, 0))


@pytest.mark.parametrize("n_dirs", [4, 8])
def test_k2_k3_plain_match_pallas_kernels(n_dirs):
    """The port's SGM + WTA + subpixel (the CPU branches of `sgm_pass` and
    `sgm_wta`) against `sgm_fused_wta_from_native` in interpret mode, f32,
    on the same ZNCC volume: idx away from near-ties, the NaN-masked band
    and the in-kernel parabola disparity where idx agrees."""
    H, W, D, Dp, h, v = 16, 24, 7, 8, 2, 2
    rng = np.random.default_rng(6)
    L = rng.uniform(0, 1, (H, W)).astype(np.float32)
    R = rng.uniform(0, 1, (H, W)).astype(np.float32)
    a, b = _native(JMF.ZNCC, L, R, h, v, D, Dp, 100.0)
    i_j, bands_j, disp_j = dhw.sgm_fused_wta_from_native(
        a, b, H, W, D, 0, W, 0.1, 0.5, 100.0, n_dirs, wta_radius=1,
        interpret=True, pout_baked=True, refine=(h, v))
    _, tcv_j = j_tcv_from_bands(i_j, bands_j, H, W, D, h, v, 1)
    # the port's input: the same volume, un-baked and without padding
    cv = np.moveaxis(np.asarray(a)[:H, :D, :W], 1, -1)
    out_of_range = (np.arange(W)[:, None] + np.arange(D)[None, :]) >= W
    cv = np.where(out_of_range, 0.0, cv).astype(np.float32)
    i_t, bands_t, disp_t = sgm_wta_fused(torch.from_numpy(cv), 0.1, 0.5,
                                         100.0, n_dirs, 1, h, v, refine=True)
    _, tcv_t = _tcv_from_bands(i_t, bands_t, H, W, D, h, v, 1)
    sgm = j_sgm(jnp.asarray(cv), 0.1, 0.5, Pout=100.0, n_directions=n_dirs,
                backend="xla")
    clear = _clear_gap(sgm)
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    same = i_t == i_j
    assert same.mean() > 0.99
    tj, tt = np.asarray(tcv_j)[same], tcv_t.numpy()[same]
    np.testing.assert_array_equal(np.isnan(tt), np.isnan(tj))
    np.testing.assert_allclose(tt, tj, **TOL)
    dj, dt = np.asarray(disp_j)[same], disp_t.numpy()[same]
    np.testing.assert_array_equal(np.isnan(dt), np.isnan(dj))
    f = np.isfinite(dj)
    np.testing.assert_allclose(dt[f], dj[f], **TOL)


def test_k3_wrapper_on_cpu_is_the_plain_version():
    cv = torch.from_numpy(_cv(7, (9, 12, 5)))
    acc = torch.from_numpy(_cv(8, (9, 12, 5)))
    before = (sgm_pass.launches, sgm_wta.launches)
    got = sgm_wta(cv, acc, 0.1, 0.5, 100.0, 1, 1, 1, True)
    want = sgm_wta_plain(cv, acc, 0.1, 0.5, 100.0, 1, 1, 1, True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    sgm_pass(cv, acc.clone(), SgmDirection.UP2DOWN, 0.1, 0.5, 100.0)
    assert (sgm_pass.launches, sgm_wta.launches) == before


@pytest.mark.parametrize("n_dirs", [4, 8])
def test_direction_volumes_sum_to_the_sequential_accumulator(n_dirs):
    """The WTA path's K2 form that writes one adjustment volume a direction
    (`direction_volumes`, one launch on the card); summed in direction
    order they equal `sgm_accumulate`'s accumulator bit for bit, and K3
    over the stack equals K3 over that accumulator.  Both against JAX's XLA
    SGM volume at 1e-4."""
    from libstevi_tpu_torch.ops.sgm import directions_for
    from libstevi_tpu_torch.ops.sgm_cuda import (_acc_sum, direction_volumes,
                                                 sgm_accumulate)
    cv = torch.from_numpy(_cv(9, (11, 17, 6), 3.0))
    dirs = [d for d in directions_for(n_dirs)
            if d is not SgmDirection.RIGHT2LEFT]
    before = (sgm_pass.launches, direction_volumes.launches)
    stack = direction_volumes(cv, dirs, 0.1, 0.5, 100.0)
    assert stack.shape == (len(dirs), 11, 17, 6)
    # the CPU runs the plain passes
    assert (sgm_pass.launches, direction_volumes.launches) == before
    seq = sgm_accumulate(cv, dirs, 0.1, 0.5, 100.0)
    assert torch.equal(_acc_sum(stack), seq)
    for got, want in zip(sgm_wta(cv, stack, 0.1, 0.5, 100.0, 1, 1, 1, True),
                         sgm_wta(cv, seq, 0.1, 0.5, 100.0, 1, 1, 1, True)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    want = np.asarray(j_sgm(jnp.asarray(cv.numpy()), 0.1, 0.5, Pout=100.0,
                            n_directions=n_dirs, backend="xla"))
    from libstevi_tpu_torch.ops.sgm import direction_adj
    got = cv + _acc_sum(stack) + direction_adj(cv, SgmDirection.RIGHT2LEFT,
                                              0.1, 0.5, 100.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape, one_launch", [
    ((480, 640, 120), True),         # 1.03 GB of direction volumes
    ((720, 1280, 320), True),        # 8.26 GB
    ((2160, 3840, 128), True),       # 29.7 GB
    ((2160, 3840, 320), False),      # 74.3 GB
])
def test_one_launch_form_needs_the_stack_to_fit(shape, one_launch):
    """`sgm_wta_fused`'s choice of K2 form with 80 GB free: one launch for
    the 7 directions, a volume each, where the volumes take at most half
    the free memory, else 7 launches into one accumulator."""
    from libstevi_tpu_torch.ops.sgm_cuda import one_launch_fits
    H, W, D = shape
    assert one_launch_fits(7 * H * W * D * 4, 80 * 10 ** 9) is one_launch


def test_one_launch_form_is_not_taken_on_the_cpu():
    """On the CPU `sgm_wta_fused` runs the plain accumulating form, and
    both forms give the same bits there
    (`test_direction_volumes_sum_to_the_sequential_accumulator`)."""
    from libstevi_tpu_torch.ops.sgm_cuda import _one_launch
    assert not _one_launch(torch.zeros(2, 3, 4), [SgmDirection.UP2DOWN])


def _cu_constants(name):
    """``constexpr int NAME = expr;`` of a source in csrc, evaluated."""
    import re
    from pathlib import Path
    import libstevi_tpu_torch
    src = (Path(libstevi_tpu_torch.__file__).parent / "csrc" / name
           ).read_text()
    consts = {}
    for k, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", src):
        consts[k] = eval(expr, {}, dict(consts))
    return consts


def test_pass_layout_matches_the_cuda_source():
    """`sgm_cuda.pass_layout`'s limits are its C++ twin's constants in
    csrc/sgm_scan.cu: K = 4 up to 1024, registers up to 8192, 32 warps a
    line at most, the shared instance's two carries within PASS_SMEM, and
    the ring's depth."""
    from libstevi_tpu_torch.ops import sgm_cuda as sc
    c = _cu_constants("sgm_scan.cu")
    for k in ("GROUP_K4_MAX_D", "GROUP_MAX_D", "MAX_GROUP", "PASS_SMEM",
              "BUF_MAX_D", "RING"):
        assert getattr(sc, k) == c[k], k
    assert c["REG_K"] * 32 == sc.MAX_D


def _instance(D, **kw):
    from libstevi_tpu_torch.ops.sgm_cuda import pass_layout
    return pass_layout(D, **kw)


@pytest.mark.parametrize("D,carries,K", [
    (321, "registers", 4), (1024, "registers", 4), (1025, "registers", 8),
    (8192, "registers", 8), (8193, "shared", 0), (28544, "shared", 0),
    (28545, "device", 0)])
def test_pass_layout_first_d_of_each_instance(D, carries, K):
    """The first and last D of each any-D K2 instance: registers from
    D = 321 (K = 4, then K = 8 from 1025), shared carries from 8193 (32
    warps), device carries from 28545 (r16(8 D) past PASS_SMEM)."""
    from libstevi_tpu_torch.ops.sgm_cuda import PASS_SMEM
    for elt, n_acc in ((4, 1), (4, 0), (2, 1)):
        ly = _instance(D, elt=elt, n_acc=n_acc)
        assert (ly.carries, ly.K) == (carries, K)
        assert ly.smem <= PASS_SMEM
        if carries == "shared":
            assert ly.smem == -(-8 * D // 16) * 16
        if carries == "device":
            assert ly.smem == 0 and 8 * D > PASS_SMEM


def test_pass_layout_covers_d_and_is_monotone():
    """Over D = 321 .. 30000: the registers instance's G warps of 32 K
    lanes cover D (G <= 32, K in {4, 8}, at most one warp more than
    needed), the ring is 2 to RING stages within PASS_SMEM, fewer where a
    launch has more lines; the instance, K and G never fall as D grows;
    D <= 320 is not this kernel's."""
    from libstevi_tpu_torch.ops.sgm_cuda import PASS_SMEM, RING
    order = {"registers": 0, "shared": 1, "device": 2}
    last = (0, 0, 0)
    for D in list(range(321, 2100)) + list(range(2100, 30001, 97)):
        ly = _instance(D)
        key = (order[ly.carries], ly.K, ly.G if ly.K else 32)
        assert key >= last, D
        last = key
        if ly.carries != "registers":
            continue
        assert ly.K in (4, 8) and 1 <= ly.G <= 32
        assert ly.G * 32 * ly.K >= D > (ly.G - 1) * 32 * ly.K
        assert 2 <= ly.stages <= RING and ly.smem <= PASS_SMEM
        many = _instance(D, lines=4 * 3840)
        assert 2 <= many.stages <= ly.stages
    with pytest.raises(ValueError):
        _instance(320)


def test_pass_probe_instruments_the_current_source():
    """`pass_probe` (the card's per-phase cycle counts of the any-D K2's
    registers instance) patches a copy of `csrc/sgm_scan.cu`: every anchor
    is found once, so the probe stays in step with the kernel, and 7 phase
    marks go in."""
    from libstevi_tpu_torch import pass_probe
    src = pass_probe.instrumented_source()
    assert src.count("PHASE(") == 8 and "probe_read" in src
