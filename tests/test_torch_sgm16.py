"""16-direction SGM in the port (the knight-move families, the plain
version of K2k, and the paths that run them) against the JAX package: the
XLA gather path (`_build_lines` / `_cost_mode_pass`) and the Pallas DHW
kernels in interpret mode."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import (ExtractionStrategy as JES, Margins as JMargins,
                               MatchingFunction as JMF)
from libstevi_tpu.ops import (dense_sgm_stereo as j_dense,
                              sgm_cost_volume as j_sgm,
                              sgm_wta_truncated as j_wta)
from libstevi_tpu.ops import sgm as jsgm
from libstevi_tpu.ops import sgm_pallas_dhw as dhw
from libstevi_tpu.ops.refinement import InterpolationKernel as JInterp

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import Margins
from libstevi_tpu_torch.ops import (dense_sgm_stereo, sgm_cost_volume,
                                    sgm_wta_truncated)
from libstevi_tpu_torch.ops.sgm import (SgmDirection, _KNIGHT_DIRS,
                                        _build_lines, directions_for,
                                        knight_adj)
from libstevi_tpu_torch.ops.sgm_cuda import (add_knight_volumes,
                                             knight_volumes,
                                             knight_volumes_plain,
                                             sgm_accumulate,
                                             sgm_knight_shard_pass,
                                             sgm_knight_shard_pass_plain,
                                             sgm_wta_fused)
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
P1, P2, POUT = 0.2, 0.7, 5.0

# (shape, margins): odd and even sides, tall, wide, W < D (Pout on every
# step of a short line), margins
CASES = {
    "12x15": ((12, 15, 5), (0, 0, 0, 0)),
    "13x16": ((13, 16, 4), (0, 0, 0, 0)),
    "tall_18x7": ((18, 7, 5), (0, 0, 0, 0)),
    "wide_5x21": ((5, 21, 5), (0, 0, 0, 0)),
    "w_lt_d_6x4x6": ((6, 4, 6), (0, 0, 0, 0)),
    "margins_2132": ((12, 15, 5), (2, 1, 3, 2)),
}
KNIGHTS = [pytest.param(d, id=d.name) for d in jsgm._KNIGHT_DIRS]


def _cv(seed, shape, hi=1.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(np.float32)


def _clear_gap(sgm, gap=1e-4):
    v = np.sort(np.asarray(sgm), -1)
    return (v[..., 1] - v[..., 0]) > gap


def test_knight_directions_and_steps():
    assert [d.name for d in _KNIGHT_DIRS] == \
        [d.name for d in jsgm._KNIGHT_DIRS]
    for d in SgmDirection:
        (v0, h0), (v1, h1) = d.steps
        assert d.value == ((v0, v1), (h0, h1))
        assert d.knight == (d in _KNIGHT_DIRS)
        if not d.knight:
            assert d.step == (v0, h0)
    with pytest.raises(ValueError):
        SgmDirection.UPLEFT2DOWN.step


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("jdir", KNIGHTS)
def test_build_lines_equal_jax(jdir, case):
    """The line maps (the static state the knight passes run on) equal the
    JAX package's arrays."""
    (H, W, _), m = CASES[case]
    want = jsgm._build_lines(H, W, m, jdir)
    got = _build_lines(H, W, m, to_port(jdir))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("jdir", KNIGHTS)
def test_knight_pass_matches_jax(jdir, case):
    """The knight adjustment against JAX's `_cost_mode_pass` over
    `_build_lines`, on the contiguous region inside the margins (image
    column offset and width for Pout), padded back: the line form
    (`knight_adj`, what the CPU's `sgm_cost_volume` adds) and K2k's wrapper
    (`knight_volumes`, on the CPU its plain lane form p0 + p1).  Added to a
    random accumulator once, acc + (p0 + p1), as every path adds it: the
    shard pass's plain version gives that sum bit for bit."""
    (H, W, D), m = CASES[case]
    cv = _cv(list(CASES).index(case), (H, W, D))
    want = np.asarray(jsgm._cost_mode_pass(
        jnp.asarray(cv), *jsgm._build_lines(H, W, m, jdir), P1, P2, POUT))
    ml, mt, mr, mb = m
    region = torch.from_numpy(cv[mt:H - mb, ml:W - mr]).contiguous()

    def padded(x):
        return torch.nn.functional.pad(x, (0, 0, ml, mr, mt, mb)).numpy()

    got = knight_adj(region, to_port(jdir), P1, P2, POUT, col0=ml, W_pout=W)
    np.testing.assert_allclose(padded(got), want, **TOL)
    before = knight_volumes.launches
    vol = knight_volumes(region, [to_port(jdir)], P1, P2, POUT, col0=ml,
                         W_pout=W)[0]
    assert knight_volumes.launches == before        # CPU: the plain version
    np.testing.assert_allclose(padded(vol), want, **TOL)
    acc = torch.from_numpy(_cv(99, region.shape))
    summed = acc.clone()
    sgm_knight_shard_pass_plain(region, summed, to_port(jdir), P1, P2, POUT,
                                col0=ml, W_pout=W)
    assert torch.equal(summed, acc + vol)
    np.testing.assert_allclose(padded(summed), padded(acc) + want, **TOL)


def test_k2k_wrapper_on_cpu_is_the_plain_version():
    """`knight_volumes`, `add_knight_volumes` in both forms and the shard
    pass run their plain versions on CPU tensors, with no launch; a
    principal direction and a wrong ``out`` raise."""
    cv = torch.from_numpy(_cv(3, (9, 11, 6)))
    acc = torch.from_numpy(_cv(4, (9, 11, 6)))
    before = knight_volumes.launches
    got = knight_volumes(cv, _KNIGHT_DIRS, P1, P2, POUT)
    want = knight_volumes_plain(cv, _KNIGHT_DIRS, P1, P2, POUT)
    assert got.shape == (8, 9, 11, 6) and torch.equal(got, want)
    for one_launch in (True, False):
        summed = add_knight_volumes(cv, acc.clone(), _KNIGHT_DIRS, P1, P2,
                                    POUT, one_launch=one_launch)
        ref = acc.clone()
        for v in want:
            ref.add_(v)
        assert torch.equal(summed, ref)
    for d in _KNIGHT_DIRS:
        a, a_p = acc.clone(), acc.clone()
        assert torch.equal(sgm_knight_shard_pass(cv, a, d, P1, P2, POUT),
                           sgm_knight_shard_pass_plain(cv, a_p, d, P1, P2,
                                                       POUT))
        assert torch.equal(a, a_p)
    assert knight_volumes.launches == before
    with pytest.raises(ValueError):
        knight_volumes(cv, [SgmDirection.UP2DOWN], P1, P2, POUT)
    with pytest.raises(ValueError):
        knight_volumes(cv, _KNIGHT_DIRS[:2], P1, P2, POUT, out=got[:1])


@pytest.mark.parametrize("case", [c for c in CASES if "margins" not in c])
def test_knight_volumes_summed_in_order_equal_sgm_accumulate(case):
    """16 directions through `sgm_accumulate` (the principal passes into
    one accumulator, then the knight volumes added one after another) equal
    bit for bit the principal sum plus `knight_volumes_plain`'s volumes
    added in `_KNIGHT_DIRS` order, and the shard pass's plain version
    applied direction by direction: acc + (p0 + p1), in one order on every
    path."""
    (H, W, D), _ = CASES[case]
    cv = torch.from_numpy(_cv(20 + list(CASES).index(case), (H, W, D)))
    principal = [d for d in directions_for(16) if not d.knight]
    acc = sgm_accumulate(cv, principal, P1, P2, POUT)
    got = sgm_accumulate(cv, directions_for(16), P1, P2, POUT)
    ref, seq = acc.clone(), acc.clone()
    for d, v in zip(_KNIGHT_DIRS,
                    knight_volumes_plain(cv, _KNIGHT_DIRS, P1, P2, POUT)):
        ref.add_(v)
        sgm_knight_shard_pass_plain(cv, seq, d, P1, P2, POUT)
    assert torch.equal(got, ref) and torch.equal(got, seq)


def _seed_offset(direction, si, sj, H, W):
    """A line seed's step along its direction's primary axis, from the
    start edge."""
    (v0, h0), _ = direction.steps
    if v0 != 0:
        return si if v0 > 0 else H - 1 - si
    return sj if h0 > 0 else W - 1 - sj


@pytest.mark.parametrize("shape", [(12, 15), (13, 16), (18, 7), (5, 21),
                                   (1, 6), (6, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("direction", _KNIGHT_DIRS, ids=lambda d: d.name)
def test_phase0_lines_cover_every_pixel(direction, shape):
    """The premise of K2k's volume form (no zero fill): of the lines
    `addDirectionalCost` seeds (`_build_lines`), those whose seed lies at
    an even step along the primary axis (phase 0: the start edge and the
    even side seeds) cover every pixel exactly once, the corner line
    counted once; the odd side seeds (phase 1) cover each pixel at most
    once, exactly where u <= (t - 1) // 2 (u the lateral distance from the
    side edge the lines enter from, t the step from the start edge)."""
    H, W = shape
    ii, jj, active = _build_lines(H, W, (0, 0, 0, 0), direction)
    seeds = set()
    cover = [np.zeros((H, W), int), np.zeros((H, W), int)]
    for line in range(ii.shape[0]):
        seed = (int(ii[line, 0]), int(jj[line, 0]))
        if seed in seeds:           # the corner, seeded from both edges
            continue
        seeds.add(seed)
        phase = _seed_offset(direction, *seed, H, W) % 2
        n = int(active[line].sum())
        np.add.at(cover[phase], (ii[line, :n], jj[line, :n]), 1)
    assert (cover[0] == 1).all()
    (v0, h0), (v1, h1) = direction.steps
    i, j = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    if v0 != 0:                     # vertical primary, drift along columns
        t = i if v0 > 0 else H - 1 - i
        u = j if h1 > 0 else W - 1 - j
    else:
        t = j if h0 > 0 else W - 1 - j
        u = i if v1 > 0 else H - 1 - i
    np.testing.assert_array_equal(cover[1], (u <= (t - 1) // 2).astype(int))


@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
@pytest.mark.parametrize("margins", [(0, 0, 0, 0), (2, 1, 3, 2)],
                         ids=["no_margins", "margins"])
def test_sgm_cost_volume_16_matches_xla(margins, strategy):
    cv = _cv(5, (12, 15, 5))
    want = np.asarray(j_sgm(jnp.asarray(cv), P1, P2, JMargins(*margins),
                            Pout=POUT, n_directions=16,
                            strategy=JES[strategy], backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), P1, P2, Margins(*margins),
                          Pout=POUT, n_directions=16,
                          strategy=to_port(JES[strategy])).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("margins", [(0, 0, 0, 0), (2, 1, 3, 2)],
                         ids=["no_margins", "margins"])
def test_sgm_cost_volume_16_matches_pallas_dhw(margins):
    """Against the DHW kernels that carry the knight families, in
    interpret mode (`tests/test_sgm.py:83-98`)."""
    cv = _cv(6, (10, 14, 6))
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.3, 1.1, JMargins(*margins),
                            Pout=7.0, n_directions=16, backend="pallas"))
    got = sgm_cost_volume(torch.from_numpy(cv), 0.3, 1.1, Margins(*margins),
                          Pout=7.0, n_directions=16).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shape", [(10, 14, 6), (13, 16, 4)],
                         ids=["10x14x6", "13x16x4"])
def test_sgm_accumulate_16_matches_pallas_dhw(shape):
    """The order the card runs (`sgm_accumulate`: the principal passes,
    then each knight volume p0 + p1 added once), here in its plain version,
    against the DHW kernels in interpret mode, which add all four knight
    carries of a pass to each row together."""
    cv = _cv(16, shape)
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.3, 1.1, Pout=7.0,
                            n_directions=16, backend="pallas"))
    got = torch.from_numpy(cv) + sgm_accumulate(
        torch.from_numpy(cv), directions_for(16), 0.3, 1.1, 7.0)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("margins", [(0, 0, 0, 0), (2, 1, 3, 2)],
                         ids=["no_margins", "margins"])
@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
def test_sgm_wta_truncated_16_matches_jax(strategy, margins):
    cv = _cv(7, (14, 19, 7), hi=3.0)
    kw = dict(Pout=7.0, n_directions=16, h_radius=2, v_radius=1)
    i_j, t_j = j_wta(jnp.asarray(cv), 0.3, 1.1, JMargins(*margins),
                     strategy=JES[strategy], backend="xla", **kw)
    i_t, t_t = sgm_wta_truncated(torch.from_numpy(cv), 0.3, 1.1,
                                 Margins(*margins),
                                 strategy=to_port(JES[strategy]), **kw)
    sgm = j_sgm(jnp.asarray(cv), 0.3, 1.1, JMargins(*margins), Pout=7.0,
                n_directions=16, strategy=JES[strategy], backend="xla")
    sign = 1 if strategy == "COST" else -1
    clear = _clear_gap(sign * np.asarray(sgm))
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    same = i_t == i_j
    assert same.mean() > 0.99
    t_j, t_t = np.asarray(t_j)[same], t_t.numpy()[same]
    np.testing.assert_array_equal(np.isnan(t_t), np.isnan(t_j))
    np.testing.assert_allclose(t_t, t_j, **TOL)


def test_k2_k2k_k3_plain_match_pallas_wta():
    """The port's K2 x7 -> K2k x8 -> K3 chain (the CPU branches of the
    wrappers) against `sgm_fused_wta_dhw` with 16 directions in interpret
    mode, on one volume: idx away from near-ties, bands where idx agrees."""
    H, W, D = 12, 15, 6
    cv = _cv(8, (H, W, D), hi=2.0)
    i_j, b_j = dhw.sgm_fused_wta_dhw(jnp.moveaxis(jnp.asarray(cv), -1, 1), 0,
                                     W, 0.3, 1.1, 7.0, 16, wta_radius=1,
                                     interpret=True)
    i_t, b_t, _ = sgm_wta_fused(torch.from_numpy(cv), 0.3, 1.1, 7.0, 16, 1,
                                0, 0, refine=False)
    sgm = j_sgm(jnp.asarray(cv), 0.3, 1.1, Pout=7.0, n_directions=16,
                backend="xla")
    clear = _clear_gap(sgm)
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    same = i_t == i_j
    assert same.mean() > 0.99
    bj, bt = np.asarray(b_j)[same], b_t.numpy()[same]
    fin = np.isfinite(bj)
    np.testing.assert_array_equal(np.isfinite(bt), fin)
    np.testing.assert_allclose(bt[fin], bj[fin], **TOL)


def _pair(seed, H=20, W=34):
    rng = np.random.default_rng(seed)
    L = rng.uniform(0, 1, (H, W)).astype(np.float32)
    R = np.roll(L, -3, axis=1) + rng.normal(0, 0.05, L.shape).astype(
        np.float32)
    return L, R


def _clear_dense(L, R, D):
    """Clear-gap pixels of the f32 16-direction SGM volume of the pair."""
    from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
    cv = j_box(JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), 3, 2, D)
    return _clear_gap(j_sgm(-cv, 0.1, 0.5, n_directions=16, backend="xla"))


@pytest.mark.parametrize("refine", [None, JInterp.PARABOLA],
                         ids=["none", "parabola"])
def test_dense_sgm_stereo_16_matches_jax(refine):
    L, R = _pair(9)
    D = 9
    dj, ij, tj = (np.asarray(x) for x in j_dense(
        JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), 3, 2, D, 0.1, 0.5,
        n_directions=16, refine_kernel=refine, cv_dtype=jnp.float32))
    dt, it, tt = (x.numpy() for x in dense_sgm_stereo(
        to_port(JMF.ZNCC), torch.from_numpy(L), torch.from_numpy(R), 3, 2, D,
        0.1, 0.5, n_directions=16, refine_kernel=to_port(refine)))
    clear = _clear_dense(L, R, D)
    np.testing.assert_array_equal(it[clear], ij[clear])
    same = it == ij
    assert same.mean() > 0.99
    np.testing.assert_array_equal(np.isnan(tt[same]), np.isnan(tj[same]))
    np.testing.assert_allclose(tt[same], tj[same], **TOL)
    f = same & np.isfinite(dj)
    np.testing.assert_array_equal(np.isnan(dt[same]), np.isnan(dj[same]))
    np.testing.assert_allclose(dt[f], dj[f], **TOL)


def test_bf16_request_with_16_directions_runs_f32():
    """The TPU path's rule (`libstevi_tpu/ops/sgm.py:477-478`): a bf16
    request with 16 directions builds an f32 volume, so its result equals
    the f32 run exactly, and matches JAX's f32 run."""
    L, R = _pair(10)
    D = 9
    kw = dict(n_directions=16, refine_kernel=to_port(JInterp.PARABOLA))
    args = (to_port(JMF.ZNCC), torch.from_numpy(L), torch.from_numpy(R), 3,
            2, D, 0.1, 0.5)
    f32 = dense_sgm_stereo(*args, cv_dtype=torch.float32, **kw)
    b16 = dense_sgm_stereo(*args, cv_dtype=torch.bfloat16, **kw)
    for a, b in zip(f32, b16):
        assert torch.equal(torch.nan_to_num(a, 9.0), torch.nan_to_num(b, 9.0))
    _, ij, _ = j_dense(JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), 3, 2, D,
                       0.1, 0.5, n_directions=16,
                       refine_kernel=JInterp.PARABOLA, cv_dtype=jnp.float32)
    clear = _clear_dense(L, R, D)
    np.testing.assert_array_equal(b16[1].numpy()[clear], np.asarray(ij)[clear])


def test_sgm16_entry_matches_the_bench_grid_configuration():
    """`entry.sgm16_forward` is `bench_grid.py:114-126`'s SGM16 config."""
    cfg = entry.SGM16
    assert (cfg["h_radius"], cfg["v_radius"], cfg["disp_width"]) == (3, 3, 120)
    assert (cfg["P1"], cfg["P2"], cfg["n_directions"]) == (0.1, 0.5, 16)
    assert cfg["cv_dtype"] == torch.float32
    L, R = _pair(11, 16, 28)
    got = entry.sgm16_forward(torch.from_numpy(L), torch.from_numpy(R))
    want, _, _ = dense_sgm_stereo(to_port(JMF.ZNCC), torch.from_numpy(L),
                                  torch.from_numpy(R), **cfg)
    assert got.shape == (16, 28)
    assert torch.equal(torch.nan_to_num(got, 9.0), torch.nan_to_num(want, 9.0))
