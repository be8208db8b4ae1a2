"""The lane-layout SGM kernels' plain versions (K4a, K4b, K4d in
`libstevi_tpu_torch/ops/sgm_lane_cuda.py`) against the JAX package's Pallas
kernels in interpret mode (`libstevi_tpu/ops/sgm_pallas.py`), the D > 320
slice and P2 < P1 against the JAX XLA path, and the route each SGM
configuration takes (`sgm.sgm_route`), all on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import Margins as JMargins, MatchingFunction as JMF
from libstevi_tpu.ops import dense_sgm_stereo as j_dense
from libstevi_tpu.ops import sgm_cost_volume as j_sgm
from libstevi_tpu.ops import sgm_wta_truncated as j_wta
from libstevi_tpu.ops import sgm_pallas as jp
from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
from libstevi_tpu.ops.refinement import InterpolationKernel as JInterp

from libstevi_tpu_torch.core import Margins
from libstevi_tpu_torch.ops import (dense_sgm_stereo, sgm_cost_volume,
                                    sgm_wta_truncated)
from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
from libstevi_tpu_torch.ops.sgm import sgm_route
from libstevi_tpu_torch.reference import to_port

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-4)
P1, P2, POUT = 0.3, 1.1, 7.0


def _cv(seed, shape, hi=3.0):
    return np.random.default_rng(seed).uniform(0, hi, shape).astype(
        np.float32)


def _dp_pad(x, D):
    """(..., D) -> (..., Dp) with +inf lanes, the Pallas kernels' layout."""
    Dp = jp._round_up(D, 128)
    pad = [(0, 0)] * (x.ndim - 1) + [(0, Dp - D)]
    return np.pad(x, pad, constant_values=np.inf)


@pytest.mark.parametrize("case", ["n4", "n8", "margins", "tall", "wide"])
def test_fused_adj_matches_pallas(case):
    """K4b's four passes (plain) against `sgm_fused_adj` in interpret mode,
    with the region's image column offset and width for Pout, and on a
    tall region (W < H: the reverse corner line j = i + W - H leaves the
    image for some rows)."""
    shape, n, col0, W_pout = (10, 14, 6), 8, 0, None
    if case == "n4":
        n = 4
    elif case == "margins":
        col0, W_pout = 2, 19
    elif case == "tall":
        shape = (18, 7, 5)
    elif case == "wide":
        shape = (5, 21, 5)
    cv = _cv(0, shape)
    W_pout = shape[1] + col0 if W_pout is None else W_pout
    want = jp.sgm_fused_adj(jnp.asarray(cv), col0, W_pout, P1, P2, POUT, n,
                            interpret=True)
    got = lane.fused_adj(torch.from_numpy(cv), col0, W_pout, P1, P2, POUT, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_separate_accumulation_matches_pallas():
    """Down and up each write, the two are added at the end (JAX's
    large-shape mode, forced there by a small VMEM budget)."""
    cv = _cv(1, (12, 16, 6))
    want = jp.sgm_fused_adj(jnp.asarray(cv), 0, 16, P1, P2, POUT, 8,
                            interpret=True, vmem_budget=60 * 1024)
    got = lane.fused_adj(torch.from_numpy(cv), 0, 16, P1, P2, POUT, 8,
                         separate=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    alias = lane.fused_adj(torch.from_numpy(cv), 0, 16, P1, P2, POUT, 8)
    np.testing.assert_allclose(got.numpy(), alias.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("n_dirs", [4, 8])
def test_fused_cols_wta_matches_pallas(n_dirs):
    """The last column scan fused with the tie-last WTA and the r = 1 band
    (`_make_fused_cols_wta`): idx equal, bands within 1e-4 on the slots
    inside [0, D) (the others are never read)."""
    cv = _cv(2, (10, 14, 6))
    i_j, b_j = jp.sgm_fused_adj(jnp.asarray(cv), 0, 14, P1, P2, POUT, n_dirs,
                                interpret=True, wta_radius=1)
    i_t, b_t = lane.fused_adj(torch.from_numpy(cv), 0, 14, P1, P2, POUT,
                              n_dirs, wta_radius=1)
    i_j, i_t = np.asarray(i_j), i_t.numpy()
    np.testing.assert_array_equal(i_t, i_j)
    p = i_t[..., None] + np.arange(-1, 2)
    ok = (p >= 0) & (p < 6)
    np.testing.assert_allclose(b_t.numpy()[ok], np.asarray(b_j)[ok], **TOL)


@pytest.mark.parametrize("reverse,shift_down,vertical,accumulate", [
    (False, True, True, False), (True, True, True, True),
    (False, False, False, True), (True, False, False, False)],
    ids=["SE", "NE", "SW", "NW"])
def test_chunked_pass_matches_pallas(reverse, shift_down, vertical,
                                     accumulate):
    """One K4d chunk (`chunked_pass_plain`, the per-chunk form that K4d's
    sweep-level plain version chains) against `_chunked_pass`: a random
    history in, the boundary column's carries out, the corner line inside
    the chunk."""
    H, W, D, c0, Wc = 9, 20, 6, 5, 7
    cv = _cv(3, (H, W, D))
    acc = _cv(4, (H, W, D))
    hist = _cv(5, (H, D))
    corner = (c0 + 2, 1) if shift_down else (c0 + Wc + 3, -1)
    kw = dict(reverse=reverse, shift_down=shift_down, corner_c0=corner[0],
              corner_slope=corner[1], with_vertical=vertical, with_diag=True)
    chunk = _dp_pad(cv[:, c0:c0 + Wc], D)
    a_j = _dp_pad(acc[:, c0:c0 + Wc], D) if accumulate else None
    out_j, hout_j = jp._chunked_pass(
        jnp.asarray(chunk), None if a_j is None else jnp.asarray(a_j),
        jnp.asarray(_dp_pad(hist, D)), H1=H, Wc=Wc, c0=c0, ml=1, W_pout=W + 1,
        P1=P1, P2=P2, Pout=POUT, rc=1, interpret=True, **kw)
    adj = torch.from_numpy(acc.copy())
    hout = lane.chunked_pass_plain(
        torch.from_numpy(cv), adj, torch.from_numpy(hist), c0, Wc, col0=1,
        W_pout=W + 1, P1=P1, P2=P2, Pout=POUT, accumulate=accumulate, **kw)
    np.testing.assert_allclose(adj.numpy()[:, c0:c0 + Wc],
                               np.asarray(out_j)[..., :D], **TOL)
    np.testing.assert_allclose(hout.numpy(), np.asarray(hout_j)[:, :D], **TOL)
    np.testing.assert_array_equal(adj.numpy()[:, :c0], acc[:, :c0])


@pytest.mark.parametrize("n_dirs,cw", [(8, 16), (8, 8), (4, 8), (8, 1),
                                       (8, 7), (8, 40), (4, 3), (8, None)])
def test_chunked_adj_matches_pallas(n_dirs, cw):
    """K4d's four chunked sweeps and K4b's column scans (plain), forced
    chunk widths from 1 to the whole width, and the card's rule (None: one
    column a chunk at this width, 40 chunks), against `sgm_chunked_adj`
    (and so the XLA groups)."""
    cv = _cv(6, (12, 40, 6))
    want = jp.sgm_chunked_adj(jnp.asarray(cv), 0, 40, P1, P2, POUT, n_dirs,
                              interpret=True, cw_target=cw or 8)
    got = lane.chunked_adj(torch.from_numpy(cv), 0, 40, P1, P2, POUT, n_dirs,
                           cw=cw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_dirs", [4, 8])
def test_chunked_adj_wta_matches_pallas(n_dirs):
    """K4d's route ending in K4b's WTA column scan (`chunked_adj(...,
    wta_radius=1)`, as `sgm_wta_truncated` runs it without margins)
    against the tie-last argmin and band of cv + `sgm_chunked_adj`: idx
    equal off near-ties, the band slots inside [0, D) within 1e-4 where
    idx agrees."""
    cv = _cv(23, (12, 40, 6))
    sgm = cv + np.asarray(jp.sgm_chunked_adj(
        jnp.asarray(cv), 0, 40, P1, P2, POUT, n_dirs, interpret=True,
        cw_target=8))
    idx, bands = (x.numpy() for x in lane.chunked_adj(
        torch.from_numpy(cv), 0, 40, P1, P2, POUT, n_dirs, cw=7,
        wta_radius=1))
    want = 5 - np.argmin(sgm[..., ::-1], -1)          # ties: the last index
    two = np.sort(sgm, -1)[..., :2]
    clear = (two[..., 1] - two[..., 0]) > 1e-4
    np.testing.assert_array_equal(idx[clear], want[clear])
    same = idx == want
    assert same.mean() > 0.99
    p = idx[..., None] + np.arange(-1, 2)
    ok = same[..., None] & (p >= 0) & (p < 6)
    ref = np.take_along_axis(sgm, np.clip(p, 0, 5), -1)
    np.testing.assert_allclose(bands[ok], ref[ok], **TOL)


@pytest.mark.parametrize("sweep", ["SE", "NE", "SW", "NW"])
@pytest.mark.parametrize("W,cw", [(40, 1), (40, 7), (40, 37), (40, 40),
                                  (300, 2)])
def test_chunked_sweep_plain_equals_chunk_chain(W, cw, sweep):
    """K4d's sweep-level plain version (`chunked_sweep`, plain on the CPU:
    the reference of the card's one-launch sweep) against the per-chunk
    plain version chained by hand in the flow's order, and against one
    chunk of the whole width: equal bit for bit at chunk widths 1, 7, 37
    and W, and with more chunks than an H100 has SMs (W = 300 at 2
    columns: 150 chunks).  The bits do not depend on the chunk width, which
    the card's rule (`chunk_width`) picks."""
    H, D = 6, 9
    cv = torch.from_numpy(_cv(20, (H, W, D)))
    acc = torch.from_numpy(_cv(21, (H, W, D)))
    # the first sweep of `chunked_adj` writes, the later ones add
    kw = dict(lane.chunk_sweeps(H, W, 8)[sweep], col0=2, W_pout=W + 3,
              P1=P1, P2=P2, Pout=POUT, accumulate=sweep != "SE")
    reverse, shift_down = kw["reverse"], kw["shift_down"]
    got = lane.chunked_sweep(cv, acc.clone(), cw=cw, **kw)
    want = acc.clone()
    n_w = -(-W // cw)
    hist = torch.zeros(H, D)
    for w in (range(n_w) if shift_down else reversed(range(n_w))):
        hout = lane.chunked_pass_plain(cv, want, hist, w * cw,
                                       min(cw, W - w * cw), **kw)
        # row i continues the upstream's carry of scan row i -+ 1
        hist = torch.roll(hout, -1 if reverse else 1, 0)
        hist[-1 if reverse else 0] = 0.0
    assert torch.equal(got, want)
    assert torch.equal(got, lane.chunked_sweep_plain(cv, acc.clone(), cw=W,
                                                     **kw))


@pytest.mark.parametrize("n_dirs,shape", [(8, (2, 3, 12000)),
                                          (16, (2, 3, 12000)),
                                          (4, (1, 9, 30000)),
                                          (4, (3, 2, 30000))])
def test_past_the_lane_kernels_matches_jax(n_dirs, shape):
    """Past the D whose carries fit a block's shared memory (here K4d's
    one-column chunk; 16 directions also K2k's any-D ring, 4 the WTA
    column scan's), the lane route still runs on either device, each
    kernel with its carries in global memory (`chunk_layout`,
    `cols_spills`, `sgm_cuda.ring_fits`), as JAX's XLA path takes any D:
    `sgm_cost_volume` within 1e-4 of JAX's, and `sgm_wta_truncated`'s
    indices equal off near-ties with the truncated volume within 1e-4
    where they agree.  Both raised NotImplementedError ("no chunk column")
    before the route took any D."""
    D = shape[-1]
    assert sgm_route(D, n_dirs, P1, P2, True) == "lane"
    assert sgm_route(D, n_dirs, P1, P2, False) == "lane"
    assert not lane.fused_fits(shape[1], D, n_dirs)
    assert lane.chunk_layout(D, lane.chunk_width(D, n_dirs, shape[1]), True,
                             n_dirs >= 8).spill
    cv = _cv(22, shape)
    want = np.asarray(j_sgm(jnp.asarray(cv), P1, P2, Pout=POUT,
                            n_directions=n_dirs, backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), P1, P2, Pout=POUT,
                          n_directions=n_dirs).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    kw = dict(Pout=POUT, n_directions=n_dirs)
    i_j, t_j = (np.asarray(x) for x in j_wta(jnp.asarray(cv), P1, P2,
                                             backend="xla", **kw))
    i_t, t_t = (x.numpy() for x in sgm_wta_truncated(torch.from_numpy(cv),
                                                     P1, P2, **kw))
    two = np.sort(want, -1)[..., :2]
    clear = (two[..., 1] - two[..., 0]) > 1e-4
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    same = i_t == i_j
    np.testing.assert_allclose(t_t[same], t_j[same], equal_nan=True, **TOL)


@pytest.mark.parametrize("D,n_dirs,spill", [
    (11622, 8, False), (11623, 8, True),
    (9640, 16, False), (9641, 16, True),
    (14460, 4, False), (14461, 4, True),
])
def test_sgm_route_at_the_lane_limits(D, n_dirs, spill):
    """At each kernel's shared-memory limit `sgm_route` keeps the lane
    route, alike on both devices, and the kernel's own pure layout
    function moves its carries to global memory just past it: 8
    directions past K4d's one-column chunk (D = 11622), 16 past K2k's
    any-D ring (9640), 4 past the WTA column scan (14460; K4d's
    vertical-only chunk would take 29056)."""
    from libstevi_tpu_torch.ops.sgm_cuda import ring_fits
    for cuda in (False, True):
        assert sgm_route(D, n_dirs, 0.1, 0.5, cuda) == "lane"
    k4d = lane.chunk_layout(D, lane.chunk_width(D, n_dirs), True,
                            n_dirs >= 8)
    cols = lane.cols_spills(D, True)
    if n_dirs == 8:
        assert lane.chunk_width(D, 8) == 1
        assert k4d.spill is spill and not cols
    elif n_dirs == 16:
        assert ring_fits(D) is not spill
        assert not k4d.spill and not cols
    else:
        # K4b's rows take it at W <= 132, so only the scan's own layout
        # keeps it off the card's cudaErrorInvalidValue
        assert lane.fused_fits(132, D, 4) and not k4d.spill
        assert cols is spill
        assert (lane.cols_layout(1, D, 0, True).smem == 0) is spill
        assert not lane.cols_spills(D, False)


def test_lane_limit_functions():
    """The layouts' shared-memory limits: K4d's chunk (one column at D =
    11622 with the diagonal, 29056 without, then a chunk of the same width
    in global memory), the column scans (the WTA scan's area to 14460, the
    plain one's to 28924; `cols_layout(100, 14500, 0, True)` puts its
    232064 bytes in global memory), K2k's any-D ring (9640 in f32), and
    K4d's chunk width filling the card at 4K UHD (30 columns, 128 chunks)
    but never past what the carries allow, and past them at any D."""
    from libstevi_tpu_torch.ops.sgm_cuda import ring_fits
    assert lane.chunk_width(11622) == 1 and lane.chunk_width(11623) == 1
    assert not lane.chunk_layout(11622, 1, True, True).spill
    assert lane.chunk_layout(11623, 1, True, True).spill
    assert lane.chunk_width(29056, 4) == 1
    assert not lane.chunk_layout(29056, 1, True, False).spill
    assert lane.chunk_layout(29057, 1, True, False).spill
    assert not lane.cols_spills(14460, True)
    assert lane.cols_spills(14461, True)
    assert not lane.cols_spills(28924, False)
    assert lane.cols_spills(28925, False)
    assert lane.cols_area(14500, True) == 232064
    assert lane.cols_layout(100, 14500, 0, True) == (4, 0, 0)
    assert ring_fits(9640) and not ring_fits(9641)
    assert lane.chunk_width(384, 8, 3840) == 30
    assert lane.chunk_width(384, 8, 640) == 5
    assert lane.chunk_width(800, 8, 3000) == 17        # 177 chunks
    assert lane.chunk_width(12000, 8, 3840) == 30      # global carries
    lay = lane.chunk_layout(384, 30, True, True)
    assert not lay.spill and lay.area <= lane.SMEM_BLOCK
    assert lane.chunk_layout(384, 38, True, True).spill


def test_uhd_entry_at_full_width_matches_jax():
    """The 4K UHD entry (`entry.uhd_wide_forward`: ZNCC 7x7, D = 384, f32,
    SGM-8, parabola) at its full width 3840, 8 rows: K4b's carries do not
    fit (`fused_fits`), so the lane route runs K4d's sweeps with the card's
    chunk width and the WTA column scan (plain on the CPU), against JAX's
    `dense_sgm_stereo` on its XLA path: idx equal off near-ties, the band
    and the parabola disparity within 1e-4 where idx agrees."""
    from libstevi_tpu_torch import entry
    H, W, D = 8, entry.UHD_WIDTH, entry.WIDE["disp_width"]
    assert sgm_route(D, 8, 0.1, 0.5, True) == "lane"
    assert not lane.fused_fits(W, D, 8)
    rng = np.random.default_rng(24)
    L = rng.uniform(0, 1, (H, W)).astype(np.float32)
    R = rng.uniform(0, 1, (H, W)).astype(np.float32)
    args = (3, 3, D, 0.1, 0.5)
    dj, ij, tj = (np.asarray(x) for x in j_dense(
        JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), *args, backend="xla",
        n_directions=8, refine_kernel=JInterp.PARABOLA))
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    dt, it, tt = (x.numpy() for x in dense_sgm_stereo(
        to_port(JMF.ZNCC), Lt, Rt, **entry.WIDE))
    assert np.array_equal(entry.uhd_wide_forward(Lt, Rt).numpy(), dt,
                          equal_nan=True)
    sgm = np.sort(np.asarray(j_sgm(-j_box(JMF.ZNCC, jnp.asarray(L),
                                          jnp.asarray(R), 3, 3, D),
                                   0.1, 0.5, n_directions=8,
                                   backend="xla")), -1)
    clear = (sgm[..., 1] - sgm[..., 0]) > 1e-4
    np.testing.assert_array_equal(it[clear], ij[clear])
    same = it == ij
    assert same.mean() > 0.99
    np.testing.assert_array_equal(np.isnan(tt[same]), np.isnan(tj[same]))
    np.testing.assert_allclose(tt[same], tj[same], **TOL)
    f = np.isfinite(dj) & same
    np.testing.assert_allclose(dt[f], dj[f], **TOL)


@pytest.mark.parametrize("neg", [False, True])
def test_shear_matches_pallas(neg):
    """K4a (plain) behind shear / unshear against `pallas_shear` /
    `pallas_unshear`: equal, and the round trip gives the input back."""
    H, W, D = 10, 14, 5
    cv = _dp_pad(_cv(7, (H, W, D)), D)
    S_j = jp.pallas_shear(jnp.asarray(cv), H, W, neg=neg)
    S_t = lane.shear(torch.from_numpy(cv), neg)
    np.testing.assert_array_equal(S_t.numpy(), np.asarray(S_j))
    back = lane.unshear(S_t, W, neg)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jp.pallas_unshear(S_j, H, W, neg=neg)))
    np.testing.assert_array_equal(back.numpy(), cv)


def test_dense_sgm_stereo_past_d320_matches_jax():
    """The D > 320 slice as a whole (K1 over d-slices, K4b passes and WTA,
    plain on the CPU) against JAX's XLA path: idx equal off near-ties, the
    band and the parabola disparity within 1e-4 where idx agrees."""
    H, W, D, h, v = 12, 360, 330, 3, 3
    rng = np.random.default_rng(8)
    L = rng.uniform(0, 1, (H, W)).astype(np.float32)
    R = rng.uniform(0, 1, (H, W)).astype(np.float32)
    args = (h, v, D, 0.1, 0.5)
    kw = dict(n_directions=8, refine_kernel=JInterp.PARABOLA)
    dj, ij, tj = (np.asarray(x) for x in j_dense(
        JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), *args, backend="xla", **kw))
    dt, it, tt = (x.numpy() for x in dense_sgm_stereo(
        to_port(JMF.ZNCC), torch.from_numpy(L), torch.from_numpy(R), *args,
        n_directions=8, refine_kernel=to_port(JInterp.PARABOLA)))
    sgm = np.sort(np.asarray(j_sgm(-j_box(JMF.ZNCC, jnp.asarray(L),
                                          jnp.asarray(R), h, v, D),
                                   0.1, 0.5, n_directions=8,
                                   backend="xla")), -1)
    clear = (sgm[..., 1] - sgm[..., 0]) > 1e-4
    np.testing.assert_array_equal(it[clear], ij[clear])
    same = it == ij
    assert same.mean() > 0.99
    np.testing.assert_array_equal(np.isnan(tt[same]), np.isnan(tj[same]))
    np.testing.assert_allclose(tt[same], tj[same], **TOL)
    f = np.isfinite(dj) & same
    np.testing.assert_allclose(dt[f], dj[f], **TOL)


@pytest.mark.parametrize("route", ["fused", "chunked"])
def test_sgm_entries_past_d320_match_xla(route, monkeypatch):
    """`sgm_cost_volume` with margins and `sgm_wta_truncated` at D > 320
    against the XLA path: K4b, or K4d where a card with less shared memory
    per block (8000 bytes: one 1-column chunk) refuses K4b's carries."""
    cv = _cv(9, (5, 9, 324))
    if route == "chunked":
        monkeypatch.setattr(lane, "SMEM_BLOCK", 8000)
    assert sgm_route(324, 8, P1, P2, True) == "lane"
    region = torch.from_numpy(cv)[1:, 2:8]
    fits = lane.fused_adj(region, 2, 9, P1, P2, POUT, 8) is not None
    assert fits == (route == "fused")
    m = (2, 1, 1, 0)
    want = np.asarray(j_sgm(jnp.asarray(cv), P1, P2, JMargins(*m), Pout=POUT,
                            n_directions=8, backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), P1, P2, Margins(*m),
                          Pout=POUT, n_directions=8).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    adj = (lane.fused_adj(region, 2, 9, P1, P2, POUT, 8) if route == "fused"
           else lane.chunked_adj(region, 2, 9, P1, P2, POUT, 8))
    np.testing.assert_allclose(region.numpy() + adj.numpy(), want[1:, 2:8],
                               **TOL)
    kw = dict(Pout=POUT, n_directions=8, h_radius=1, v_radius=1)
    i_j, t_j = (np.asarray(x) for x in j_wta(jnp.asarray(cv), P1, P2,
                                             backend="xla", **kw))
    i_t, t_t = (x.numpy() for x in sgm_wta_truncated(torch.from_numpy(cv),
                                                     P1, P2, **kw))
    full = np.sort(np.asarray(j_sgm(jnp.asarray(cv), P1, P2, Pout=POUT,
                                    n_directions=8, backend="xla")), -1)
    clear = (full[..., 1] - full[..., 0]) > 1e-4
    np.testing.assert_array_equal(i_t[clear], i_j[clear])
    same = i_t == i_j
    np.testing.assert_array_equal(np.isnan(t_t[same]), np.isnan(t_j[same]))
    np.testing.assert_allclose(t_t[same], t_j[same], **TOL)


@pytest.mark.parametrize("n_dirs", [8, 16])
def test_p2_below_p1_matches_jax(n_dirs):
    """P2 < P1 (the dense D x D penalty step, no kernel) through
    `dense_sgm_stereo` against the JAX XLA path."""
    rng = np.random.default_rng(10)
    L = rng.uniform(0, 1, (10, 14)).astype(np.float32)
    R = rng.uniform(0, 1, (10, 14)).astype(np.float32)
    args = (2, 2, 4, 0.5, 0.1)
    _, ij, tj = (np.asarray(x) for x in j_dense(
        JMF.ZNCC, jnp.asarray(L), jnp.asarray(R), *args, backend="xla",
        n_directions=n_dirs))
    _, it, tt = (x.numpy() for x in dense_sgm_stereo(
        to_port(JMF.ZNCC), torch.from_numpy(L), torch.from_numpy(R), *args,
        n_directions=n_dirs))
    same = it == ij
    assert same.mean() > 0.99
    np.testing.assert_allclose(tt[same], tj[same], **TOL)


@pytest.mark.parametrize("D,n_dirs,p1,p2,W,cuda,budget,want", [
    (120, 8, 0.1, 0.5, 640, True, None, "scan"),
    (320, 16, 0.1, 0.5, 1280, True, None, "scan"),
    (384, 8, 0.1, 0.5, 640, True, None, "fused"),
    (640, 8, 0.1, 0.5, 1280, True, None, "fused"),
    (640, 8, 0.1, 0.5, 1280, True, 100_000, "chunked"),
    (640, 4, 0.1, 0.5, 1280, True, 100_000, "fused"),
    (384, 8, 0.1, 0.5, 3840, True, None, "chunked"),
    (384, 16, 0.5, 0.1, 640, True, None, "dense"),
    (24, 8, 0.5, 0.1, 96, True, None, "dense"),
    (384, 16, 0.1, 0.5, 640, False, None, "fused"),
])
def test_sgm_route(D, n_dirs, p1, p2, W, cuda, budget, want):
    """Which engine each configuration takes, decided without a device
    (as JAX's `test_fused_dispatch_falls_back_when_carries_exceed_vmem`):
    `sgm_route` picks the lane route by configuration, and inside it K4b's
    fit rule (`fused_adj`'s None) picks K4d.  480x640 D=384 and 720x1280
    D=640 fit K4b's carries on an H100 (48 and 155 KiB a block); a 4K-wide
    frame or a smaller budget takes K4d."""
    route = sgm_route(D, n_dirs, p1, p2, cuda)
    if route == "lane":
        route = ("fused" if lane.fused_fits(W, D, n_dirs, budget)
                 else "chunked")
    assert route == want


def test_sixteen_directions_past_d320_raise_on_cuda_only():
    """16 directions past D = 320 once raised for a CUDA tensor (K2k kept D
    in registers), and later in the distributed engine.  They take the
    lane route on both devices now, with K2k's any-D instance for the
    knights, and the distributed engine relays them
    (`parallel.sgm_dist.distributed_sgm_routed`: K4c, then the knights
    through K2s): both against JAX's XLA path at 1e-4."""
    from libstevi_tpu_torch.parallel.sgm_dist import distributed_sgm_routed
    assert sgm_route(384, 16, 0.1, 0.5, True) == "lane"
    assert sgm_route(384, 16, 0.1, 0.5, False) == "lane"
    cv = _cv(11, (4, 5, 330))
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.1, 0.5, Pout=100.0,
                            n_directions=16, backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), 0.1, 0.5,
                          n_directions=16)                  # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = torch.cat(distributed_sgm_routed(
        list(torch.from_numpy(cv).split(2)), 0.1, 0.5, n_directions=16))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("route", ["fused", "chunked"])
def test_sixteen_directions_d330_match_jax(monkeypatch, route):
    """The 16-direction lane route at D = 330 (K4b, or K4d, with the knight
    passes before the last column scan) against JAX's XLA path: the volume
    at 1e-4, and `sgm_wta_truncated`'s WTA (knights in the accumulator
    before the WTA scan) off near-ties."""
    cv = _cv(13, (9, 14, 330))
    if route == "chunked":
        monkeypatch.setattr(lane, "SMEM_BLOCK", 8000)
    assert (lane.fused_adj(torch.from_numpy(cv), 0, 14, P1, P2, POUT, 16)
            is not None) == (route == "fused")
    want = np.asarray(j_sgm(jnp.asarray(cv), P1, P2, Pout=POUT,
                            n_directions=16, backend="xla"))
    got = sgm_cost_volume(torch.from_numpy(cv), P1, P2, Pout=POUT,
                          n_directions=16).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    ij, tj = j_wta(jnp.asarray(cv), P1, P2, Pout=POUT, n_directions=16,
                   h_radius=1, v_radius=1, backend="xla")
    it, tt = sgm_wta_truncated(torch.from_numpy(cv), P1, P2, Pout=POUT,
                               n_directions=16, h_radius=1, v_radius=1)
    ij, tj, it, tt = (np.asarray(ij), np.asarray(tj), it.numpy(), tt.numpy())
    two = np.sort(want, -1)[..., :2]
    clear = (two[..., 1] - two[..., 0]) > 1e-3
    np.testing.assert_array_equal(it[clear], ij[clear])
    same = it == ij
    np.testing.assert_allclose(tt[same], tj[same], equal_nan=True, **TOL)


def test_fused_adj_returns_none_past_its_budget():
    cv = torch.zeros(4, 20, 9)
    assert lane.fused_adj(cv, 0, 20, 0.1, 0.5, 100.0, 8, budget=1) is None
    assert not lane.fused_fits(2048, 640, 8)
    assert lane.fused_fits(640, 384, 8) and lane.fused_fits(1280, 640, 8)
    assert lane.chunk_width(640) == 22 and lane.chunk_width(384) == 37
    with pytest.raises(ValueError):
        lane.fused_adj(cv, 0, 20, 0.1, 0.5, 100.0, 8, wta_radius=1,
                       separate=True)


@pytest.mark.parametrize("wta", [False, True])
@pytest.mark.parametrize("n", [0, 1, 8])
def test_cols_knight_stack_equals_in_place_adds(n, wta):
    """The last column scan's plain version with a stack of n knight
    volumes (summed as the scan reads them) against the n in-place adds
    followed by the scan without a stack: equal bit for bit, for the plain
    reverse scan and for the WTA scan."""
    H, W, D = 6, 11, 37
    g = torch.Generator().manual_seed(n)
    cv = torch.rand((H, W, D), generator=g) * 3
    acc = torch.rand((H, W, D), generator=g)
    knights = torch.rand((n, H, W, D), generator=g) if n else None
    kw = dict(col0=2, W_pout=W + 4, P1=P1, P2=P2, Pout=POUT)
    summed = acc.clone()
    for k in (knights if n else []):
        summed.add_(k)
    if wta:
        want = lane.fused_cols_wta_plain(cv, summed, 1, **kw)
        got = lane.fused_cols_wta(cv, acc, 1, knights=knights, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        want = lane.fused_cols_pass_plain(cv, summed, True, **kw)
        got = lane.fused_cols_pass(cv, acc.clone(), True, knights=knights,
                                   **kw)
        assert torch.equal(got, want)


def test_sixteen_directions_stack_form_matches_jax():
    """The 16-direction lane route with the knight volumes as a stack that
    the last scan sums (`fused_adj(..., one_launch=True)`, the card's form
    where the 8 volumes fit) against JAX's XLA path at 1e-4, and against
    the in-place form bit for bit; its WTA scan gives the in-place form's
    idx and bands."""
    cv = _cv(14, (9, 14, 330))
    t = torch.from_numpy(cv)
    stack = lane.fused_adj(t, 0, 14, P1, P2, POUT, 16, one_launch=True)
    in_place = lane.fused_adj(t, 0, 14, P1, P2, POUT, 16, one_launch=False)
    assert torch.equal(stack, in_place)
    want = np.asarray(j_sgm(jnp.asarray(cv), P1, P2, Pout=POUT,
                            n_directions=16, backend="xla"))
    np.testing.assert_allclose(cv + stack.numpy(), want, **TOL)
    for a, b in zip(lane.fused_adj(t, 0, 14, P1, P2, POUT, 16, wta_radius=1,
                                   one_launch=True),
                    lane.fused_adj(t, 0, 14, P1, P2, POUT, 16, wta_radius=1,
                                   one_launch=False)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("W,D,acc,want", [
    # 480x640 D=384: 5 columns a block, 4 parts of 3 slices a column (20
    # warps), 8 stages of cv and acc slabs
    (640, 384, True, (5, 4, 8, True, True, 172880)),
    (640, 384, False, (5, 4, 8, False, True, 111312)),
    # 720x1280 D=640: the carries take 155 KiB; 2 cv stages, acc loaded
    (1280, 640, True, (10, 2, 2, False, True, 210464)),
    (1280, 640, False, (10, 2, 2, False, True, 210464)),
    # 1280 wide at D=900: the carries fit, no stage does (direct loads)
    (1280, 900, True, (10, 2, 0, False, True, 223696)),
    # a ragged width, 11 parts of one slice (D = 333)
    (101, 333, True, (1, 11, 8, True, True, 32912)),
])
def test_row_layout(W, D, acc, want):
    """K4b's row-sweep layout (`row_layout`) is a pure function of the
    geometry: parts a column, ring stages and bytes at the shapes the
    main paths give it, and a geometry where no ring stage fits."""
    got = lane.row_layout(W, D, 8, acc)
    assert tuple(got) == want and lane.row_layout(W, D, 8, acc) == got
    assert got.smem <= lane.SMEM_BLOCK


def test_row_layout_budget_and_column_layout():
    """A budget of just the fit rule's bytes forces the direct-load
    instance with one part and no stored minima; past the rule there is no
    layout.  The column scans' layout (`cols_layout`): 4 warps a line, 8
    stages at 480x640x384, 3 with the 8 knight vectors, 2 at 720x1280x640
    with them, 0 where not one stage fits."""
    rule = (2 * 3 + 2) * 333 * 4
    assert tuple(lane.row_layout(101, 333, 8, True, budget=rule)) == \
        (1, 1, 0, False, False, rule)
    assert lane.row_layout(101, 333, 8, True, budget=rule - 4) is None
    assert lane.row_layout(3840, 384, 8, True) is None
    assert tuple(lane.cols_layout(480, 384, 0, False)) == (4, 8, 27936)
    assert tuple(lane.cols_layout(480, 384, 8, True)) == (4, 3, 52768)
    assert tuple(lane.cols_layout(720, 640, 8, True)) == (4, 2, 61824)
    assert tuple(lane.cols_layout(720, 640, 0, False)) == (4, 6, 36064)
    assert lane.cols_layout(480, 5800, 8, True).stages == 0
    assert lane.cols_layout(480, 5, 0, True).parts == 1


@pytest.mark.parametrize("H,W,D,n_dirs,want", [
    (480, 640, 384, 8, True), (720, 1280, 640, 8, True),
    (720, 1280, 900, 8, True), (720, 1280, 950, 8, False),
    (2160, 3840, 384, 8, False), (2160, 3840, 384, 4, True),
])
def test_fused_fits_unchanged(H, W, D, n_dirs, want):
    """The K4b / K4d rule is what it was: (2 * 3 * ceil(W / 132) + 2) * D
    * 4 bytes within 227 KiB (2 * ceil(W / 132) * D * 4 for 4
    directions)."""
    assert lane.fused_fits(W, D, n_dirs) is want


def test_lane_probe_instruments_the_current_source():
    """`lane_probe` (the card's per-phase cycle counts of K4b / K4c) patches
    a copy of `csrc/sgm_lane.cu`: every anchor is found once, so the probe
    stays in step with the kernels, and 12 phase marks go in (6 in the row
    sweep, 6 in the column scans)."""
    from libstevi_tpu_torch import lane_probe
    src = lane_probe.instrumented_source()
    assert src.count("PHASE(") == 13 and "probe_read" in src
