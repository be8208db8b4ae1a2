"""The port's 1-D cost-volume engine against the JAX package: `aggregate_cost`
(the shifted-compare loop and K5's plain version against the JAX scan and
the Pallas K5 kernel in interpret mode), the unfold route of
`unfold_based_cost_volume` and the SSD / ZSSD / SAD box family."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF, DispDirection as JDir
from libstevi_tpu.core.search import SearchOffset1 as JSearch1
from libstevi_tpu.core.search import SearchOffset2 as JSearch2
from libstevi_tpu.core.types import MATCH_TRAITS as J_TRAITS
from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
from libstevi_tpu.ops.cost_volume import (
    aggregate_cost as j_aggregate, normalize_feature_volume as j_norm,
    unfold_based_cost_volume as j_unfold_cv,
    extract_selected_index as j_wta)
from libstevi_tpu.ops.fv_backend import fused_fv_cost_volume as j_fused

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core.search import SearchOffset1, SearchOffset2
from libstevi_tpu_torch.ops import (aggregate_cost, box_cost_volume,
                                    extract_selected_index,
                                    normalize_feature_volume,
                                    unfold_based_cost_volume)
from libstevi_tpu_torch.ops.fv_backend import (fused_fv_cost_volume,
                                               fused_fv_cost_volume_plain)
from libstevi_tpu_torch.reference import to_port
from libstevi_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
BOX_TOL = dict(rtol=1e-4, atol=1e-4)
SEARCHES = {"width": (7, 7), "offset": (JSearch1(-2, 6), SearchOffset1(-2, 6))}
FUSABLE = {"dot": "ZNCC", "ssd": "SSD", "sad": "ZSAD"}


def _fvs(seed, shape=(10, 17, 5)):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def _normalized(func, fl, fr):
    jl, jr = (j_norm(func, jnp.asarray(x)) for x in (fl, fr))
    tl, tr = (normalize_feature_volume(to_port(func), torch.from_numpy(x))
              for x in (fl, fr))
    return (jl, jr), (tl, tr)


@pytest.mark.parametrize("backend", ["scan", "fused"])
@pytest.mark.parametrize("search", list(SEARCHES))
@pytest.mark.parametrize("direction", ["RIGHT_TO_LEFT", "LEFT_TO_RIGHT"])
@pytest.mark.parametrize("kernel", list(FUSABLE))
def test_aggregate_cost_matches_jax(kernel, direction, search, backend):
    """The port's plain aggregate (the loop for 'scan', K5's plain version
    for 'fused') against the JAX scan and the JAX Pallas K5 kernel run in
    interpret mode."""
    func = JMF[FUSABLE[kernel]]
    (jl, jr), (tl, tr) = _normalized(func, *_fvs(1))
    js, ts = SEARCHES[search]
    want = np.asarray(j_aggregate(func, jl, jr, js, JDir[direction],
                                  backend=backend))
    got = aggregate_cost(to_port(func), tl, tr, ts,
                         to_port(JDir[direction]), backend=backend).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("func", ["MEDAD", "ZMEDAD", "CENSUS", "HAMMING",
                                  "KERMI"])
def test_aggregate_cost_loop_only_functions_match_jax(func):
    f = JMF[func]
    (jl, jr), (tl, tr) = _normalized(f, *_fvs(2, (8, 13, 9)))
    want = np.asarray(j_aggregate(f, jl, jr, JSearch1(-1, 5)))
    got = aggregate_cost(to_port(f), tl, tr, SearchOffset1(-1, 5)).numpy()
    if J_TRAITS[f].census:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("layout", ["hwd", "dhw"])
@pytest.mark.parametrize("shifts", [[0, 1, 2, 3, 4], [0, -1, -2, -3],
                                    [-3, 5, 1, 9]], ids=["r2l", "l2r", "any"])
def test_k5_plain_matches_pallas_kernel(shifts, layout):
    """K5's plain version against the Pallas kernel in interpret mode, on a
    19-feature (RGB-like) volume, any static shift list."""
    fs, ft = _fvs(3, (6, 14, 19))
    for kernel in ("dot", "ssd", "sad"):
        want = np.asarray(j_fused(kernel, jnp.asarray(fs), jnp.asarray(ft),
                                  shifts, layout=layout, interpret=True))
        got = fused_fv_cost_volume(kernel, torch.from_numpy(fs),
                                   torch.from_numpy(ft), shifts,
                                   layout=layout).numpy()
        np.testing.assert_allclose(got, want, **TOL)


def test_k5_plain_bf16_matches_jax():
    fs, ft = _fvs(4, (5, 9, 7))
    want = np.asarray(j_fused("sad", jnp.asarray(fs), jnp.asarray(ft),
                              range(4), jnp.bfloat16, interpret=True),
                      np.float32)
    got = fused_fv_cost_volume("sad", torch.from_numpy(fs),
                               torch.from_numpy(ft), range(4),
                               torch.bfloat16).float().numpy()
    # one bf16 ulp: the two f32 sums may round to neighbours
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


def test_k5_wrapper_on_cpu_is_the_plain_version():
    fs, ft = (torch.from_numpy(x) for x in _fvs(5, (4, 6, 3)))
    before = counters()["launches.fused_fv_cost_volume"]
    np.testing.assert_array_equal(
        fused_fv_cost_volume("ssd", fs, ft, [0, -2, 1]).numpy(),
        fused_fv_cost_volume_plain("ssd", fs, ft, [0, -2, 1]).numpy())
    assert counters()["launches.fused_fv_cost_volume"] == before


def _pair(seed, shape):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, shape).astype(np.float32),
            rng.uniform(0, 1, shape).astype(np.float32))


def _wta_agree(cv, want, strategy, gap=1e-4):
    """WTA indices of two volumes equal wherever the best two entries of the
    reference volume are more than ``gap`` apart."""
    got_idx = extract_selected_index(torch.from_numpy(cv), to_port(strategy))
    want_idx = np.asarray(j_wta(jnp.asarray(want), strategy))
    w = -want if strategy.name == "SCORE" else want
    two = np.sort(w, axis=-1)[..., :2]
    clear = (two[..., 1] - two[..., 0]) > gap
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(got_idx.numpy()[clear], want_idx[clear])


@pytest.mark.parametrize("func", ["ZSAD", "CENSUS", "MEDAD", "KERMI"])
def test_unfold_route_matches_jax(func):
    f = JMF[func]
    L, R = _pair(6, (12, 18))
    want = np.asarray(j_unfold_cv(f, jnp.asarray(L), jnp.asarray(R), 2, 2, 6))
    got = unfold_based_cost_volume(to_port(f), torch.from_numpy(L),
                                   torch.from_numpy(R), 2, 2, 6).numpy()
    np.testing.assert_allclose(got, want, **BOX_TOL)
    _wta_agree(got, want, J_TRAITS[f].strategy)


@pytest.mark.parametrize("direction", ["RIGHT_TO_LEFT", "LEFT_TO_RIGHT"])
@pytest.mark.parametrize("func", ["SSD", "ZSSD", "SAD"])
def test_box_family_matches_jax(func, direction):
    f = JMF[func]
    L, R = _pair(7, (15, 21))
    want = np.asarray(j_box(f, jnp.asarray(L), jnp.asarray(R), 2, 3, 8,
                            JDir[direction]))
    got = box_cost_volume(to_port(f), torch.from_numpy(L),
                          torch.from_numpy(R), 2, 3, 8,
                          to_port(JDir[direction])).numpy()
    np.testing.assert_allclose(got, want, **BOX_TOL)
    _wta_agree(got, want, J_TRAITS[f].strategy)


@pytest.mark.parametrize("case", ["offset_search", "multichannel"])
@pytest.mark.parametrize("func", ["SSD", "ZSSD", "SAD"])
def test_box_family_variants_match_jax(func, case):
    f = JMF[func]
    L, R = _pair(8, (13, 19, 3) if case == "multichannel" else (13, 19))
    js, ts = ((JSearch1(-3, 4), SearchOffset1(-3, 4))
              if case == "offset_search" else (6, 6))
    want = np.asarray(j_box(f, jnp.asarray(L), jnp.asarray(R), 1, 2, js))
    got = box_cost_volume(to_port(f), torch.from_numpy(L),
                          torch.from_numpy(R), 1, 2, ts).numpy()
    np.testing.assert_allclose(got, want, **BOX_TOL)


@pytest.mark.parametrize("backend", ["box", "unfold"])
@pytest.mark.parametrize("func", ["SSD", "SAD", "ZNCC"])
def test_unfold_based_backends_match_jax(func, backend):
    """'box' and 'unfold' name the same volume; each matches its JAX
    route."""
    f = JMF[func]
    L, R = _pair(9, (11, 16))
    want = np.asarray(j_unfold_cv(f, jnp.asarray(L), jnp.asarray(R), 2, 1,
                                  JSearch1(0, 5), backend=backend))
    got = unfold_based_cost_volume(to_port(f), torch.from_numpy(L),
                                   torch.from_numpy(R), 2, 1,
                                   SearchOffset1(0, 5),
                                   backend=backend).numpy()
    np.testing.assert_allclose(got, want, **BOX_TOL)


@pytest.mark.parametrize("func", ["ZSAD", "SSD", "CENSUS"])
def test_wta_forward_matches_jax(func):
    """The slice's WTA entry (7x7 window, D=120) against the JAX package's
    `bench_grid.py` configuration: volumes within float tolerance, indices
    equal away from near-ties."""
    f = JMF[func]
    L, R = _pair(11, (14, 140))
    want = np.asarray(j_unfold_cv(f, jnp.asarray(L), jnp.asarray(R), 3, 3,
                                  120))
    got = unfold_based_cost_volume(to_port(f), torch.from_numpy(L),
                                   torch.from_numpy(R), **entry.WTA).numpy()
    np.testing.assert_allclose(got, want, **BOX_TOL)
    idx = entry.wta_forward(to_port(f), torch.from_numpy(L),
                            torch.from_numpy(R))
    np.testing.assert_array_equal(
        idx.numpy(),
        extract_selected_index(torch.from_numpy(got),
                               to_port(J_TRAITS[f].strategy)).numpy())
    if J_TRAITS[f].census:      # integer costs: equal volumes, equal ties
        np.testing.assert_array_equal(
            idx.numpy(), np.asarray(j_wta(jnp.asarray(want),
                                          J_TRAITS[f].strategy)))
    else:
        _wta_agree(got, want, J_TRAITS[f].strategy)


def test_two_d_searches_are_not_ported_yet():
    """2-D searches are ported now (they raised before): `aggregate_cost`
    and `unfold_based_cost_volume` take a SearchOffset2, whatever the
    backend asked for, and equal JAX's (H, W, D0, D1) volumes."""
    rng = np.random.default_rng(12)
    fv_l, fv_r = (rng.uniform(0, 1, (4, 5, 3)).astype(np.float32)
                  for _ in range(2))
    want = np.asarray(j_aggregate(JMF.SSD, jnp.asarray(fv_l),
                                  jnp.asarray(fv_r), JSearch2(-1, 1, -1, 1)))
    for backend in ("auto", "scan", "fused"):
        got = aggregate_cost(to_port(JMF.SSD), torch.from_numpy(fv_l),
                             torch.from_numpy(fv_r),
                             SearchOffset2(-1, 1, -1, 1), backend=backend)
        assert got.shape == (4, 5, 3, 3)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    want = np.asarray(j_unfold_cv(JMF.SSD, jnp.asarray(fv_l[..., 0]),
                                  jnp.asarray(fv_r[..., 0]), 1, 1,
                                  JSearch2(-1, 1, -1, 1)))
    got = unfold_based_cost_volume(to_port(JMF.SSD),
                                   torch.from_numpy(fv_l[..., 0]),
                                   torch.from_numpy(fv_r[..., 0]), 1, 1,
                                   SearchOffset2(-1, 1, -1, 1))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_auto_backend_takes_the_scan_past_k5s_tile():
    """'auto' launches K5 on CUDA only where its tile fits a block's shared
    memory: ZSAD at r = 5 (F = 121) over D = 448 needs 249,600 bytes, so it
    takes the shifted-compare loop, as JAX's 'auto' falls back past its
    VMEM budget; the flagship WTA shape (F = 49, D = 120) takes K5."""
    from libstevi_tpu_torch.ops.cost_volume import auto_backend
    from libstevi_tpu_torch.ops.fv_backend import MAX_SMEM, smem_bytes
    assert smem_bytes(121, 448, 447) == 249600 > MAX_SMEM
    assert auto_backend("sad", True, (480, 640, 121), range(448)) == "scan"
    assert auto_backend("sad", True, (480, 640, 49), range(120)) == "fused"
    assert auto_backend("dot", True, (480, 640, 121), range(200)) == "fused"
    assert auto_backend("sad", False, (480, 640, 49), range(120)) == "scan"
    assert auto_backend("medad", True, (480, 640, 49), range(120)) == "scan"
    assert auto_backend("sad", True, (2, 480, 640, 49), range(120)) == "scan"
    # on the CPU 'auto' runs the loop, equal to JAX's scan at the shape
    L, R = _pair(0, (9, 40))
    f = JMF.ZSAD
    got = unfold_based_cost_volume(to_port(f), torch.from_numpy(L),
                                   torch.from_numpy(R), 5, 5, 24).numpy()
    want = np.asarray(j_unfold_cv(f, jnp.asarray(L), jnp.asarray(R), 5, 5,
                                  24))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shifts,step", [
    (list(range(120)), 1), ([-d for d in range(13)], -1),
    (list(range(-4, 9)), 1), (list(range(8, -5, -1)), -1), ([3], 1),
    (list(range(0, 90, 3)), 0), ([0, 1, 3], 0), ([2, 1, 2], 0)],
    ids=["r2l", "l2r", "offset", "offset_down", "one", "step3", "gap",
         "turn"])
def test_k5_instance_choice(shifts, step):
    """K5's unit-step detector (`unit_step`): +1 for RIGHT_TO_LEFT's
    range(D), offset ranges and one shift, -1 for LEFT_TO_RIGHT's -d and
    descending ranges, 0 for any other list; the tiled instance takes the
    first two, the general one the rest (`fv_instance`)."""
    from libstevi_tpu_torch.ops.fv_backend import fv_instance, unit_step
    assert unit_step(shifts) == step
    assert fv_instance(shifts) == ("tiled" if step else "general")


def _k5_tiled_model(kernel, src, tgt, shifts):
    """`csrc/fv_cv.cu`'s tiled instance in numpy, its indexing as written:
    blocks of 128 columns and up to 16 d-tiles of 8 (D split evenly over
    ceil(ND / 16) blocks), the staged source tile (stride 132, columns in
    the image) and target span (stride 128 + 8 nd + 4, columns j0 + lo +
    T0 + u for u < 128 + 8 nd, zero outside the image), each thread's
    16-byte-aligned run of 12 target values from u = B, and entry
    (c0 + a, d0 + b) taking run value a + b (step +1) or a + 7 - b (step
    -1), summed in f32 over f in order.  What the kernel leaves unstaged is
    NaN here, so an entry that read it would show; entries a thread does
    not own stay NaN."""
    from libstevi_tpu_torch.ops.fv_backend import unit_step
    H, W, F = src.shape
    D, lo, step = len(shifts), min(shifts), unit_step(shifts)
    ND = -(-D // 8)
    nz = -(-ND // 16)
    tpc = -(-ND // nz)
    cmp = {"dot": lambda a, b: a * b, "ssd": lambda a, b: (a - b) ** 2,
           "sad": lambda a, b: np.abs(a - b)}[kernel]
    out = np.full((H, W, D), np.nan, np.float32)
    ct = np.arange(32)
    for i in range(H):
        for j0 in range(0, W, 128):
            for tA in range(0, ND, tpc):
                nd = min(tpc, ND - tA)
                dA = 8 * tA
                ts = 128 + 8 * nd + 4
                T0 = dA if step > 0 else D - dA - 8 * nd
                s_t = np.full((F, 132), np.nan, np.float32)
                js = j0 + np.arange(128)
                s_t[:, :128][:, js < W] = src[i, js[js < W]].T
                t_t = np.full((F, ts), np.nan, np.float32)
                jt = j0 + lo + T0 + np.arange(128 + 8 * nd)
                ok = (jt >= 0) & (jt < W)
                t_t[:, :128 + 8 * nd] = 0.0
                t_t[:, :128 + 8 * nd][:, ok] = tgt[i, jt[ok]].T
                for dt in range(nd):
                    c0, d0 = 4 * ct, dA + 8 * dt
                    B = c0 + (8 * dt if step > 0 else 8 * (nd - 1 - dt))
                    assert (B % 4 == 0).all() and B.min() >= 0
                    assert B.max() + 12 <= 128 + 8 * nd
                    av = s_t[:, c0[:, None] + np.arange(4)]   # (F, 32, 4)
                    tv = t_t[:, B[:, None] + np.arange(12)]   # (F, 32, 12)
                    a_ = np.arange(4)[:, None]
                    b_ = np.arange(8)[None, :]
                    idx = a_ + b_ if step > 0 else a_ + 7 - b_
                    acc = np.zeros((32, 4, 8), np.float32)
                    for f in range(F):
                        acc += cmp(av[f][:, :, None], tv[f][:, idx])
                    for a in range(4):
                        for b in range(min(8, D - d0)):
                            j = j0 + c0 + a
                            out[i, j[j < W], d0 + b] = acc[j < W, a, b]
    return out


@pytest.mark.parametrize("shifts", [list(range(120)),
                                    [-d for d in range(57)],
                                    list(range(-9, 191)),
                                    list(range(130, -3, -1))],
                         ids=["r2l", "l2r", "offset_2_blocks",
                              "down_2_blocks"])
@pytest.mark.parametrize("kernel", ["dot", "ssd", "sad"])
def test_k5_tiled_indexing_matches_plain(kernel, shifts):
    """The tiled instance's indexing (`_k5_tiled_model`) covers every
    entry exactly once and gives `fused_fv_cost_volume_plain` at 1e-5, at
    W = 150 (a second, partial column tile), F = 21 (a partial feature
    chunk), and D = 200 / 133 (two blocks of d-tiles, the last partial).
    (The plain version is held to the JAX package's Pallas K5 above.)"""
    rng = np.random.default_rng(len(shifts))
    src, tgt = (rng.uniform(-0.5, 0.5, (2, 150, 21)).astype(np.float32)
                for _ in range(2))
    got = _k5_tiled_model(kernel, src, tgt, shifts)
    assert not np.isnan(got).any()
    want = fused_fv_cost_volume_plain(kernel, torch.from_numpy(src),
                                      torch.from_numpy(tgt), shifts).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("which", ["no stores", "no staging",
                                   "no arithmetic"])
def test_fv_probe_ablates_the_current_source(which):
    """`fv_probe` (K5's tiled instance timed with one part taken out) patches
    a copy of `csrc/fv_cv.cu` by string anchors: each is found once, so the
    probe stays in step with the kernel."""
    from libstevi_tpu_torch import _build, fv_probe
    src = fv_probe.ablated_source(which)
    assert src != (_build.CSRC / "fv_cv.cu").read_text()
    if which == "no staging":
        assert "cp_async4(sb" not in src and "commit_group" not in src
