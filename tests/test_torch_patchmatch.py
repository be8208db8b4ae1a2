"""The port's PatchMatch against the JAX package: K6/K7's plain versions
against the Pallas sweep and probe kernels in interpret mode, the whole
CV-route matcher replaying JAX's candidate stream on one shared volume, the
cacheless sweeps, the matcher's quality on the small parity pairs, and
2-D PatchMatch (`patch_match_flow`) replaying JAX's key schedule."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.core.search import SearchOffset1 as JSearch1
from libstevi_tpu.core.search import SearchOffset2 as JSearch2
from libstevi_tpu.ops import patchmatch as jpm
from libstevi_tpu.ops.box_backend import box_cost_volume as j_box
from libstevi_tpu.ops.cost_volume import normalize_feature_volume as j_norm
from libstevi_tpu.ops.patchmatch import patch_match as j_patch_match
from libstevi_tpu.ops.patchmatch_pallas import (probe as j_probe,
                                                sweep as j_sweep, _round_up)
from libstevi_tpu.ops.unfold import unfold as j_unfold

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import (MatchingFunction, SearchOffset1,
                                     SearchOffset2)
from libstevi_tpu_torch.io import read_stevimg
from libstevi_tpu_torch.ops import patchmatch as tpm
from libstevi_tpu_torch.ops import (patch_match, patch_match_flow,
                                    patch_match_stereo)
from libstevi_tpu_torch.ops.cost_volume import normalize_feature_volume
from libstevi_tpu_torch.ops.patchmatch_cuda import (probe, probe_plain,
                                                    search_probe,
                                                    search_probe_plain,
                                                    sweep, sweep_plain)
from libstevi_tpu_torch.ops.unfold import unfold
from libstevi_tpu_torch.reference import to_port
from libstevi_tpu_torch.statistics import inlier_mae, prop_good
from libstevi_tpu_torch.utils.profiling import counters

torch.set_num_threads(2)

DATA = Path(__file__).resolve().parent / "data" / "parity"
_INF = np.float32(np.inf)


def _state(seed, H, W, D, lower):
    """A cost-oriented (H, W, D) volume of small integers (many ties) with
    +inf entries, and a state whose disparities reach 2 past either end of
    [lower, lower + D) (out-of-range candidates) with some +inf costs."""
    rng = np.random.default_rng(seed)
    cv = rng.integers(0, 4, (H, W, D)).astype(np.float32)
    cv[rng.uniform(size=cv.shape) < 0.1] = _INF
    disp = rng.integers(lower - 2, lower + D + 2, (H, W)).astype(np.int32)
    cost = rng.integers(0, 4, (H, W)).astype(np.float32)
    cost[rng.uniform(size=cost.shape) < 0.1] = _INF
    return cv, disp, cost


def _jax_layout(cv, *maps, rc=8):
    """(H, W, D) -> the TPU kernels' padded (Hp, Dp, Wp) volume and
    (Hp, Wp) maps (volume and costs padded with +inf)."""
    H, W, D = cv.shape
    Hp, Wp, Dp = _round_up(H, rc), _round_up(W, 128), _round_up(D, 8)
    cv_p = np.moveaxis(np.pad(cv, ((0, Hp - H), (0, Wp - W), (0, Dp - D)),
                              constant_values=np.inf), -1, 1)
    out = [np.pad(m, ((0, Hp - H), (0, Wp - W)),
                  constant_values=np.inf if m.dtype == np.float32 else 0)
           for m in maps]
    return cv_p, out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_sweep_plain_matches_pallas_kernel(axis, reverse):
    H, W, D, lower = 13, 11, 6, -2
    cv, disp, cost = _state(axis * 2 + reverse, H, W, D, lower)
    if axis == 0:           # lines are rows: the kernel's own orientation
        cv_j, d_j, c_j, L = cv, disp, cost, H
    else:                   # lines are columns: the transposed problem
        cv_j, d_j, c_j, L = (cv.transpose(1, 0, 2), disp.T.copy(),
                             cost.T.copy(), W)
    cv_p, (d_p, c_p) = _jax_layout(np.ascontiguousarray(cv_j), d_j, c_j)
    jd, jc = j_sweep(jnp.asarray(cv_p), jnp.asarray(d_p), jnp.asarray(c_p),
                     lower, D, L, reverse, interpret=True)
    S = cv_j.shape[1]
    jd, jc = np.asarray(jd)[:L, :S], np.asarray(jc)[:L, :S]
    if axis == 1:
        jd, jc = jd.T, jc.T
    td, tc = sweep_plain(torch.from_numpy(cv), torch.from_numpy(disp),
                         torch.from_numpy(cost), lower, axis, reverse)
    assert td.dtype == torch.int32 and tc.dtype == torch.float32
    assert not np.array_equal(td.numpy(), disp)        # something moved
    np.testing.assert_array_equal(td.numpy(), jd)
    np.testing.assert_array_equal(tc.numpy(), jc)


@pytest.mark.parametrize("K", [1, 4])
def test_probe_plain_matches_pallas_kernel(K):
    H, W, D, lower = 16, 9, 7, 3
    cv, disp, cost = _state(10 + K, H, W, D, lower)
    rng = np.random.default_rng(20 + K)
    cand = rng.integers(lower - 2, lower + D + 2, (K, H, W)).astype(np.int32)
    cand[0, :2] = disp[:2]                         # exact ties with itself
    cv_p, (d_p, c_p) = _jax_layout(cv, disp, cost)
    c_pad = np.stack([_jax_layout(cv, c)[1][0] for c in cand], axis=1)
    jd, jc = j_probe(jnp.asarray(cv_p), jnp.asarray(c_pad), jnp.asarray(d_p),
                     jnp.asarray(c_p), lower, D, interpret=True)
    td, tc = probe_plain(torch.from_numpy(cv), torch.from_numpy(cand),
                         torch.from_numpy(disp), torch.from_numpy(cost), lower)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[:H, :W])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:H, :W])


def test_wrappers_on_cpu_are_the_plain_versions():
    cv, disp, cost = (torch.from_numpy(x) for x in _state(30, 6, 7, 5, 0))
    draws = torch.from_numpy(np.random.default_rng(31).integers(
        0, 5, (3, 6, 7)).astype(np.int32))
    kernels = ("launches.sweep", "launches.probe")
    before = [counters()[k] for k in kernels]
    for got, want in ((sweep(cv, disp, cost, 0, 1, True),
                       sweep_plain(cv, disp, cost, 0, 1, True)),
                      (probe(cv, disp, disp, cost, 0),
                       probe_plain(cv, disp, disp, cost, 0)),
                      (search_probe(cv, draws, disp, cost, 0, 3),
                       search_probe_plain(cv, draws, disp, cost, 0, 3))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert [counters()[k] for k in kernels] == before


def flood_state(L, S, D, lower, seed):
    """A state in sweep order (lines first) where the first line's value
    v0 runs across every line up to 2L/3, whose own values all differ from
    v0 and from their neighbours (so no run breaks by equality); the line
    at 2L/3 rejects v0.  The volume is in [1, 2) except v0's entries (0.5,
    3 at the rejecting line); each cost is its pixel's own volume value."""
    rng = np.random.default_rng(seed)
    v0 = D // 2
    k = (np.arange(L)[:, None] * 5 + np.arange(S)[None] * 3) % (D - 1)
    k[k >= v0] += 1
    k[0] = v0
    cv = rng.uniform(1, 2, (L, S, D)).astype(np.float32)
    cv[:, :, v0] = 0.5
    cv[2 * L // 3, :, v0] = 3.0
    cost = np.take_along_axis(cv, k[..., None], -1)[..., 0].copy()
    return cv, (k + lower).astype(np.int32), cost


def _k6_model(cv, disp, cost, lower, axis, reverse):
    """`csrc/patchmatch.cu`'s K6 in numpy, phase by phase: A (nxt[m], the
    first line after m that breaks the run of d_old[m], by equality or by
    rejecting it; L where the run reaches the end), B
    (each chain walked from source to source) and C (the costs from the
    new disparities)."""
    def lines(x):
        x = x.swapaxes(0, 1) if axis == 1 else x
        return x[::-1] if reverse else x
    cv, disp, cost = lines(cv), lines(disp), lines(cost)
    L, S, D = cv.shape

    def accepts(l, s, v):
        k = v - lower
        return 0 <= k < D and np.isfinite(cv[l, s, k]) and \
            cv[l, s, k] <= cost[l, s]
    nxt = np.empty((L, S), np.int64)
    for m in range(L):
        for s in range(S):
            v = disp[m, s]
            brk = [l for l in range(m + 1, L)
                   if disp[l, s] == v or not accepts(l, s, v)]
            nxt[m, s] = brk[0] if brk else L
    out = np.empty_like(disp)
    for s in range(S):
        v, nb = 0, 0
        for n in range(L):
            if n == nb:
                v, nb = disp[n, s], nxt[n, s]
            out[n, s] = v
    c = cost.copy()
    for n in range(1, L):
        for s in range(S):
            if accepts(n, s, out[n - 1, s]):
                c[n, s] = cv[n, s, out[n - 1, s] - lower]

    def unlines(x):
        x = x[::-1] if reverse else x
        return x.swapaxes(0, 1) if axis == 1 else x
    return unlines(out), unlines(c)


def _flood(axis, reverse, L, S, D, lower, seed):
    """`flood_state` laid out for the sweep (axis, reverse) as (H, W)."""
    cv, disp, cost = flood_state(L, S, D, lower, seed)
    if reverse:
        cv, disp, cost = cv[::-1], disp[::-1], cost[::-1]
    if axis == 1:
        cv, disp, cost = cv.swapaxes(0, 1), disp.T, cost.T
    return tuple(np.ascontiguousarray(x) for x in (cv, disp, cost))


@pytest.mark.parametrize("state", ["random", "flood", "edge"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_k6_phases_equal_the_recurrence(axis, reverse, state):
    """K6's design (source-to-source chains, each line's run found up
    front; `csrc/patchmatch.cu`) gives the naive recurrence's state bit for
    bit: on random states with ties, +inf and out-of-range values, on a
    flood whose run crosses 2/3 of every line, and on a volume whose last
    columns are +inf (the image edge), where +inf costs accept any finite
    candidate and runs grow long."""
    lower = -2
    if state == "random":
        cv, disp, cost = _state(50 + axis, 19, 13, 6, lower)
    elif state == "flood":
        lower, L = 3, 80
        cv, disp, cost = _flood(axis, reverse, L, 5, 11, lower, 51)
    else:
        rng = np.random.default_rng(52)
        cv = rng.uniform(0, 1, (40, 30, 6)).astype(np.float32)
        cv[:, -8:] = np.inf
        cv[:, -8:, 0] = rng.uniform(0, 1, (40, 8))
        disp = rng.integers(lower, lower + 6, (40, 30)).astype(np.int32)
        k = (disp - lower)[..., None]
        cost = np.take_along_axis(cv, k, -1)[..., 0].copy()
    got = _k6_model(cv, disp, cost, lower, axis, reverse)
    want = sweep_plain(torch.from_numpy(cv), torch.from_numpy(disp),
                       torch.from_numpy(cost), lower, axis, reverse)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    if state == "flood":    # the run crossed the first 2L/3 lines
        n = 2 * L // 3
        lines = want[0].numpy().T if axis == 1 else want[0].numpy()
        lines = lines[::-1] if reverse else lines
        assert (lines[:n] == lower + 11 // 2).all()
        assert (lines[n] != lower + 11 // 2).all()


@pytest.mark.parametrize("K", [1, 4])
def test_search_probe_plain_matches_pallas_probe(K):
    """`search_probe_plain` against the JAX package's `probe` (Pallas,
    interpret mode) fed the candidates JAX's `_patch_match_stereo_cv`
    forms (`patchmatch.py:245-253`) from the same numpy draws: negative
    differences (the floor), candidates forced off the current value,
    out-of-range candidates and ties."""
    H, W, D, lower = 16, 9, 7, 3
    cv, disp, cost = _state(60 + K, H, W, D, lower)
    rng = np.random.default_rng(70 + K)
    draws = rng.integers(lower, lower + D, (K, H, W)).astype(np.int32)
    draws[0, :2] = disp[:2]                 # forced off the current value
    jd = jnp.asarray(disp)
    cands = []
    for k in range(K):
        cand = jd + ((jnp.asarray(draws[k]) - jd) * (k + 1)) // (K + 1)
        cands.append(np.asarray(jnp.where(cand == jd, jd + 1, cand)))
    assert (draws < disp).any() and any((c > lower + D - 1).any()
                                        for c in cands)
    cv_p, (d_p, c_p) = _jax_layout(cv, disp, cost)
    c_pad = np.stack([_jax_layout(cv, c)[1][0] for c in cands], axis=1)
    want_d, want_c = j_probe(jnp.asarray(cv_p), jnp.asarray(c_pad),
                             jnp.asarray(d_p), jnp.asarray(c_p), lower, D,
                             interpret=True)
    td, tc = search_probe_plain(torch.from_numpy(cv), torch.from_numpy(draws),
                                torch.from_numpy(disp),
                                torch.from_numpy(cost), lower, K)
    np.testing.assert_array_equal(td.numpy(), np.asarray(want_d)[:H, :W])
    np.testing.assert_array_equal(tc.numpy(), np.asarray(want_c)[:H, :W])
    assert not np.array_equal(td.numpy(), disp)         # something moved


def test_scaled_candidate_floors_like_jax():
    rng = np.random.default_rng(40)
    cand = rng.integers(-10, 30, (5, 8)).astype(np.int32)
    disp = rng.integers(-10, 30, (5, 8)).astype(np.int32)
    assert ((cand - disp) < 0).any() and ((cand - disp) % 5 != 0).any()
    for k in range(4):
        want = (jnp.asarray(disp) + ((jnp.asarray(cand) - jnp.asarray(disp))
                                     * (k + 1)) // 5)
        want = np.asarray(jnp.where(want == jnp.asarray(disp),
                                    jnp.asarray(disp) + 1, want))
        got = tpm._scaled_candidate(torch.from_numpy(cand),
                                    torch.from_numpy(disp), k, 4)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


def _jax_draws(seed, H, W, lower, upper, n_iter, n_random):
    """JAX's candidate stream of `_patch_match_stereo_cv`
    (`patchmatch.py:219-253`): drawn at the padded (round_up(H, 128),
    round_up(W, 128)) shape and cropped to (H, W)."""
    Hp, Wp = _round_up(H, 128), _round_up(W, 128)

    def rnd(k):
        return np.array(jax.random.randint(k, (Hp, Wp), lower, upper + 1,
                                           dtype=jnp.int32)[:H, :W])

    key = jax.random.PRNGKey(seed)
    key, k0 = jax.random.split(key)
    draws = [rnd(k0)]
    for _ in range(n_iter):
        key, ks = jax.random.split(key)
        keys = jax.random.split(ks, n_random)
        draws += [rnd(keys[k]) for k in range(n_random)]
    return draws


def _replay(draws, low, high):
    """A ``draw`` that hands out ``draws`` in order."""
    queue = list(draws)

    def draw(shape, lo, hi):
        assert (tuple(shape), lo, hi) == (queue[0].shape, low, high)
        return torch.from_numpy(queue.pop(0))
    draw.left = queue
    return draw


def _shifted_pair(seed, H, W, shift):
    """right(i, j) = left(i, j + shift), plus a little noise."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 1, (H, W + shift)).astype(np.float32)
    right = base[:, shift:]
    left = base[:, :W]
    noise = rng.normal(0, 0.02, (2, H, W)).astype(np.float32)
    return left + noise[0], right + noise[1]


@pytest.mark.parametrize("func,search", [("NCC", (0, 15)), ("SSD", (-3, 12))],
                         ids=["ncc_score", "ssd_cost_offset"])
def test_cv_patchmatch_matches_jax_exactly(func, search):
    """The whole CV route on one shared volume, replaying JAX's candidate
    stream: disparities equal JAX's with the Pallas kernels in interpret
    mode."""
    H, W, n_iter, n_random = 24, 40, 4, 2
    lo, hi = search
    L, R = _shifted_pair(50, H, W, 5)
    f = JMF[func]
    cv_j = j_box(f, jnp.asarray(L), jnp.asarray(R), 2, 2, JSearch1(lo, hi))
    want = np.asarray(jpm._patch_match_stereo_cv(
        f, None, None, JSearch1(lo, hi), n_iter, n_random,
        jax.random.PRNGKey(3), interpret=True, cv=cv_j))
    draw = _replay(_jax_draws(3, H, W, lo, hi, n_iter, n_random), lo, hi + 1)
    got = tpm._patch_match_stereo_cv(
        to_port(f), None, None, SearchOffset1(lo, hi), n_iter, n_random,
        cv=torch.from_numpy(np.array(cv_j)), draw=draw)
    assert not draw.left
    assert got.dtype == torch.int32 and got.shape == (H, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[3:-3, 3:-8] == 5).mean() > 0.8     # it found the shift


def _fv_pair(func, seed=60, H=14, W=22, r=2):
    L, R = _shifted_pair(seed, H, W, 3)
    jl, jr = (j_norm(func, j_unfold(r, r, jnp.asarray(x))) for x in (L, R))
    tl, tr = (normalize_feature_volume(to_port(func),
                                       unfold(r, r, torch.from_numpy(x)))
              for x in (L, R))
    return (jl, jr), (tl, tr)


@pytest.mark.parametrize("func", ["ZNCC", "SAD", "CENSUS"])
def test_cacheless_sweeps_match_jax(func):
    """The cacheless evaluator and sweeps on the same state (costs within
    float tolerance: the two packages sum features in other orders, so a
    candidate equal to the current disparity may or may not count as a
    tie; the disparities agree)."""
    f = JMF[func]
    (jl, jr), (tl, tr) = _fv_pair(f)
    jev = jpm._StereoEval(f, jr, jl)
    tev = tpm._StereoEval(to_port(f), tr, tl)
    disp = np.random.default_rng(61).integers(-1, 9, jr.shape[:2]).astype(
        np.int32)
    jc = jev.cost_field(jnp.asarray(disp))
    tc = tev.cost_field(torch.from_numpy(disp))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    jd, jcost = jnp.asarray(disp), jc
    td, tcost = torch.from_numpy(disp), tc
    for forward in (True, False):
        jd, jcost, _ = jpm._row_sweep(jev, jd, jcost, forward)
        td, tcost, _ = tpm._row_sweep(tev, td, tcost, forward)
        jd, jcost, _ = jpm._col_sweep(jev, jd, jcost, not forward)
        td, tcost, _ = tpm._col_sweep(tev, td, tcost, not forward)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tcost.numpy(), np.asarray(jcost), rtol=1e-5,
                               atol=1e-5)


def _small(occ):
    sfx = "_occ_small" if occ else "_small"
    L, R, gt = (read_stevimg(str(DATA / f"{n}{sfx}.stevimg"))
                for n in ("left", "right", "gt"))
    return torch.from_numpy(L), torch.from_numpy(R), gt


@pytest.mark.parametrize("route", ["scan", "cv"])
@pytest.mark.parametrize("occ,bar", [(False, 0.85), (True, 0.93)],
                         ids=["warp", "occluded"])
def test_patch_match_on_small_pairs(occ, bar, route):
    """The JAX tests' bars (`tests/test_parity.py:149-154, 269-274`) for
    both routes of the port on the CPU."""
    L, R, gt = _small(occ)
    g = torch.Generator().manual_seed(0)
    f = MatchingFunction.NCC
    search = SearchOffset1(0, 31)
    if route == "scan":
        disp = patch_match(f, L, R, search, 3, 3, n_iter=5, generator=g)
    else:
        fl, fr = (normalize_feature_volume(f, unfold(3, 3, x)) for x in (L, R))
        disp = patch_match_stereo(f, fr, fl, search, n_iter=5, generator=g,
                                  backend="cv")
    assert disp.dtype == torch.int32 and disp.shape == L.shape
    pg = prop_good(disp.numpy().astype(np.float32), gt, 2.0)
    assert pg > bar, pg


def test_patch_match_respects_search_range():
    base = torch.from_numpy(np.random.default_rng(70).uniform(
        0.1, 1, (24, 32)).astype(np.float32))
    so = SearchOffset1(2, 9)
    for backend in ("scan", "cv"):
        fv = normalize_feature_volume(MatchingFunction.NCC,
                                      unfold(2, 2, base))
        disp = patch_match_stereo(MatchingFunction.NCC, fv, fv, so, n_iter=4,
                                  backend=backend)
        assert disp.min() >= 2 and disp.max() <= 9


@pytest.mark.parametrize("occ", [False, True], ids=["warp", "occluded"])
def test_patchmatch_forward_matches_jax_quality(occ):
    """The slice's PatchMatch entry (NCC 7x7, D=120, 5 iterations, 4 random
    candidates) on the small parity pairs, against the JAX package's
    `patch_match` in the same configuration: the candidate streams differ,
    so the two agree statistically."""
    L, R, gt = _small(occ)
    j = np.asarray(j_patch_match(JMF.NCC, jnp.asarray(L.numpy()),
                                 jnp.asarray(R.numpy()), JSearch1(0, 119), 3,
                                 3, 5, 4), np.float32)
    t = entry.patchmatch_forward(L, R, torch.Generator().manual_seed(0))
    t = t.numpy().astype(np.float32)
    pg_j, pg_t = prop_good(j, gt, 2.0), prop_good(t, gt, 2.0)
    assert pg_t > 0.95 and abs(pg_t - pg_j) < 0.01, (pg_t, pg_j)
    assert abs(inlier_mae(t, gt, 2.0) - inlier_mae(j, gt, 2.0)) < 0.03


def _jax_flow_draws(seed, H, W, s, n_iter, n_random):
    """JAX's candidate stream of `patch_match_flow`
    (`libstevi_tpu/ops/patchmatch.py:334-338,397-404`): (draw, low, high)
    in order, the row offsets of a field before its column offsets."""
    def rnd(k, lo, hi):
        return (np.array(jax.random.randint(k, (H, W), lo, hi + 1,
                                            dtype=jnp.int32)), lo, hi + 1)

    key = jax.random.PRNGKey(seed)
    key, k0, k1 = jax.random.split(key, 3)
    draws = [rnd(k0, s.lower0, s.upper0), rnd(k1, s.lower1, s.upper1)]
    for _ in range(n_iter):
        key, ka, _ = jax.random.split(key, 3)
        for _ in range(n_random):
            ka, k0, k1 = jax.random.split(ka, 3)
            draws += [rnd(k0, s.lower0, s.upper0), rnd(k1, s.lower1, s.upper1)]
    return draws


def _replay_flow(draws):
    """A ``draw`` that hands out ``draws`` in order, each at the shape and
    bounds it was drawn with."""
    queue = list(draws)

    def draw(shape, lo, hi):
        arr, low, high = queue.pop(0)
        assert (tuple(shape), lo, hi) == (arr.shape, low, high)
        return torch.from_numpy(arr)
    draw.left = queue
    return draw


def _flow_pair(func, seed=80, H=16, W=20, di=1, dj=2):
    """Normalized feature volumes of a pair related by a (di, dj) shift."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 1, (H + 8, W + 8)).astype(np.float32)
    src = base[4:4 + H, 4:4 + W]
    tgt = base[4 - di:4 - di + H, 4 - dj:4 - dj + W]
    jv = [j_norm(func, j_unfold(1, 1, jnp.asarray(x))) for x in (src, tgt)]
    conv = ((lambda x: np.array(x).astype(np.int64)) if func is JMF.CENSUS
            else np.array)
    return jv, [torch.from_numpy(conv(x)) for x in jv]


@pytest.mark.parametrize("func,search", [
    ("ZNCC", (-2, 3, -3, 3)), ("SAD", (0, 2, 1, 4)),
    ("CENSUS", (-2, 3, -3, 3))],
    ids=["zncc_signed", "sad_positive", "census_signed"])
def test_patch_match_flow_matches_jax_exactly(func, search):
    """`patch_match_flow` replaying JAX's key schedule: the (H, W, 2) flow
    equals JAX's exactly (row and column sweeps, the 2-D random search
    with its floored scaling and +1 nudge)."""
    f = JMF[func]
    (js, jt), (ts, tt) = _flow_pair(f)
    H, W = ts.shape[:2]
    n_iter, n_random = 3, 2
    want = np.asarray(jpm.patch_match_flow(
        f, js, jt, JSearch2(*search), n_iter, n_random,
        jax.random.PRNGKey(4)))
    draw = _replay_flow(_jax_flow_draws(4, H, W, JSearch2(*search), n_iter,
                                        n_random))
    got = patch_match_flow(to_port(f), ts, tt, SearchOffset2(*search),
                           n_iter, n_random, draw=draw)
    assert not draw.left
    assert got.dtype == torch.int32 and got.shape == (H, W, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    if search[0] <= 1 <= search[1] and search[2] <= 2 <= search[3]:
        inner = got[2:-2, 3:-3].numpy()
        assert ((inner[..., 0] == 1) & (inner[..., 1] == 2)).mean() > 0.5


def test_patch_match_flow_generator_stays_in_range():
    """With a `torch.Generator` the flow stays inside the search."""
    (_, _), (ts, tt) = _flow_pair(JMF.SSD)
    s = SearchOffset2(-1, 2, 0, 3)
    g = torch.Generator().manual_seed(1)
    flow = patch_match_flow(MatchingFunction.SSD, ts, tt, s, 2, 3,
                            generator=g)
    assert flow.dtype == torch.int32
    assert ((flow[..., 0] >= -1) & (flow[..., 0] <= 2)).all()
    assert ((flow[..., 1] >= 0) & (flow[..., 1] <= 3)).all()
