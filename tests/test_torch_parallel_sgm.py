"""The port's distributed SGM engines (`libstevi_tpu_torch/parallel/
sgm_dist.py`, plain versions of K2, K2s and K4c on the CPU) against the JAX
package's same functions in `shard_map` over 4 or 8 virtual CPU devices,
Pallas in interpret mode, at JAX's own test shapes."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from libstevi_tpu.ops import sgm_cost_volume as j_sgm
from libstevi_tpu.parallel import MeshSpec as JMeshSpec
from libstevi_tpu.parallel import make_stereo_mesh as j_mesh
from libstevi_tpu.parallel.sgm_dist import (
    distributed_sgm as j_dist_sgm,
    distributed_sgm_fused as j_dist_fused,
    distributed_sgm_fused_dhw as j_dist_dhw)
from libstevi_tpu_torch.ops import sgm_cost_volume
from libstevi_tpu_torch.ops.sgm import _KNIGHT_DIRS
from libstevi_tpu_torch.ops.sgm_cuda import (knight_volumes_plain,
                                             sgm_knight_shard_pass_plain)
from libstevi_tpu_torch.parallel.sgm_dist import (carry_relay,
                                                  distributed_sgm,
                                                  distributed_sgm_fused,
                                                  distributed_sgm_fused_dhw,
                                                  distributed_sgm_routed)

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_tiles(fn, cv, n=4):
    """fn over ``n`` row shards in `shard_map`, on the virtual devices."""
    mesh = j_mesh(JMeshSpec(tile=n), jax.devices()[:n])
    f = jax.shard_map(fn, mesh=mesh, in_specs=P("tile"), out_specs=P("tile"),
                      check_vma=False)
    return np.asarray(jax.jit(f)(jnp.asarray(cv)))


def _port_tiles(fn, cv, n=4):
    shards = list(torch.from_numpy(cv).split(cv.shape[0] // n))
    return torch.cat(fn(shards)).numpy()


def test_distributed_sgm_matches_jax(rng):
    """4 directions, 32x24x8 on 4 shards: K2 and K2s (plain) against JAX's
    `lax.scan` relay."""
    cv = rng.uniform(0, 1, (32, 24, 8)).astype(np.float32)
    want = _jax_tiles(lambda c: j_dist_sgm(c, 0.1, 0.4, axis_name="tile"),
                      cv)
    got = _port_tiles(lambda s: distributed_sgm(s, 0.1, 0.4), cv)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shape,nd", [((32, 20, 7), 8), ((36, 13, 5), 8),
                                      ((36, 13, 5), 4)])
def test_distributed_sgm_fused_matches_jax(rng, shape, nd):
    """K4c (plain) relayed down and up + K4b's column scans against JAX's
    lane-layout shard kernels; H_loc = 9 puts padded kernel rows into the
    JAX relay."""
    cv = rng.uniform(0, 4, shape).astype(np.float32)
    want = _jax_tiles(lambda c: j_dist_fused(
        c, 0.3, 1.1, 7.0, n_directions=nd, interpret=True), cv)
    got = _port_tiles(lambda s: distributed_sgm_fused(s, 0.3, 1.1, 7.0, nd),
                      cv)
    np.testing.assert_allclose(got, want, **TOL)


DHW_CASES = [((32, 20, 7), 8), ((36, 13, 5), 8), ((36, 13, 5), 4),
             ((32, 24, 7), 16), ((16, 24, 5), 16),
             # H_loc = 9 (odd), W % 4 != 0, both
             ((36, 24, 5), 16), ((32, 22, 5), 16), ((36, 28, 5), 16)]


@pytest.mark.parametrize("shape,nd", DHW_CASES)
def test_distributed_sgm_fused_dhw_matches_jax(rng, shape, nd):
    """K2 and K2s (plain) against JAX's DHW shard kernels: 4 and 8
    directions, and 16 with the knight relay across row shards and the
    column-shard stage for the left/right knights, at odd shard heights
    and widths that do not split evenly."""
    cv = rng.uniform(0, 4, shape).astype(np.float32)
    want = _jax_tiles(lambda c: j_dist_dhw(
        c, 0.3, 1.1, 7.0, n_directions=nd, interpret=True), cv)
    got = _port_tiles(lambda s: distributed_sgm_fused_dhw(s, 0.3, 1.1, 7.0,
                                                          nd), cv)
    np.testing.assert_allclose(got, want, **TOL)


def test_distributed_sgm_fused_dhw_8_shards_matches_jax(rng):
    """48x96x16 over all 8 virtual devices (H_loc = 6)."""
    cv = rng.uniform(0, 4, (48, 96, 16)).astype(np.float32)
    want = _jax_tiles(lambda c: j_dist_dhw(
        c, 0.3, 1.1, 7.0, n_directions=8, interpret=True), cv, 8)
    got = _port_tiles(lambda s: distributed_sgm_fused_dhw(s, 0.3, 1.1, 7.0,
                                                          8), cv, 8)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("nd", [4, 8, 16])
def test_unequal_shards_equal_single_device(rng, nd):
    """Shards of unequal, odd heights (no JAX counterpart: `shard_map`
    splits evenly) against the single-device plain `sgm_cost_volume`."""
    cv = torch.from_numpy(rng.uniform(0, 4, (29, 17, 6)).astype(np.float32))
    want = sgm_cost_volume(cv, 0.3, 1.1, Pout=7.0, n_directions=nd)
    got = torch.cat(distributed_sgm_fused_dhw(list(cv.split([8, 3, 11, 7])),
                                              0.3, 1.1, 7.0, nd))
    torch.testing.assert_close(got, want, **TOL)
    if nd < 16:
        got = torch.cat(distributed_sgm_fused(list(cv.split([8, 3, 11, 7])),
                                              0.3, 1.1, 7.0, nd))
        torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("nd", [4, 8, 16])
def test_routed_engine_and_p2_below_p1(rng, nd):
    """The pipelines' rule: P2 < P1 runs the plain dense-penalty passes
    (against JAX's XLA path), and D > 320 K4c (with 16 directions, the
    knight relays before the last column scan), against JAX's
    single-device XLA path."""
    cv = rng.uniform(0, 4, (20, 11, 6)).astype(np.float32)
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.9, 0.2, Pout=7.0,
                            n_directions=nd, backend="xla"))
    got = torch.cat(distributed_sgm_routed(
        list(torch.from_numpy(cv).split(5)), 0.9, 0.2, 7.0, nd)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    wide = rng.uniform(0, 4, (8, 5, 330)).astype(np.float32)
    want = np.asarray(j_sgm(jnp.asarray(wide), 0.1, 0.5, Pout=7.0,
                            n_directions=nd, backend="xla"))
    got = torch.cat(distributed_sgm_routed(
        list(torch.from_numpy(wide).split(2)), 0.1, 0.5, 7.0, nd))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if nd < 16:     # K4c's plain version, the single-device order
        assert torch.equal(got, sgm_cost_volume(torch.from_numpy(wide), 0.1,
                                                0.5, Pout=7.0,
                                                n_directions=nd))


@pytest.mark.parametrize("nd", [4, 8, 16])
def test_distributed_sgm_past_d320_matches_jax(rng, nd):
    """`distributed_sgm` (4 directions) and the K2s engine at D = 330 on
    4 row shards against JAX's single-device `sgm_cost_volume`: K2 and
    K2s take any D."""
    cv = rng.uniform(0, 4, (12, 7, 330)).astype(np.float32)
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.3, 1.1, Pout=7.0,
                            n_directions=nd, backend="xla"))
    if nd == 4:
        got = _port_tiles(lambda s: distributed_sgm(s, 0.3, 1.1, 7.0), cv)
        np.testing.assert_allclose(got, want, **TOL)
    got = _port_tiles(lambda s: distributed_sgm_fused_dhw(s, 0.3, 1.1, 7.0,
                                                          nd), cv)
    np.testing.assert_allclose(got, want, **TOL)


def first_past_ring(elt: int, n_acc: int) -> int:
    """The first D past `ring_fits`: where K2's any-D launch keeps its
    carries in global memory (9641 for an f32 pass that accumulates)."""
    from libstevi_tpu_torch.ops.sgm_cuda import MAX_D, ring_fits
    D = MAX_D + 1
    while ring_fits(D, elt, n_acc):
        D += 1
    return D


@pytest.mark.parametrize("nd", [8, 16])
def test_distributed_sgm_past_the_k2_ring_matches_jax(rng, nd):
    """C6's route: `distributed_sgm_routed` over 2 row shards at the first
    D past K2's any-D ring (f32, a pass that accumulates), where K4c's
    carries do not fit either, so the K2s engine runs (plain here; on the
    card the any-D K2's shared instance), against JAX's single-device
    volume, as `test_distributed_sgm_past_d320_matches_jax` does at
    D = 330."""
    D = first_past_ring(4, 1)
    assert D == 9641
    cv = rng.uniform(0, 4, (6, 5, D)).astype(np.float32)
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.3, 1.1, Pout=7.0,
                            n_directions=nd, backend="xla"))
    got = torch.cat(distributed_sgm_routed(
        list(torch.from_numpy(cv).split(3)), 0.3, 1.1, 7.0, nd)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_routed_falls_back_to_k2s_where_k4c_does_not_fit(rng, monkeypatch):
    """Past D = 320, where K4c's carries do not fit a block's shared memory,
    the routed engine takes the K2s engine (any D) and still matches JAX's
    single-device volume."""
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    from libstevi_tpu_torch.ops import sgm_cuda
    monkeypatch.setattr(lane, "SMEM_BLOCK", 8000)
    cv = rng.uniform(0, 4, (8, 9, 330)).astype(np.float32)
    calls = []
    real = sgm_cuda.sgm_shard_pass_plain

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(sgm_cuda, "sgm_shard_pass_plain", spy)
    want = np.asarray(j_sgm(jnp.asarray(cv), 0.3, 1.1, Pout=7.0,
                            n_directions=16, backend="xla"))
    got = torch.cat(distributed_sgm_routed(
        list(torch.from_numpy(cv).split(2)), 0.3, 1.1, 7.0, 16))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert calls                                  # the K2s engine ran


@pytest.mark.parametrize("nd", [8, 16])
def test_routed_takes_k2s_where_fused_fits_refuses_matches_jax(
        rng, monkeypatch, nd):
    """The 4K UHD step's route at a small shape: with one SM,
    `fused_fits` refuses K4c's carries for a 30-column region at D = 330
    (182 carries of 1320 bytes, over a block's 232,448), as it refuses
    3840 columns at D = 384 on 132 SMs, so `distributed_sgm_routed` takes
    the K2s engine (`distributed_sgm_fused_dhw`: K2 for the horizontal
    passes, K2s relayed, any D), here over 4 row shards of 2 rows, against
    the JAX package's distributed DHW SGM in `shard_map` (Pallas in
    interpret mode)."""
    from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
    from libstevi_tpu_torch.parallel import sgm_dist
    cv = rng.uniform(0, 4, (8, 30, 330)).astype(np.float32)
    assert lane.fused_fits(30, 330, nd) and not lane.fused_fits(30, 330, nd,
                                                                n_sm=1)
    assert not lane.fused_fits(3840, 384, 8)
    monkeypatch.setattr(lane, "_sms", lambda t: 1)
    calls = []
    real = sgm_dist.distributed_sgm_fused_dhw

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(sgm_dist, "distributed_sgm_fused_dhw", spy)
    want = _jax_tiles(lambda c: j_dist_dhw(
        c, 0.3, 1.1, 7.0, n_directions=nd, interpret=True), cv)
    got = _port_tiles(lambda s: distributed_sgm_routed(s, 0.3, 1.1, 7.0, nd),
                      cv)
    assert calls == [1]
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("direction", _KNIGHT_DIRS, ids=lambda d: d.name)
def test_knight_shard_relay_equals_whole_image_volume(rng, direction):
    """The knight shard pass's plain version relayed over shards that start
    at odd global offsets (rows 0, 5, 8, 15 of 23 for the down/up knights,
    columns 0, 3, 10, 13 of 19 for the left/right ones, with the image
    column offset for Pout), each adding its p0 + p1 into its accumulator
    once, equals the whole-image volume of `knight_volumes_plain` bit for
    bit."""
    cv = torch.from_numpy(rng.uniform(0, 4, (23, 19, 5)).astype(np.float32))
    whole = knight_volumes_plain(cv, [direction], 0.3, 1.1, 7.0)[0]
    vert = direction.steps[0][0] != 0
    sizes = [5, 3, 7, 8] if vert else [3, 7, 3, 6]
    starts = np.cumsum([0] + sizes)
    acc = torch.zeros_like(cv)

    def run(m, carries):
        s0, s1 = int(starts[m]), int(starts[m + 1])
        blk = cv[s0:s1] if vert else cv[:, s0:s1].contiguous()
        a = torch.zeros_like(blk)
        kw = (dict(s0=s0, N_img=23) if vert
              else dict(s0=s0, N_img=19, col0=s0, W_pout=19))
        out = sgm_knight_shard_pass_plain(blk, a, direction, 0.3, 1.1, 7.0,
                                          carries, **kw)
        if vert:
            acc[s0:s1] = a
        else:
            acc[:, s0:s1] = a
        return out

    rev = (direction.steps[0][0] if vert else direction.steps[0][1]) < 0
    carry_relay(["cpu"] * len(sizes), run, reverse=rev)
    assert torch.equal(acc, whole)
