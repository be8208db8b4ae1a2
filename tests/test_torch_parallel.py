"""The port's distributed building blocks (`libstevi_tpu_torch/parallel/`)
against the JAX package's on the CPU: the mesh, the halo exchange, the
D-sharded WTA and the row-sharded cost volume + WTA, with the JAX side in
`shard_map` over the virtual CPU devices of `tests/conftest.py`; and the
plain shard passes (K2s, K4c), run shard after shard with relayed carries,
against the whole-image plain passes, bit for bit."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as P

from libstevi_tpu.core import (ExtractionStrategy as JES,
                               MatchingFunction as JMF)
from libstevi_tpu.parallel import (MeshSpec as JMeshSpec,
                                   distributed_cost_volume_wta as j_cv_wta,
                                   dshard_wta as j_dshard_wta,
                                   halo_exchange_rows as j_halo,
                                   make_stereo_mesh as j_mesh)
from libstevi_tpu_torch.core import ExtractionStrategy, MatchingFunction
from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
from libstevi_tpu_torch.ops.sgm import _KNIGHT_DIRS, directions_for
from libstevi_tpu_torch.ops.sgm_cuda import (sgm_knight_shard_pass,
                                             sgm_shard_pass)
from libstevi_tpu_torch.parallel import (MeshSpec, distributed_cost_volume_wta,
                                         dshard_wta, halo_exchange_rows,
                                         make_stereo_mesh)
from libstevi_tpu_torch.parallel.sgm_dist import carry_relay

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
P1, P2, POUT = 0.3, 1.1, 7.0


def _jmesh(**axes):
    spec = JMeshSpec(**axes)
    return j_mesh(spec, jax.devices()[:spec.n_devices])


def _cpu_mesh(**axes):
    spec = MeshSpec(**axes)
    return make_stereo_mesh(spec, ["cpu"] * spec.n_devices)


def test_mesh_axes_and_repeated_devices():
    mesh = _cpu_mesh(batch=2, tile=2, dsh=2)
    assert mesh.shape == {"batch": 2, "tile": 2, "dsh": 2}
    assert mesh.shape == dict(_jmesh(batch=2, tile=2, dsh=2).shape)
    assert mesh.devices.shape == (2, 2, 2)
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    assert mesh.tile_devices(1) == [torch.device("cpu")] * 2


def test_mesh_raises_with_too_few_devices():
    with pytest.raises(ValueError, match="mesh needs 8 devices, have 3"):
        make_stereo_mesh(MeshSpec(batch=2, tile=4), ["cpu"] * 3)
    with pytest.raises(ValueError, match="mesh needs 8 devices"):
        j_mesh(JMeshSpec(batch=2, tile=4), jax.devices()[:3])
    # no argument: the visible CUDA devices only, never the CPU
    n_cuda = torch.cuda.device_count()
    if n_cuda < 2:
        with pytest.raises(ValueError, match=f"have {n_cuda}"):
            make_stereo_mesh(MeshSpec(tile=2))


@pytest.mark.parametrize("up,down", [(2, 2), (3, 0), (0, 1)])
def test_halo_exchange_matches_jax(rng, up, down):
    x = rng.uniform(0, 1, (24, 5)).astype(np.float32)
    f = jax.jit(jax.shard_map(lambda b: j_halo(b, up, down, "tile"),
                              mesh=_jmesh(tile=4), in_specs=P("tile"),
                              out_specs=P("tile")))
    want = np.asarray(f(jnp.asarray(x))).reshape(4, 6 + up + down, 5)
    got = halo_exchange_rows(list(torch.from_numpy(x).split(6)), up, down)
    for k in range(4):
        np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_halo_larger_than_a_shard_raises():
    with pytest.raises(ValueError, match="exceeds the local shard height"):
        halo_exchange_rows(list(torch.zeros(8, 3).split(2)), 3, 0)


@pytest.mark.parametrize("strategy", ["COST", "SCORE"])
def test_dshard_wta_matches_jax(rng, strategy):
    """A tie-heavy integer volume: the global index is the last optimum."""
    cv = rng.integers(0, 4, (32, 24, 8)).astype(np.float32)
    f = jax.jit(jax.shard_map(
        lambda c: j_dshard_wta(c, JES[strategy]), mesh=_jmesh(dsh=4),
        in_specs=P(None, None, "dsh"), out_specs=P(None, None),
        check_vma=False))
    want = np.asarray(f(jnp.asarray(cv)))
    got = dshard_wta(list(torch.from_numpy(cv).split(2, dim=-1)),
                     ExtractionStrategy[strategy])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("func", ["ZNCC", "CENSUS", "SAD"])
def test_cost_volume_wta_matches_jax(rng, func):
    L = rng.uniform(0.1, 1, (32, 24)).astype(np.float32)
    R = rng.uniform(0.1, 1, (32, 24)).astype(np.float32)
    want = np.asarray(j_cv_wta(_jmesh(tile=4), JMF[func], 2, 2, 8)(
        jnp.asarray(L), jnp.asarray(R)))
    got = distributed_cost_volume_wta(_cpu_mesh(tile=4),
                                      MatchingFunction[func], 2, 2, 8)(
        torch.from_numpy(L), torch.from_numpy(R))
    np.testing.assert_array_equal(got.numpy(), want)


# -- the plain shard passes relayed shard after shard -----------------------

SIZES = [7, 4, 9, 5]            # odd and unequal shard heights (25 rows)
COL_SIZES = [7, 4, 9, 1]        # ... and widths (21 columns)


def _relay_rows(cv, run, reverse, sizes=SIZES):
    """Run ``run(block, acc_block, carries, i0)`` over the row blocks of
    ``sizes`` in relay order; returns the assembled accumulator."""
    acc = torch.zeros_like(cv)
    blocks = list(range(len(sizes)))
    i0s = np.cumsum([0] + sizes)
    assert i0s[-1] == cv.shape[0]

    def step(k, carries):
        sl = slice(int(i0s[k]), int(i0s[k + 1]))
        a = acc[sl].clone()
        out = run(cv[sl], a, carries, int(i0s[k]))
        acc[sl] = a
        return out

    carry_relay(["cpu"] * len(blocks), step, reverse=reverse)
    return acc


@pytest.mark.parametrize("direction",
                         [d for d in directions_for(8) if d.step[0] != 0],
                         ids=lambda d: d.name)
def test_k2s_plain_relay_equals_whole_image(rng, direction):
    cv = torch.from_numpy(rng.uniform(0, 4, (25, 13, 6)).astype(np.float32))
    whole = torch.zeros_like(cv)
    sgm_shard_pass(cv, whole, direction, P1, P2, POUT)
    got = _relay_rows(cv, lambda c, a, car, i0: sgm_shard_pass(
        c, a, direction, P1, P2, POUT, True, car, i0, 25),
        direction.step[0] < 0)
    assert torch.equal(got, whole)


@pytest.mark.parametrize("direction", _KNIGHT_DIRS, ids=lambda d: d.name)
def test_k2s_knight_plain_relay_equals_whole_image(rng, direction):
    """Row shards for the down/up knights, column shards (odd widths, the
    image column offset for Pout) for the left/right ones."""
    cv = torch.from_numpy(rng.uniform(0, 4, (25, 21, 6)).astype(np.float32))
    whole = torch.zeros_like(cv)
    sgm_knight_shard_pass(cv, whole, direction, P1, P2, POUT)
    if direction.steps[0][0] != 0:
        got = _relay_rows(cv, lambda c, a, car, i0: sgm_knight_shard_pass(
            c, a, direction, P1, P2, POUT, car, i0, 25),
            direction.steps[0][0] < 0)
    else:
        got = _relay_rows(cv.transpose(0, 1).contiguous(),
                          lambda c, a, car, j0: _column_pass(
                              direction, c, a, car, j0),
                          direction.steps[0][1] < 0,
                          COL_SIZES).transpose(0, 1)
    assert torch.equal(got, whole)


def _column_pass(direction, block_t, acc_t, carries, j0):
    """A column shard given transposed: run it in the image layout."""
    blk, acc = block_t.transpose(0, 1).contiguous(), acc_t.transpose(0, 1)
    a = acc.contiguous()
    out = sgm_knight_shard_pass(blk, a, direction, P1, P2, POUT, carries,
                                j0, 21, col0=j0, W_pout=21)
    acc.copy_(a)
    return out


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_k4c_plain_relay_equals_whole_image(rng, diag, reverse):
    cv = torch.from_numpy(rng.uniform(0, 4, (25, 13, 6)).astype(np.float32))
    kw = dict(col0=0, W_pout=13, P1=P1, P2=P2, Pout=POUT)
    base = torch.from_numpy(rng.uniform(0, 1, cv.shape).astype(np.float32))
    whole = lane.fused_rows_pass_plain(cv, base.clone(), reverse, diag, **kw)

    def run(c, a, carries, i0):
        a += base[i0:i0 + c.shape[0]]
        out, couts = lane.fused_rows_shard_pass(c, a, carries, i0, 25,
                                                reverse, diag, **kw)
        a.copy_(out)
        return couts

    assert torch.equal(_relay_rows(cv, run, reverse), whole)
