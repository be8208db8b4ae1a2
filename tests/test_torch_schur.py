"""The port's distributed Gauss-Newton and Schur-complement solve
(`parallel/schur.py`) against the single-device `GaussNewton` and the JAX
package's `shard_map` version on 8 virtual CPU devices (as
`tests/test_alignment_solvers.py` runs it), on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libstevi_tpu_torch.optim import GaussNewton
from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
from libstevi_tpu_torch.parallel.schur import (
    distributed_gauss_newton, distributed_multiview_alignment,
    schur_complement_solve)

torch.set_num_threads(2)


def _data(n=64):
    t = np.linspace(0, 1, n).astype(np.float32)
    y = (2.0 * np.exp(-1.3 * t)
         + np.random.default_rng(0).normal(0, 0.01, n)).astype(np.float32)
    return t, y


def _tres(p, d):
    return p[0] * torch.exp(p[1] * d[0]) - d[1]


def _jres(p, d):
    return p[0] * jnp.exp(p[1] * d[0]) - d[1]


@pytest.mark.parametrize("axis,spec", [("batch", MeshSpec(batch=8)),
                                       ("tile", MeshSpec(batch=2, tile=4)),
                                       ("dsh", MeshSpec(dsh=8))])
def test_distributed_gn_matches_single_device_and_jax(axis, spec):
    """An exponential fit over 64 residuals split on one axis of a mesh of
    8 "cpu" entries: within 1e-5 of the single-device `GaussNewton` and of
    the JAX package's `distributed_multiview_alignment` on 8 virtual
    devices (4 along the axis on a (2, 4) mesh); within 1e-4 of the
    truth."""
    from libstevi_tpu.parallel import MeshSpec as JSpec
    from libstevi_tpu.parallel import make_stereo_mesh as j_mesh
    from libstevi_tpu.parallel.schur import (
        distributed_multiview_alignment as j_dist)
    t, y = _data()
    mesh = make_stereo_mesh(spec, ["cpu"] * 8)
    got = distributed_multiview_alignment(
        _tres, torch.tensor([1.0, 0.0]), (torch.from_numpy(t),
                                          torch.from_numpy(y)),
        mesh, axis, iters=30)
    single = GaussNewton(lambda p, tt, yy: _tres(p, (tt, yy)), iters=30
                         ).solve(torch.tensor([1.0, 0.0]),
                                 torch.from_numpy(t), torch.from_numpy(y)).x
    jmesh = j_mesh(JSpec(**{k: getattr(spec, k) for k in
                            ("batch", "tile", "dsh")}), jax.devices()[:8])
    want = np.asarray(j_dist(_jres, jnp.asarray([1.0, 0.0]),
                             (jnp.asarray(t), jnp.asarray(y)), jmesh, axis,
                             iters=30))
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), [2.0, -1.3], atol=1e-2)


def test_distributed_gn_shards_and_refusal():
    """Explicit shards (unequal sizes) give the single-device answer; an
    axis that does not divide the observations is refused."""
    t, y = _data(60)
    tt, yy = torch.from_numpy(t), torch.from_numpy(y)
    cuts = [0, 7, 20, 41, 60]
    shards = [(tt[a:b], yy[a:b]) for a, b in zip(cuts, cuts[1:])]
    got = distributed_gauss_newton(_tres, torch.tensor([1.0, 0.0]), shards,
                                   iters=30)
    single = GaussNewton(lambda p, a, b: _tres(p, (a, b)), iters=30).solve(
        torch.tensor([1.0, 0.0]), tt, yy).x
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=1e-5,
                               atol=1e-5)
    mesh = make_stereo_mesh(MeshSpec(batch=8), ["cpu"] * 8)
    with pytest.raises(ValueError):
        distributed_multiview_alignment(_tres, torch.zeros(2), (tt, yy),
                                        mesh, "batch")


def _block_system(P, k, s, seed):
    rng = np.random.default_rng(seed)
    n = P + k * s
    Jm = rng.normal(size=(4 * n, n)).astype(np.float32)
    r = rng.normal(size=4 * n).astype(np.float32)
    JtJ = Jm.T @ Jm + 0.1 * np.eye(n, dtype=np.float32)
    b = Jm.T @ r
    blocks = np.stack([JtJ[P + i * s:P + (i + 1) * s, P + i * s:P + (i + 1) * s]
                       for i in range(k)])
    full = JtJ.copy()
    full[P:, P:] = 0
    for i in range(k):
        full[P + i * s:P + (i + 1) * s, P + i * s:P + (i + 1) * s] = blocks[i]
    return (JtJ[:P, :P], JtJ[:P, P:].reshape(P, k, s), blocks, b[:P],
            b[P:].reshape(k, s), full, b)


@pytest.mark.parametrize("P,k,s", [(4, 5, 3), (6, 12, 2)])
def test_schur_solve_matches_dense_and_jax(P, k, s):
    """dp and ds against numpy's dense solve of the block system (1e-3, as
    the JAX test) and against JAX's `schur_complement_solve` (1e-4)."""
    from libstevi_tpu.parallel.schur import schur_complement_solve as j_schur
    pp, ps, blocks, bp, bs, full, b = _block_system(P, k, s, P + k)
    want = np.linalg.solve(full.astype(np.float64)
                           + 1e-8 * np.eye(P + k * s), b)
    dp, ds = schur_complement_solve(*(torch.from_numpy(np.ascontiguousarray(x))
                                      for x in (pp, ps, blocks, bp, bs)))
    np.testing.assert_allclose(dp.numpy(), want[:P], atol=1e-3)
    np.testing.assert_allclose(ds.numpy().ravel(), want[P:], atol=1e-3)
    jdp, jds = j_schur(*(jnp.asarray(x) for x in (pp, ps, blocks, bp, bs)))
    np.testing.assert_allclose(dp.numpy(), np.asarray(jdp), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(ds.numpy(), np.asarray(jds), rtol=1e-4,
                               atol=1e-4)
