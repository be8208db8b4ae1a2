"""The port's distributed pipeline steps (`libstevi_tpu_torch/parallel/
stereo.py`, `entry.dryrun_multichip`) against the JAX package's same steps
on the CPU, the JAX side on the virtual CPU devices of `tests/conftest.py`
(Pallas in interpret mode), at `tests/test_parallel.py`'s shapes.  Indices
are held exactly where that file holds them exactly, and to an agreement
above 0.99 where it uses that bar."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from libstevi_tpu.core import MatchingFunction as JMF
from libstevi_tpu.parallel import MeshSpec as JMeshSpec
from libstevi_tpu.parallel import make_stereo_mesh as j_mesh
from libstevi_tpu.parallel.stereo import (
    distributed_dense_stereo_step as j_dense_step,
    distributed_full_step as j_full_step)
from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.parallel import MeshSpec, make_stereo_mesh
from libstevi_tpu_torch.parallel.stereo import (distributed_dense_stereo_step,
                                                distributed_full_step)

torch.set_num_threads(2)
pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
H, W, D = 32, 24, 8


def _pairs(rng, B, h=H, w=W):
    return tuple(rng.uniform(0.1, 1, (B, h, w)).astype(np.float32)
                 for _ in range(2))


def _both(step, j_step, axes, func, args, kw, ls, rs):
    """(port, JAX) disparities of one step on the same pairs."""
    spec = MeshSpec(**axes)
    jm = j_mesh(JMeshSpec(**axes), jax.devices()[:spec.n_devices])
    want = np.asarray(j_step(jm, JMF[func], *args, **kw)(jnp.asarray(ls),
                                                          jnp.asarray(rs)))
    mesh = make_stereo_mesh(spec, ["cpu"] * spec.n_devices)
    got = step(mesh, MatchingFunction[func], *args, **kw)(
        torch.from_numpy(ls), torch.from_numpy(rs)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    return got, want


# (step, mesh axes, function, (h, v, D, P1, P2), n_directions, exact)
CASES = {
    "dense_census_b2t4": ("dense", dict(batch=2, tile=4), "CENSUS",
                          (2, 2, D, 2.0, 8.0), 4, True),
    "full_zncc_b2t2d2": ("full", dict(batch=2, tile=2, dsh=2), "ZNCC",
                         (2, 2, D, 0.1, 0.4), 4, True),
    "full_zncc_8dir": ("full", dict(batch=2, tile=2, dsh=2), "ZNCC",
                       (1, 1, D, 0.1, 0.5), 8, False),
    "full_zssd": ("full", dict(batch=1, tile=2, dsh=2), "ZSSD",
                  (1, 1, D, 0.1, 0.5), 4, False),
    "full_sad": ("full", dict(batch=1, tile=2, dsh=2), "SAD",
                 (1, 1, D, 0.1, 0.5), 4, False),
    "full_census": ("full", dict(batch=1, tile=2, dsh=2), "CENSUS",
                    (1, 1, D, 0.1, 0.5), 4, False),
    "dense_zncc_8dir": ("dense", dict(batch=2, tile=2), "ZNCC",
                        (1, 1, D, 0.1, 0.5), 8, False),
    "dense_zncc_16dir": ("dense", dict(batch=2, tile=2), "ZNCC",
                         (1, 1, D, 0.1, 0.5), 16, False),
}


@pytest.mark.parametrize("case", list(CASES))
def test_step_matches_jax(rng, case):
    kind, axes, func, args, nd, exact = CASES[case]
    step, j_step = ((distributed_full_step, j_full_step) if kind == "full"
                    else (distributed_dense_stereo_step, j_dense_step))
    B = 2 if axes.get("batch", 1) == 2 else 1
    ls, rs = _pairs(rng, B)
    got, want = _both(step, j_step, axes, func, args,
                      dict(n_directions=nd), ls, rs)
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert (got == want).mean() > 0.99, (got == want).mean()


def test_full_step_16dir_matches_jax(rng):
    ls, rs = _pairs(rng, 1, 16, 24)
    got, want = _both(distributed_full_step, j_full_step,
                      dict(batch=1, tile=2, dsh=2), "ZNCC",
                      (1, 1, D, 0.1, 0.5), dict(n_directions=16), ls, rs)
    assert (got == want).mean() > 0.99


def test_full_step_non_divisible_shapes_match_jax(rng):
    """B = 3, H = 30 and D = 7 divide none of the (2, 2, 2) axes."""
    ls, rs = _pairs(rng, 3, 30)
    got, want = _both(distributed_full_step, j_full_step,
                      dict(batch=2, tile=2, dsh=2), "ZNCC",
                      (1, 1, 7, 0.1, 0.5), dict(n_directions=4), ls, rs)
    assert got.shape == (3, 30, W)
    assert (got == want).mean() > 0.99


def test_dryrun_multichip_matches_jax():
    """`entry.dryrun_multichip(8)` on 8 virtual CPU shards: the (2, 2, 2)
    factoring at 96x256, D = 32, ZNCC 7x7, SGM-8, against the JAX package's
    `distributed_full_step` on the same pairs and mesh shape (the JAX
    `dryrun_multichip` returns nothing); 4, 3 and 2 shards factor as the
    JAX entry does."""
    out = entry.dryrun_multichip(8, device="cpu")
    assert out.shape == (4, 96, 256) and out.dtype == torch.int32
    rng = np.random.default_rng(1)                 # the entry's pairs
    ls, rs = (rng.uniform(0, 1, (4, 96, 256)).astype(np.float32)
              for _ in range(2))
    jm = j_mesh(JMeshSpec(batch=2, tile=2, dsh=2), jax.devices()[:8])
    want = np.asarray(j_full_step(jm, JMF.ZNCC, 3, 3, 32, P1=0.1, P2=0.5,
                                  n_directions=8)(jnp.asarray(ls),
                                                  jnp.asarray(rs)))
    assert (out.numpy() == want).mean() > 0.99
    assert entry._factor(4) == MeshSpec(batch=1, tile=2, dsh=2)
    assert entry._factor(3) == MeshSpec(batch=1, tile=3, dsh=1)
    assert entry._factor(2) == MeshSpec(batch=1, tile=2, dsh=1)
