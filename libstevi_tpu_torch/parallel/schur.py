"""Distributed Gauss-Newton with Schur-complement reduction (counterpart of
`libstevi_tpu/parallel/schur.py`).

No reference counterpart (the reference's alignment solvers are single-host,
`pointcloudalignment.h:739`, `genericraysalignement.h:71`); this is the
multi-device scale-out named in SURVEY.md §2.8: observations are sharded
over a mesh axis, each shard accumulates its partial normal equations
(J^T J, J^T r) on its own device, the partials are summed in a fixed shard
order on the first shard's device (the JAX package's `psum`), and the one
delta goes back to every shard: communication is O(params^2) per
iteration regardless of observation count.  One controller drives the
shards, as everywhere in `parallel/`; a mesh may repeat a device.

For structure+pose problems, `schur_complement_solve` eliminates the
(block-diagonal) structure block first, so the distributed solve only
reduces the pose-block system.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..optim.gauss_newton import damped_step, normal_equations
from ..optim.ransac import tree_leaves, tree_map


def distributed_gauss_newton(residual_fn: Callable, x0: torch.Tensor,
                             shards: Sequence, iters: int = 25,
                             damping: float = 1e-8) -> torch.Tensor:
    """``shards``: one data tree a shard, each on its shard's device (the
    device of its first tensor); ``residual_fn(x, data) -> (m_local,)``
    local residuals.  Each step sums the shards' (J^T J, J^T r) in shard
    order on the first shard's device and solves there.  Returns the
    parameters on that device."""
    devs = [tree_leaves(s)[0].device for s in shards]
    x = x0.to(devs[0])
    for _ in range(iters):
        JtJ = Jtr = None
        for dev, data in zip(devs, shards):
            a, b = normal_equations(residual_fn, x.to(dev), data)
            a, b = a.to(devs[0]), b.to(devs[0])
            JtJ = a if JtJ is None else JtJ + a
            Jtr = b if Jtr is None else Jtr + b
        x = x - damped_step(JtJ, Jtr, damping)
    return x


def schur_complement_solve(JtJ_pp, JtJ_ps, JtJ_ss_blocks, b_p, b_s_blocks,
                           damping: float = 1e-8):
    """Solve the two-block normal system

        [ JtJ_pp   JtJ_ps ] [dp]   [b_p]
        [ JtJ_ps^T  JtJ_ss] [ds] = [b_s]

    where JtJ_ss is block diagonal with (k, s, s) blocks (one per structure
    element, e.g. 3x3 point blocks): eliminate ds, solve the reduced pose
    system, back-substitute.  JtJ_ps is (P, k, s) (pose-to-structure
    coupling per element), b_s_blocks (k, s).  The (k, s, s) blocks invert
    in one batched `torch.linalg.inv`.
    """
    P = JtJ_pp.shape[0]
    k, s, _ = JtJ_ss_blocks.shape
    opts = dict(dtype=JtJ_pp.dtype, device=JtJ_pp.device)
    inv_ss = torch.linalg.inv(JtJ_ss_blocks + damping * torch.eye(s, **opts))

    # S = JtJ_pp - sum_k E_k C_k^-1 E_k^T ; rhs = b_p - sum_k E_k C_k^-1 b_k
    E_Cinv = torch.einsum("pks,kst->pkt", JtJ_ps, inv_ss)     # (P, k, s)
    S = JtJ_pp - torch.einsum("pkt,qkt->pq", E_Cinv, JtJ_ps)
    rhs = b_p - torch.einsum("pkt,kt->p", E_Cinv, b_s_blocks)
    dp = torch.linalg.solve(S + damping * torch.eye(P, **opts), rhs)

    ds = torch.einsum("kst,kt->ks", inv_ss,
                      b_s_blocks - torch.einsum("pks,p->ks", JtJ_ps, dp))
    return dp, ds


def distributed_multiview_alignment(residual_fn: Callable, x0: torch.Tensor,
                                    data, mesh, axis_name: str = "batch",
                                    iters: int = 25, damping: float = 1e-8):
    """Distributed GN over one axis of ``mesh`` (a `StereoMesh`):
    observations (the leading axis of every tensor of ``data``) split
    into equal shards over the devices along ``axis_name`` (the other
    axes at index 0), as the JAX package's shard_map places them."""
    from .mesh import AXES
    n = mesh.shape[axis_name]
    pick = [0] * len(AXES)
    devs = []
    for i in range(n):
        pick[AXES.index(axis_name)] = i
        devs.append(torch.device(mesh.devices[tuple(pick)]))
    N = tree_leaves(data)[0].shape[0]
    if N % n:
        raise ValueError(f"{N} observations do not split into {n} shards")
    m = N // n
    shards = [tree_map(lambda t: t[i * m:(i + 1) * m].to(devs[i]), data)
              for i in range(n)]
    return distributed_gauss_newton(residual_fn, x0, shards, iters, damping)
