"""Checkpoint / resume for long-running solves (counterpart of
`libstevi_tpu/utils/checkpointing.py`).

A checkpoint is the JAX package's file: ``ckpt_dir/step_<N>.npz`` (N
zero-padded to 8 digits) holding one array a leaf as ``leaf_<i>``,
written to a temporary name and renamed, so a reader never sees half a
file.  The leaves are numbered in `jax.tree_util`'s order, so a file
written by either package loads in the other:

- a dict's children go in sorted key order (torch's pytree keeps the
  insertion order), an OrderedDict's in its own order;
- ``None`` is an empty node, not a leaf (torch's pytree counts it);
- lists and tuples (named tuples too) keep their order;
- anything else is a leaf: tensors, numpy arrays, Python numbers.

A bfloat16 leaf is stored as its raw 16-bit patterns, numpy type ``|V2``,
which is what the JAX package's file holds for one (numpy has no
bfloat16); it loads back into a bfloat16 ``like`` leaf bit for bit.
"""

from __future__ import annotations

import os
import re
from collections import OrderedDict

import numpy as np
import torch


def _keys(d: dict) -> list:
    return list(d) if isinstance(d, OrderedDict) else sorted(d)


def _flatten(tree) -> list:
    """The leaves of ``tree`` in `jax.tree_util.tree_flatten`'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in _keys(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for child in tree for leaf in _flatten(child)]
    return [tree]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``, each converted by `_restore`."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in _keys(like)}
        return type(like)((k, vals[k]) for k in like)
    if isinstance(like, (list, tuple)):
        children = [_unflatten(c, leaves) for c in like]
        if hasattr(like, "_fields"):                 # a named tuple
            return type(like)(*children)
        return type(like)(children)
    try:
        arr = next(leaves)
    except StopIteration:
        raise ValueError("the checkpoint holds fewer leaves than the "
                         "`like` tree") from None
    return _restore(arr, like)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _restore(arr: np.ndarray, like):
    """A stored array as ``like``: a tensor on ``like``'s device with its
    dtype where ``like`` is a tensor, else the array itself (as the JAX
    package returns it)."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or like.dtype != torch.bfloat16:
            raise ValueError(f"a raw {arr.dtype} leaf loads only into a "
                             f"bfloat16 leaf, not {like.dtype}")
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return t.view(torch.bfloat16).to(like.device)
    return torch.from_numpy(np.array(arr)).to(device=like.device,
                                              dtype=like.dtype)


def save_checkpoint(ckpt_dir: str, step: int, tree) -> str:
    """Write pytree ``tree`` as ``ckpt_dir/step_<N>.npz`` (atomic)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = _flatten(tree)
    path = os.path.join(ckpt_dir, f"step_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{f"leaf_{i}": _to_numpy(l)
                     for i, l in enumerate(leaves)})
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str):
    """(step, path) of the newest checkpoint, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.npz", name)
        if m:
            s = int(m.group(1))
            if best is None or s > best[0]:
                best = (s, os.path.join(ckpt_dir, name))
    return best


def load_checkpoint(path: str, like=None):
    """Load a checkpoint; with ``like`` (an example pytree) the leaves are
    restored into its structure, each tensor leaf on the ``like`` leaf's
    device and dtype, else a list of numpy arrays is returned."""
    with np.load(path) as z:
        n = sum(1 for k in z.files if k.startswith("leaf_"))
        leaves = [z[f"leaf_{i}"] for i in range(n)]
    if like is None:
        return leaves
    if len(leaves) != len(_flatten(like)):
        raise ValueError(f"the checkpoint holds {len(leaves)} leaves, the "
                         f"`like` tree {len(_flatten(like))}")
    return _unflatten(like, iter(leaves))


def resumable_iterate(step_fn, state, total_steps: int, ckpt_dir: str,
                      checkpoint_every: int = 1):
    """Run ``state = step_fn(state)`` ``total_steps`` times, checkpointing
    every ``checkpoint_every`` steps and resuming from the newest
    checkpoint in ``ckpt_dir`` if one exists.  Returns the final state.

    The wrapper for long Gauss-Newton / bundle-adjustment runs:
    ``step_fn`` is typically a chunk of inner iterations, so the host
    loop (and checkpoint IO) happens once per chunk, not per iteration."""
    start = 0
    latest = latest_checkpoint(ckpt_dir)
    if latest is not None:
        start, path = latest
        state = load_checkpoint(path, like=state)
    for step in range(start, total_steps):
        state = step_fn(state)
        if (step + 1) % checkpoint_every == 0 or step + 1 == total_steps:
            save_checkpoint(ckpt_dir, step + 1, state)
    return state
