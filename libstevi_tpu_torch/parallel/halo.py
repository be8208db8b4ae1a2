"""Halo exchange along the row-sharded image axis (counterpart of
`libstevi_tpu/parallel/halo.py`).

Each shard takes its neighbours' boundary rows, zeros at the global image
edges (the engine's zero-padding convention), so window operations on the
extended block are exact.  The shards are a list of row blocks in image
order; each neighbour's rows move to the receiving shard's device.
"""

from __future__ import annotations

import torch


def halo_exchange_rows(shards, halo_up: int, halo_down: int) -> list:
    """Each (H_loc, ...) shard extended with ``halo_up`` rows of the
    previous shard and ``halo_down`` rows of the next one (zeros at the
    global boundary).  The halo may not exceed a shard's height: the
    exchange reaches only the immediate neighbours, so a larger request
    would splice the wrong rows in."""
    h_min = min(x.shape[0] for x in shards)
    if max(halo_up, halo_down) > h_min:
        raise ValueError(
            f"halo ({max(halo_up, halo_down)}) exceeds the local shard "
            f"height ({h_min}); use more rows per shard or a smaller "
            f"window radius")
    n = len(shards)
    out = []
    for k, x in enumerate(shards):
        parts = []
        if halo_up > 0:
            top = (shards[k - 1][-halo_up:].to(x.device) if k > 0
                   else x.new_zeros((halo_up,) + x.shape[1:]))
            parts.append(top)
        parts.append(x)
        if halo_down > 0:
            bot = (shards[k + 1][:halo_down].to(x.device) if k < n - 1
                   else x.new_zeros((halo_down,) + x.shape[1:]))
            parts.append(bot)
        out.append(torch.cat(parts, dim=0))
    return out
