"""Distributed dense-stereo pipelines over a stereo mesh (counterpart of
`libstevi_tpu/parallel/stereo.py`).

Three sharding modes, composable on the (batch, tile, dsh) mesh of
`mesh.py`:

  * batch — pairs split over ``batch``; no communication;
  * tile  — image rows split over ``tile``: halo rows for the cost volume's
    window (`halo.halo_exchange_rows`), carry relays for SGM
    (`sgm_dist`);
  * dsh   — the disparity axis split over ``dsh``: each member builds its
    sub-range of the cost volume, and the WTA (`dshard_wta`) or the SGM
    input (`distributed_full_step`) reassembles it, keeping the
    reference's ties-toward-the-last-global-index rule.

The JAX functions are `shard_map`s driven by one program; here one Python
controller loops over the per-shard tensors, each on its mesh device, and
moves a neighbour's rows, a relayed carry or a gathered volume with
``.to(device)``.  Each step returns a callable on global (B, H, W) (or
(H, W)) tensors, as the jitted `shard_map` does; the result lies on the
inputs' device.  The per-shard cost volume comes from
`ops.unfold_based_cost_volume`, so a dot-family cost on CUDA runs K1.
"""

from __future__ import annotations

import torch

from ..core.search import SearchOffset1
from ..core.types import (DispDirection, ExtractionStrategy, MATCH_TRAITS,
                          MatchingFunction, disp_dtype)
from ..ops.cost_volume import (extract_selected_index,
                               normalize_feature_volume,
                               unfold_based_cost_volume)
from ..ops.matching import feature_comparison
from ..ops.unfold import unfold
from .halo import halo_exchange_rows
from .mesh import StereoMesh
from .sgm_dist import distributed_sgm_routed


def _row_split(x: torch.Tensor, devices) -> list:
    """x split into len(devices) row blocks, block k on devices[k]."""
    return [blk.to(dev) for blk, dev in
            zip(torch.tensor_split(x, len(devices), dim=0), devices)]


def _local_cv_with_halo(func, l_shards, r_shards, h_radius, v_radius,
                        disp_width) -> list:
    """Each shard's cost-volume rows, exact at the seams through v_radius
    halo rows (the window's context); at the image's top and bottom the
    zero halo reproduces the unfold zero fill."""
    halo = v_radius
    l_ext = halo_exchange_rows(l_shards, halo, halo)
    r_ext = halo_exchange_rows(r_shards, halo, halo)
    return [unfold_based_cost_volume(func, le, re, h_radius, v_radius,
                                     disp_width)[halo:halo + x.shape[0]]
            for le, re, x in zip(l_ext, r_ext, l_shards)]


def _wta_last_tie(cv, strategy) -> torch.Tensor:
    return extract_selected_index(cv, strategy).to(disp_dtype)


def dshard_wta(shards, strategy: ExtractionStrategy) -> torch.Tensor:
    """WTA over a D-sharded cost volume: a tie-last WTA on each (H, W, D_k)
    shard, then a reduction across shards in which a later shard wins a
    tie, so the global index is the last optimal one (the D axis is split
    contiguously, shards in disparity order).  Returns the global selected
    index (H, W) on the first shard's device."""
    dev = shards[0].device
    vals, idxs, d0 = [], [], 0
    for cv in shards:
        idx = _wta_last_tie(cv, strategy)
        vals.append(torch.gather(cv, -1, idx.long()[..., None])[..., 0]
                    .to(dev))
        idxs.append((idx + d0).to(dev))
        d0 += cv.shape[-1]
    vals, idxs = torch.stack(vals), torch.stack(idxs)
    flipped = torch.flip(vals, (0,))
    pick = (torch.argmin(flipped, 0) if strategy is ExtractionStrategy.COST
            else torch.argmax(flipped, 0))
    sel = vals.shape[0] - 1 - pick
    return torch.gather(idxs, 0, sel[None])[0]


def distributed_cost_volume_wta(mesh: StereoMesh, func: MatchingFunction,
                                h_radius: int, v_radius: int,
                                disp_width: int):
    """(img_l, img_r) -> selected disparity index, with rows split over the
    ``tile`` axis (devices ``mesh.devices[0, :, 0]``).  Images are (H, W);
    each shard must hold at least v_radius rows."""
    strategy = MATCH_TRAITS[func].strategy
    devs = mesh.tile_devices()

    def fn(img_l: torch.Tensor, img_r: torch.Tensor) -> torch.Tensor:
        cvs = _local_cv_with_halo(func, _row_split(img_l, devs),
                                  _row_split(img_r, devs), h_radius,
                                  v_radius, disp_width)
        return torch.cat([_wta_last_tie(cv, strategy).to(img_l.device)
                          for cv in cvs])

    return fn


def _sgm_wta(cv_shards, strategy, P1, P2, n_directions, out_device):
    """Distributed SGM (`sgm_dist.distributed_sgm_routed`; SCORE volumes
    run negated), tie-last WTA and the disparity sign of RIGHT_TO_LEFT,
    gathered to ``out_device``."""
    sign = DispDirection.RIGHT_TO_LEFT.delta_sign
    if strategy is ExtractionStrategy.SCORE:
        sgm = [-x for x in distributed_sgm_routed(
            [-c for c in cv_shards], P1, P2, n_directions=n_directions)]
    else:
        sgm = distributed_sgm_routed(cv_shards, P1, P2,
                                     n_directions=n_directions)
    return torch.cat([(sign * _wta_last_tie(x, strategy)).to(disp_dtype)
                      .to(out_device) for x in sgm])


def distributed_dense_stereo_step(mesh: StereoMesh, func: MatchingFunction,
                                  h_radius: int, v_radius: int,
                                  disp_width: int, P1: float, P2: float,
                                  n_directions: int = 4):
    """The distributed pipeline step: pairs over ``batch``, rows over
    ``tile``: cost volume with halo rows -> 4/8/16-direction SGM (carry
    relay, `sgm_dist.distributed_sgm_routed`) -> tie-last WTA -> disparity.
    Input (B, H, W) pairs; output (B, H, W) disparities.  B and H need not
    divide their axes (`_pad_to_mesh`)."""
    strategy = MATCH_TRAITS[func].strategy

    def pair_fn(img_l, img_r, b):
        devs = mesh.tile_devices(b)
        cvs = _local_cv_with_halo(func, _row_split(img_l, devs),
                                  _row_split(img_r, devs), h_radius,
                                  v_radius, disp_width)
        return _sgm_wta(cvs, strategy, P1, P2, n_directions, img_l.device)

    return _pad_to_mesh(_batch_over_mesh(mesh, pair_fn), mesh)


def _batch_over_mesh(mesh: StereoMesh, pair_fn):
    """(B, H, W) pairs -> (B, H, W): group b of the ``batch`` axis takes
    pairs [b * B / n, (b + 1) * B / n), ``pair_fn(img_l, img_r, b)`` (B
    divides the axis: `_pad_to_mesh` pads it)."""
    n_b = mesh.shape["batch"]

    def inner(imgs_l, imgs_r):
        per = imgs_l.shape[0] // n_b
        return torch.stack([pair_fn(imgs_l[p], imgs_r[p], b)
                            for b in range(n_b)
                            for p in range(b * per, (b + 1) * per)])

    return inner


def distributed_full_step(mesh: StereoMesh, func: MatchingFunction,
                          h_radius: int, v_radius: int, disp_width: int,
                          P1: float, P2: float, n_directions: int = 4):
    """The multi-device step over every mesh axis: pairs over ``batch``,
    rows over ``tile`` (halo rows for the cost volume, carry relay for
    SGM), and over ``dsh`` each member builds the cost volume of its own
    disparity sub-range, reassembled on the tile shard's first member
    before SGM.  Works for every matching family (the D-shard pre-shift
    reproduces each one's out-of-range convention); B, H and D need not
    divide their axes (`_pad_to_mesh`, and ceil(D / dsh) disparities a
    member with the surplus sliced off).  Input (B, H, W) pairs; output
    (B, H, W) disparities."""
    strategy = MATCH_TRAITS[func].strategy
    n_dsh = mesh.shape["dsh"]
    d_loc = -(-disp_width // n_dsh)
    d_total = d_loc * n_dsh
    halo = v_radius        # the window needs v_radius rows of context
    ctx = h_radius

    def member_cv(l_ext, r_ext, H_loc, d0):
        """One dsh member's cost volume, disparities [d0, d0 + d_loc).
        RIGHT_TO_LEFT samples the target (left image) at j + d, so the
        target pre-shifted by d0 and searched over [0, d_loc) is the global
        search over [d0, d0 + d_loc).  Both images are widened by h_radius
        columns on the left, so the shifted target keeps its real left
        context (original columns [d0 - h_radius, d0)), and the extra
        columns are cropped after aggregation.  Where j + d >= W the
        reference compares the source with an all-zero target vector
        (`aggregateCost`): cost(src, 0), which the widened target's zero
        windows would not give, so those entries are set to it."""
        W = l_ext.shape[1]
        src_w = torch.nn.functional.pad(r_ext, (ctx, 0))
        l_buf = torch.nn.functional.pad(l_ext, (ctx, d_total))
        tgt_w = l_buf[:, d0:d0 + W + ctx]
        cv = unfold_based_cost_volume(func, tgt_w, src_w, h_radius, v_radius,
                                      SearchOffset1(0, d_loc - 1))
        cv = cv[halo:halo + H_loc, ctx:]
        src_fv = normalize_feature_volume(
            func, unfold(h_radius, v_radius, r_ext))[halo:halo + H_loc]
        oob = feature_comparison(func, src_fv, torch.zeros_like(src_fv))
        jj = torch.arange(W, device=cv.device)[None, :, None]
        dd = torch.arange(d_loc, device=cv.device)[None, None, :]
        return torch.where(jj + d0 + dd >= W, oob[..., None].to(cv.dtype),
                           cv)

    def pair_fn(img_l, img_r, b):
        devs = mesh.tile_devices(b)
        l_ext = halo_exchange_rows(_row_split(img_l, devs), halo, halo)
        r_ext = halo_exchange_rows(_row_split(img_r, devs), halo, halo)
        cvs = []
        for t, (le, re) in enumerate(zip(l_ext, r_ext)):
            H_loc = le.shape[0] - 2 * halo
            members = [member_cv(le.to(dev), re.to(dev), H_loc, s * d_loc)
                       for s, dev in enumerate(mesh.devices[b, t, :])]
            # the all-gather along dsh, onto the tile shard's first member
            cvs.append(torch.cat([m.to(devs[t]) for m in members],
                                 dim=-1)[..., :disp_width])
        return _sgm_wta(cvs, strategy, P1, P2, n_directions, img_l.device)

    return _pad_to_mesh(_batch_over_mesh(mesh, pair_fn), mesh)


def _pad_to_mesh(inner, mesh: StereoMesh):
    """Lift the B % batch and H % tile divisibility requirements by zero
    padding before ``inner`` and slicing after.  Padded pairs are dropped
    exactly; padded rows take part in the SGM vertical passes, so for an H
    that does not divide, the result is the single-device pipeline's on
    the bottom-zero-padded image (exact when H divides)."""

    n_batch, n_tile = mesh.shape["batch"], mesh.shape["tile"]

    def run(imgs_l: torch.Tensor, imgs_r: torch.Tensor) -> torch.Tensor:
        B, H, _ = imgs_l.shape
        bp, hp = (-B) % n_batch, (-H) % n_tile
        if bp or hp:
            pad = (0, 0, 0, hp, 0, bp)
            out = inner(torch.nn.functional.pad(imgs_l, pad),
                        torch.nn.functional.pad(imgs_r, pad))
            return out[:B, :H]
        return inner(imgs_l, imgs_r)

    return run
