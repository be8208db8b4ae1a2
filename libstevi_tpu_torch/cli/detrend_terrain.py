"""Detrend the terrain out of a point cloud, on the device (the port's
counterpart of `cli/detrend_terrain.py`).

Reference parity: `examples/detrend_terrain_in_pt_cloud/main.cpp` —
rasterize the minimum z per XY tile (the terrain estimate), fill empty
tiles, and subtract the sampled terrain from every point's z, writing a
cloud whose heights are relative to the local ground (`detrend`).  The
arguments and the JSON report are the JAX tool's, plus ``--device``
(default ``cuda``; without a GPU that is an error, never a silent CPU
run).

  python -m libstevi_tpu_torch.cli.detrend_terrain cloud.las -o flat.las
      --tile 5.0 [--smooth 1.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .stereo_refine import device_arg


def detrend(pos: torch.Tensor, tile: float, smooth: float):
    """The tool's steps on (N, 3) float64 positions.  Returns (the
    detrended z (N,) float64, the min-z raster (ni, nj) float64 with +inf
    in empty tiles, the terrain (ni, nj) float32).

    The dtypes are the JAX tool's: the tile indices and the per-tile
    minimum in float64 (``scatter_reduce`` 'amin', exact in any order, so
    the raster is `np.minimum.at`'s), the fill and the blur in float32,
    and the float32 terrain subtracted from the float64 z.  The tile
    indices divide by the tile as a tensor: CUDA turns a division by a
    Python number into a product with its reciprocal, which moves a
    floor at a tile's edge."""
    from ..imageproc import gaussian_blur
    from ..imageproc.inpainting import nearest_neighbor_inpainting

    t = torch.tensor(tile, dtype=torch.float64, device=pos.device)
    gi = torch.floor((pos[:, 0] - pos[:, 0].min()) / t).long()
    gj = torch.floor((pos[:, 1] - pos[:, 1].min()) / t).long()
    ni, nj = int(gi.max()) + 1, int(gj.max()) + 1

    zmap = torch.full((ni * nj,), torch.inf, dtype=torch.float64,
                      device=pos.device)
    zmap.scatter_reduce_(0, gi * nj + gj, pos[:, 2], "amin")
    zmap = zmap.reshape(ni, nj)
    empty = ~torch.isfinite(zmap)
    if bool(empty.any()):
        filled = nearest_neighbor_inpainting(
            torch.where(empty, 0.0, zmap).float(), empty)
    else:
        filled = zmap.float()
    if smooth > 0 and min(ni, nj) > 2:
        filled = gaussian_blur(filled, smooth)
    return pos[:, 2] - filled[gi, gj].double(), zmap, filled


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("cloud")
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("--tile", type=float, default=5.0,
                    help="terrain raster tile size (cloud units)")
    ap.add_argument("--smooth", type=float, default=1.0,
                    help="gaussian sigma (tiles) applied to the terrain")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..io.pointcloud_io import (open_point_cloud, PointCloud,
                                    save_point_cloud)

    cloud = open_point_cloud(args.cloud)
    pos = cloud.positions
    z, zmap, terrain = detrend(torch.from_numpy(pos).to(dev), args.tile,
                               args.smooth)
    new_pos = pos.copy()
    new_pos[:, 2] = z.cpu().numpy()
    save_point_cloud(args.output, PointCloud(new_pos, cloud.attributes))
    terrain = terrain.cpu().numpy()
    print(json.dumps({
        "n_points": int(len(pos)),
        "raster": list(zmap.shape),
        "terrain_range": [float(terrain.min()), float(terrain.max())],
        "z_after": [float(new_pos[:, 2].min()), float(new_pos[:, 2].max())],
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
