"""Split a point cloud into spatial tiles with context margins, the port's
counterpart of `cli/split_pt_cloud.py` (numpy on the host, as there; the
same arguments and JSON report).

Reference parity: `examples/split_pt_cloud_with_context/main.cpp` — cut
the cloud into an XY grid of tiles; each tile's file also carries the
points within a context radius of its bounding box (so per-tile
processing sees its neighbourhood), written after the tile's own points.

  python -m libstevi_tpu_torch.cli.split_pt_cloud cloud.las -o tiles/tile
      -n 2 2 -c 5.0
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("cloud")
    ap.add_argument("-o", "--output-prefix", required=True,
                    help="tiles written as <prefix>_<i>_<j>.<ext>")
    ap.add_argument("-n", "--grid", type=int, nargs=2, default=(2, 2),
                    help="tiles along x and y")
    ap.add_argument("-c", "--context", type=float, default=0.0,
                    help="context margin around each tile's box")
    ap.add_argument("--format", default=None, choices=[None, "las", "pcd"])
    args = ap.parse_args(argv)

    from ..io.pointcloud_io import (open_point_cloud, PointCloud,
                                    save_point_cloud)

    cloud = open_point_cloud(args.cloud)
    pos = cloud.positions
    nx, ny = args.grid
    ext = args.format or os.path.splitext(args.cloud)[1].lstrip(".") or "las"

    x0, y0 = pos[:, 0].min(), pos[:, 1].min()
    x1, y1 = pos[:, 0].max(), pos[:, 1].max()
    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)

    tiles = []
    for i in range(nx):
        for j in range(ny):
            lo = np.asarray([xs[i], ys[j]])
            hi = np.asarray([xs[i + 1], ys[j + 1]])
            own = ((pos[:, 0] >= lo[0]) & (pos[:, 1] >= lo[1])
                   & (pos[:, 0] <= hi[0] + (i == nx - 1))
                   & (pos[:, 1] <= hi[1] + (j == ny - 1)))
            c = args.context
            ctx = ((pos[:, 0] >= lo[0] - c) & (pos[:, 1] >= lo[1] - c)
                   & (pos[:, 0] <= hi[0] + c) & (pos[:, 1] <= hi[1] + c)
                   & ~own)
            order = np.concatenate([np.nonzero(own)[0], np.nonzero(ctx)[0]])
            attrs = {k: np.asarray(v)[order]
                     for k, v in cloud.attributes.items()}
            attrs["is_context"] = np.concatenate(
                [np.zeros(int(own.sum()), np.uint8),
                 np.ones(int(ctx.sum()), np.uint8)])
            tile = PointCloud(pos[order], attrs)
            path = f"{args.output_prefix}_{i}_{j}.{ext}"
            save_point_cloud(path, tile)
            tiles.append({"path": path, "n_own": int(own.sum()),
                          "n_context": int(ctx.sum())})
    print(json.dumps({"n_points": int(len(pos)), "tiles": tiles}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
