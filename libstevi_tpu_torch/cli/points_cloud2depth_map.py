"""Project a point cloud into a camera depth map, on the device (the
port's counterpart of `cli/points_cloud2depth_map.py`).

Reference parity: `examples/points_cloud2depth_map/main.cpp` — load a
cloud, transform into a camera frame, project through a pinhole model,
z-buffer rasterize, then fill holes by inpainting.  The reference walks a
BSP per pixel; this rasterizes all points at once with a scatter-min
z-buffer (`project_depth`), as the JAX tool does.  The arguments and the
JSON report are the JAX tool's, plus ``--device`` (default ``cuda``;
without a GPU that is an error, never a silent CPU run).

  python -m libstevi_tpu_torch.cli.points_cloud2depth_map cloud.las \\
      depth.stevimg --size 480 640 --f 500 --pp 320 240 \\
      [--rvec rx ry rz --t tx ty tz] [--inpaint] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .stereo_refine import device_arg


def project_depth(pts: torch.Tensor, size, f: float, pp=None,
                  rvec=(0.0, 0.0, 0.0), t=(0.0, 0.0, 0.0)):
    """Z-buffer of (N, 3) float32 world points seen by a pinhole camera
    of focal ``f`` and principal point ``pp`` (the image centre where
    None) after the world -> camera transform ``R(rvec) p + t``.

    Returns (depth (H, W) float32, +inf where no point lands; the share
    of pixels a point reached, a 0-d float32 tensor), both on ``pts``'s
    device, without a host read.

    The transform is written out as elementwise products and sums (x * R
    row, added in column order, then t), not a matrix product, so the GPU
    and the CPU round every point alike.  A point lands where z > 1e-6
    and its rounded (half to even) column and row fall inside the image.
    The rounded coordinates are clamped to [-1, W] and [-1, H] in float,
    NaN sent to -1, before the cast to int32: a far off-axis point (u ~
    3e9) or a NaN never wraps into the image (a float -> int32 cast out
    of range is undefined in C; XLA saturates).  Each pixel keeps its
    least z (``scatter_reduce`` 'amin' over H*W + 1 slots, the last the
    sink of points that miss)."""
    from ..geometry.rotations import rodrigues_formula

    H, W = size
    cx, cy = pp if pp else (W / 2.0, H / 2.0)
    dev = pts.device
    R = rodrigues_formula(torch.tensor(rvec, dtype=torch.float32,
                                       device=dev))
    tv = torch.tensor(t, dtype=torch.float32, device=dev)
    cam = [pts[:, 0] * R[j, 0] + pts[:, 1] * R[j, 1] + pts[:, 2] * R[j, 2]
           + tv[j] for j in range(3)]
    z = cam[2]
    valid = z > 1e-6
    zs = torch.where(valid, z, 1.0)
    u = f * cam[0] / zs + cx
    v = f * cam[1] / zs + cy

    def to_int(c, n):
        c = torch.nan_to_num(torch.round(c), nan=-1.0)
        return c.clamp(-1.0, float(n)).to(torch.int32)

    ui, vi = to_int(u, W), to_int(v, H)
    inb = valid & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = torch.where(inb, vi.long() * W + ui, H * W)
    depth = torch.full((H * W + 1,), torch.inf, dtype=torch.float32,
                       device=dev)
    depth.scatter_reduce_(0, flat, torch.where(inb, z, torch.inf), "amin")
    depth = depth[:H * W].reshape(H, W)
    coverage = torch.isfinite(depth).sum() / (H * W)
    return depth, coverage


def inpaint_depth(depth: torch.Tensor) -> torch.Tensor:
    """The tool's ``--inpaint``: diffusion inpainting of the pixels no
    point reached (zero-filled first, as the JAX tool does)."""
    from ..imageproc.inpainting import diffusion_inpainting
    mask = torch.isfinite(depth)
    return diffusion_inpainting(torch.where(mask, depth, 0.0), ~mask)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("cloud")
    ap.add_argument("output")
    ap.add_argument("--size", type=int, nargs=2, default=[480, 640],
                    metavar=("H", "W"))
    ap.add_argument("--f", type=float, default=500.0)
    ap.add_argument("--pp", type=float, nargs=2, default=None,
                    metavar=("cx", "cy"))
    ap.add_argument("--rvec", type=float, nargs=3, default=[0, 0, 0],
                    help="world->camera axis-angle rotation")
    ap.add_argument("--t", type=float, nargs=3, default=[0, 0, 0],
                    help="world->camera translation")
    ap.add_argument("--inpaint", action="store_true",
                    help="fill holes by diffusion inpainting")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..io import open_point_cloud, write_image

    cloud = open_point_cloud(args.cloud)
    pts = torch.from_numpy(np.asarray(cloud.positions, np.float32)).to(dev)
    depth, coverage = project_depth(pts, args.size, args.f, args.pp,
                                    args.rvec, args.t)
    filled = float(coverage)
    if args.inpaint:
        depth = inpaint_depth(depth)

    out = depth.cpu().numpy()
    out[~np.isfinite(out)] = 0.0
    write_image(args.output, out)
    print(json.dumps({"written": args.output, "n_points": cloud.n_points,
                      "coverage": round(filled, 4)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
