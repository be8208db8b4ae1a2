"""Normal-map + height estimation from a single image, of the port (the
counterpart of `cli/normal_map_estimation.py`).

Reference parity: `examples/normal_map_estimation/main.cpp` — intrinsic
decomposition for the shading image, light-direction estimation, the
edge-guided normal solver, normal rectification over the area of
interest, least-squares height integration and plane flattening
(`normal_map_chain`).  The arguments and the JSON report are the JAX
tool's, plus ``--device`` (default ``cuda``; without a GPU that is an
error, never a silent CPU run).

Usage:
  python -m libstevi_tpu_torch.cli.normal_map_estimation IMAGE
      [-o normals.stevimg] [--height height.stevimg] [--light X Y Z]
      [--n-iter 30] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .stereo_refine import device_arg


def normal_map_chain(img: torch.Tensor, light=None, n_iter: int = 30,
                     lambda_norm: float = 1.0, lambda_diff: float = 0.25,
                     lambda_dir: float = 0.25, max_diff: float = 50.0,
                     ensure_convex: bool = False, on_stage=None):
    """The tool's steps on a (H, W) or (H, W, 3) image tensor.  Returns
    (normals (H, W, 3), the flattened height (H, W), the light as a float32
    numpy (3,)).  ``on_stage(name, output)``, where given, is called as
    each step ends."""
    from ..imageproc import (
        estimate_light_direction_from_shading,
        flatten_height_map_in_area_of_interest, height_from_normal_map,
        normal_map_from_intrinsic_decomposition, rectify_normal_map,
        retinex_fft)

    if on_stage is None:
        def on_stage(name, output):
            pass
    img = img.float()
    gray = img if img.ndim == 2 else img.mean(-1)
    guide = img if img.ndim == 3 else torch.stack([gray] * 3, -1)

    dec = retinex_fft(gray)
    shading = dec.shading if dec.shading.ndim == 2 else dec.shading[..., 0]
    on_stage("retinex_fft", shading)

    if light is not None:
        light = np.asarray(light, np.float32)
    else:
        est = estimate_light_direction_from_shading(shading).cpu().numpy()
        # the estimator's documented convention opposes the n.l light
        light = np.asarray([-est[0], -est[1], est[2]], np.float32)
    on_stage("light", light)

    normals = normal_map_from_intrinsic_decomposition(
        shading, guide, torch.from_numpy(light).to(img.device),
        lambda_norm=lambda_norm, lambda_diff=lambda_diff,
        lambda_dir=lambda_dir, n_iter=n_iter)
    on_stage("normals", normals)

    mask = torch.ones(gray.shape, dtype=torch.bool, device=img.device)
    normals = rectify_normal_map(normals, mask)
    on_stage("rectified", normals)
    height = height_from_normal_map(normals, max_diff)
    on_stage("height", height)
    flat = flatten_height_map_in_area_of_interest(height, mask,
                                                  ensure_convex)
    on_stage("flattened", flat)
    return normals, flat, light


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("image")
    ap.add_argument("-o", "--output", default=None,
                    help="normal map output (.stevimg, H x W x 3)")
    ap.add_argument("--height", default=None,
                    help="flattened height-map output (.stevimg)")
    ap.add_argument("--light", type=float, nargs=3, default=None,
                    help="known light direction; estimated when absent")
    ap.add_argument("--n-iter", type=int, default=30)
    ap.add_argument("--lambda-norm", type=float, default=1.0)
    ap.add_argument("--lambda-diff", type=float, default=0.25)
    ap.add_argument("--lambda-dir", type=float, default=0.25)
    ap.add_argument("--max-diff", type=float, default=50.0)
    ap.add_argument("--ensure-convex", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..io import read_image, write_stevimg

    img = np.asarray(read_image(args.image, np.float32))
    normals, flat, light = normal_map_chain(
        torch.from_numpy(np.ascontiguousarray(img)).to(dev), args.light,
        args.n_iter, args.lambda_norm, args.lambda_diff, args.lambda_dir,
        args.max_diff, args.ensure_convex)

    n = normals.cpu().numpy()
    flat = flat.cpu().numpy()
    report = {"shape": list(n.shape),
              "light": [float(v) for v in light],
              "mean_up": float(n[..., 2].mean()),
              "height_range": float(np.ptp(flat))}
    print(json.dumps(report))
    if args.output:
        write_stevimg(args.output, n)
    if args.height:
        write_stevimg(args.height, flat)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
