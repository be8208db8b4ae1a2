"""Subpixel stereo-refinement evaluation of the port (the counterpart of
`cli/stereo_refine.py`).

Reference parity: `examples/stereo_refine_test/main.cpp` — run the
image-level refined-disparity entry points (cost-symmetric and
feature-space barycentric families) on a stereo pair and report each
method's accuracy against a ground-truth disparity.  The arguments and the
JSON report are the JAX tool's, plus ``--device`` (default ``cuda``;
without a GPU that is an error, never a silent CPU run).  Images and the
ground truth are ``.stevimg``, ``.pfm``, ``.flo`` or ``.exr`` files, or
any format imageio reads (PNG, JPEG, ...) where it is installed.

Usage:
  python -m libstevi_tpu_torch.cli.stereo_refine LEFT RIGHT -d 120 -r 3 \\
      [--gt GT.stevimg] [-o refined.stevimg] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def device_arg(ap, args):
    """Refuse a CUDA ``--device`` without a GPU (exit 2)."""
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 "(pass --device cpu to run on the CPU)")
    return torch.device(args.device)


def gray_pair(paths, dev):
    """Two images as float32 gray tensors on ``dev`` (color averaged)."""
    from ..io import read_image
    imgs = [np.asarray(read_image(p, np.float32)) for p in paths]
    if imgs[0].ndim == 3:
        imgs = [x.mean(-1) for x in imgs]
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in imgs]


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("-d", "--disp-range", type=int, default=32)
    ap.add_argument("-r", "--radius", type=int, default=2)
    ap.add_argument("-m", "--matching", default="zncc",
                    choices=["zncc", "ncc", "zssd", "ssd", "sad", "medad"])
    ap.add_argument("--methods", nargs="+",
                    default=["barycentric", "barycentric-symmetric",
                             "cost-symmetric"])
    ap.add_argument("--gt", default=None)
    ap.add_argument("-o", "--output", default=None,
                    help="refined disparity of the LAST method (.stevimg)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..core import MatchingFunction
    from ..io import read_stevimg, write_stevimg
    from ..ops.image_refinement import (refined_barycentric_disp,
                                        refined_barycentric_symmetric_disp,
                                        refined_cost_symmetric_disp)

    func = MatchingFunction[args.matching.upper()]
    l, r = gray_pair((args.left, args.right), dev)
    rad, D = args.radius, args.disp_range
    runners = {
        "barycentric": lambda: refined_barycentric_disp(
            func, l, r, rad, rad, D),
        "barycentric-symmetric": lambda: refined_barycentric_symmetric_disp(
            func, l, r, rad, rad, D),
        "cost-symmetric": lambda: refined_cost_symmetric_disp(
            func, l, r, rad, rad, D),
    }

    gt = np.asarray(read_stevimg(args.gt)) if args.gt else None
    report = {}
    out = None
    for name in args.methods:
        disp = runners[name]().cpu().numpy()
        out = disp
        entry = {"mean": float(disp.mean())}
        if gt is not None:
            b = 2 * rad + 2
            inner = np.s_[b:-b, b + D:-b]
            err = np.abs(disp[inner] - gt[inner])
            entry["inlier_mae"] = float(err[err <= 1.0].mean())
            entry["prop_good_1.0"] = float((err <= 1.0).mean())
        report[name] = entry
    print(json.dumps(report))
    if args.output and out is not None:
        write_stevimg(args.output, out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
