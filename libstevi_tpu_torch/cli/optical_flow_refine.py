"""Subpixel optical-flow refinement evaluation of the port (the counterpart
of `cli/optical_flow_refine.py`).

Reference parity: `examples/optical_flow_refine_test/main.cpp` — match a
2-D search window between two images, refine the integer flow with the
feature-space symmetric barycentric refiner, and (when a ground-truth .flo
is given) report per-method end-point errors over the inlier set.  The
arguments and the JSON report are the JAX tool's, plus ``--device``
(default ``cuda``; without a GPU that is an error, never a silent CPU run).

Usage:
  python -m libstevi_tpu_torch.cli.optical_flow_refine IMG0 IMG1 -r 2 -s 3 \\
      [--gt flow.flo] [-o refined.flo] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .stereo_refine import device_arg, gray_pair


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("img0", help="source image (flow maps img0 -> img1)")
    ap.add_argument("img1")
    ap.add_argument("-r", "--radius", type=int, default=2,
                    help="matching window radius")
    ap.add_argument("-s", "--search", type=int, default=3,
                    help="2-D search half-range")
    ap.add_argument("-m", "--matching", default="zncc",
                    choices=["zncc", "ncc", "zssd", "ssd", "sad"])
    ap.add_argument("--gt", default=None, help=".flo ground truth")
    ap.add_argument("-o", "--output", default=None, help=".flo output")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..core import MatchingFunction, SearchOffset2
    from ..io import read_flo, write_flo
    from ..ops.image_refinement import refined_barycentric_symmetric_2d_disp

    func = MatchingFunction[args.matching.upper()]
    i0, i1 = gray_pair((args.img0, args.img1), dev)
    s = args.search
    search = SearchOffset2(-s, s, -s, s)
    # img_l = target (img1), img_r = source (img0) under RIGHT_TO_LEFT
    flow = refined_barycentric_symmetric_2d_disp(
        func, i1, i0, args.radius, args.radius, search).cpu().numpy()

    report = {"shape": list(flow.shape),
              "mean_flow": [float(flow[..., 0].mean()),
                            float(flow[..., 1].mean())]}
    if args.gt:
        gt = np.asarray(read_flo(args.gt))
        # .flo stores (u, v) = (dx, dy); ours is (di, dj)
        gt_ij = np.stack([gt[..., 1], gt[..., 0]], -1) \
            if gt.shape[-1] == 2 else gt
        b = 2 * (args.radius + s)
        inner = np.s_[b:-b, b:-b]
        epe = np.hypot(flow[inner + (0,)] - gt_ij[inner + (0,)],
                       flow[inner + (1,)] - gt_ij[inner + (1,)])
        inlier = epe <= 1.0
        report["epe_mean"] = float(epe.mean())
        report["inlier_epe"] = float(epe[inlier].mean()) \
            if inlier.any() else None
        report["prop_inlier"] = float(inlier.mean())
    print(json.dumps(report))
    if args.output:
        # store as (u, v) = (dj, di)
        write_flo(args.output, np.stack([flow[..., 1], flow[..., 0]], -1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
