"""Checkerboard calibration-target detection of the port (the counterpart
of `cli/detect_checkerboard.py`).

Reference parity: `examples/checkboard_detection/main.cpp` — detect corner
candidates, filter, grow the grid, refine subpixel, report the grid.  The
arguments and the JSON report are the JAX tool's, plus ``--device``
(default ``cuda``; without a GPU that is an error, never a silent CPU
run).  The image is a ``.stevimg``, ``.pfm``, ``.flo`` or ``.exr`` file,
or any format imageio reads where it is installed (colour averaged).

Usage:
  python -m libstevi_tpu_torch.cli.detect_checkerboard IMAGE
      [-o corners.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .stereo_refine import device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("image")
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--smooth-radius", type=int, default=1)
    ap.add_argument("--nms-radius", type=int, default=2)
    ap.add_argument("--lambda-threshold", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..imageproc.checkerboard import detect_checkerboard
    from ..io import read_image

    img = np.asarray(read_image(args.image, np.float32))
    if img.ndim == 3:
        img = img.mean(-1)
    board = detect_checkerboard(torch.from_numpy(img).to(dev),
                                args.smooth_radius, args.nms_radius,
                                args.lambda_threshold)
    if board is None:
        print(json.dumps({"found": False}))
        return 1
    report = {"found": True, "rows": board.rows, "cols": board.cols,
              "n_points": board.n_points_found}
    print(json.dumps(report))
    if args.output:
        report["corners"] = np.where(np.isfinite(board.corners),
                                     board.corners, None).tolist()
        with open(args.output, "w") as fp:
            json.dump(report, fp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
