"""Background-disparity estimation + foreground segmentation of the port
(the counterpart of `cli/bg_fg_stereo.py`).

Reference parity: `examples/bg_fg_stereo/main.cpp` — estimate a global
background disparity from a background stereo pair, then segment each live
pair into foreground/background by comparing live costs at the background
disparity (`correlation/disparity_plus_background_segmentation.h`).  The
chain is `entry.bg_fg_background` then `entry.bg_fg_forward` (K5 builds
both cost volumes on the card for the dot / SSD / SAD families).  The
arguments and the JSON report are the JAX tool's, plus ``--device``
(default ``cuda``; without a GPU that is an error, never a silent CPU
run).  Images are ``.stevimg``, ``.pfm``, ``.flo`` or ``.exr`` files, or
any format imageio reads where it is installed (colour averaged).

Usage:
  python -m libstevi_tpu_torch.cli.bg_fg_stereo BG_LEFT BG_RIGHT LIVE_LEFT
      LIVE_RIGHT -d 64 [-m zncc] [-o disp.stevimg] [--mask-out mask.stevimg]
      [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from .stereo_refine import device_arg, gray_pair


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("bg_left")
    ap.add_argument("bg_right")
    ap.add_argument("live_left")
    ap.add_argument("live_right")
    ap.add_argument("-d", "--disp-width", type=int, default=64)
    ap.add_argument("-m", "--match-func", default="zncc")
    ap.add_argument("--radius", type=int, default=3)
    ap.add_argument("--rel-threshold", type=float, default=0.9)
    ap.add_argument("-o", "--output", default="disp.stevimg")
    ap.add_argument("--mask-out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..core import MatchingFunction
    from ..entry import bg_fg_background, bg_fg_forward
    from ..io import write_image

    func = MatchingFunction[args.match_func.upper()]
    bl, br, ll, lr = gray_pair((args.bg_left, args.bg_right, args.live_left,
                                args.live_right), dev)
    est = bg_fg_background(bl, br, func, args.radius, args.disp_width,
                           args.rel_threshold)
    out = bg_fg_forward(ll, lr, est, args.radius)

    fg = out.fg_mask.cpu().numpy()
    write_image(args.output, out.disp.cpu().numpy().astype(np.float32))
    if args.mask_out:
        write_image(args.mask_out, fg.astype(np.float32))
    print(json.dumps({"output": args.output,
                      "fg_fraction": round(float(fg.mean()), 4)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
