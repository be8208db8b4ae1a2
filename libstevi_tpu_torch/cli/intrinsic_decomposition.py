"""Intrinsic image decomposition of the port (the counterpart of
`cli/intrinsic_decomposition.py`).

Reference parity: `examples/intrisic_image_decomposition/main.cpp` —
split an image into reflectance and shading with the non-local-texture
retinex (RGB) or the FFT retinex (gray), optionally auto-tuning the
chromaticity threshold by shading entropy.  The arguments and the JSON
report are the JAX tool's, plus ``--device`` (default ``cuda``; without a
GPU that is an error, never a silent CPU run).  The RGB solver's texture
clustering runs on the host (O(N^2) in the pixels, as in the JAX
package).

Usage:
  python -m libstevi_tpu_torch.cli.intrinsic_decomposition IMAGE
      [--reflectance r.stevimg] [--shading s.stevimg] [--auto]
      [--device cuda]
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
    ap.add_argument("--reflectance", default=None)
    ap.add_argument("--shading", default=None)
    ap.add_argument("--auto", action="store_true",
                    help="sweep chromaticity thresholds, keep the "
                         "minimum-entropy shading (RGB only)")
    ap.add_argument("--diff-threshold", type=float, default=2e-3)
    ap.add_argument("--lambda-retinex", type=float, default=1.0)
    ap.add_argument("--lambda-texture", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..imageproc import (
        auto_retinex_with_nonlocal_texture_constraint, retinex_fft,
        retinex_with_nonlocal_texture_constraint)
    from ..io import read_image, write_stevimg

    img = np.asarray(read_image(args.image, np.float32))
    if img.ndim == 3 and img.shape[-1] == 3:
        x = torch.from_numpy(np.ascontiguousarray(img)).to(dev)
        if args.auto:
            dec = auto_retinex_with_nonlocal_texture_constraint(
                x, lambda_retinex=args.lambda_retinex,
                lambda_texture=args.lambda_texture,
                max_val=float(img.max()) or 1.0)
        else:
            dec = retinex_with_nonlocal_texture_constraint(
                x, args.diff_threshold,
                lambda_retinex=args.lambda_retinex,
                lambda_texture=args.lambda_texture)
    else:
        gray = img if img.ndim == 2 else img.mean(-1)
        dec = retinex_fft(torch.from_numpy(np.ascontiguousarray(gray)).to(dev))

    R = dec.reflectance.cpu().numpy()
    S = dec.shading.cpu().numpy()
    print(json.dumps({
        "reflectance_shape": list(R.shape), "shading_shape": list(S.shape),
        "reflectance_range": [float(R.min()), float(R.max())],
        "shading_range": [float(S.min()), float(S.max())]}))
    if args.reflectance:
        write_stevimg(args.reflectance, R)
    if args.shading:
        write_stevimg(args.shading, S)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
