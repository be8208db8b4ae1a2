"""Dense stereo matching CLI of the port (the counterpart of
`cli/stereo_match.py`).

Reference parity: `examples/stereo-match/main.cpp` — load a rectified pair,
run the selected matcher (dense WTA / SGM / hierarchical / PatchMatch) with
a chosen matching cost, optional subpixel refinement, write the disparity
map, and report accuracy against ground truth: the proportion of pixels with
|err| <= 2.0 ("prop good", `main.cpp:234-258`) and the inlier MAE
(`main.cpp:275-303`).  The arguments and the JSON report keys are the JAX
tool's, plus ``--device`` (default ``cuda``; without a GPU that is an
error, never a silent CPU run).  Images and the ground truth are
``.stevimg``, ``.pfm``, ``.flo`` or ``.exr`` files, or any format imageio
reads (PNG, JPEG, ...) where it is installed.  On the card SGM takes
any ``-d`` with 4, 8 or 16 directions (past D = 320 through the
lane-layout kernels K4b / K4d, with K2k's any-D instance for the knights).
The hierarchical matcher runs depth 2 (its coarsest level through K1 for
the dot family on the card), and ``--refine`` fits the negated SCORE band
around its estimate, as the JAX tool does.

Usage:
  python -m libstevi_tpu_torch.cli.stereo_match LEFT RIGHT -o disp.stevimg \\
      -d 120 -m zncc --matcher sgm --sgm-dirs 16 --refine parabola \\
      [--gt GT.pfm] [--radius 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch


def _args(argv):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("-o", "--output", default="disp.stevimg")
    ap.add_argument("-d", "--disp-width", type=int, default=120)
    ap.add_argument("-m", "--match-func", default="zncc",
                    choices=["cc", "ncc", "ssd", "sad", "zcc", "zncc",
                             "zssd", "zsad", "census"])
    ap.add_argument("--matcher", default="sgm",
                    choices=["wta", "sgm", "hierarchical", "patchmatch"])
    ap.add_argument("--radius", type=int, default=3)
    ap.add_argument("--sgm-p1", type=float, default=0.1)
    ap.add_argument("--sgm-p2", type=float, default=0.5)
    ap.add_argument("--sgm-dirs", type=int, default=8)
    ap.add_argument("--refine", default="none",
                    choices=["none", "parabola", "equiangular", "gaussian"])
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                    help="cost-volume storage type (the SGM DP runs in f32; "
                         "16 directions always store f32)")
    ap.add_argument("--gt", help="ground-truth disparity (.stevimg, "
                    ".pfm, .flo or .exr)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    for path, role in ((args.left, "left image"), (args.right, "right image"),
                       (args.gt, "ground truth")):
        if path and not os.path.exists(path):
            ap.error(f"{role} not found: {path}")
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        ap.error(f"--device {args.device}: no CUDA device is available "
                 "(pass --device cpu to run the plain versions on the CPU)")
    return args


def _match(args, func, img_l, img_r):
    """Disparity (H, W) float32 numpy of the chosen matcher."""
    from ..core import ExtractionStrategy, MATCH_TRAITS, SearchOffset1
    from ..ops import (InterpolationKernel, dense_sgm_stereo,
                       extract_selected_index, patch_match,
                       refine_disp_cost_interpolation,
                       selected_index_to_disp, truncated_cost_volume,
                       unfold_based_cost_volume)
    from ..ops.hierarchical import hierarchical_truncated_cost_volume
    cv_dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    rk = (None if args.refine == "none"
          else InterpolationKernel[args.refine.upper()])
    r, D = args.radius, args.disp_width
    if args.matcher == "patchmatch":
        gen = torch.Generator(device=img_l.device).manual_seed(0)
        disp = patch_match(func, img_l, img_r, SearchOffset1(0, D - 1),
                           h_radius=r, v_radius=r, generator=gen)
    elif args.matcher == "hierarchical":
        out = hierarchical_truncated_cost_volume(func, img_l, img_r, r, r, D,
                                                 depth=2)
        idx = out.disp_estimate
        disp = idx.float()
        if rk is not None:
            tcv = out.truncated_cost_volume
            if MATCH_TRAITS[func].strategy is ExtractionStrategy.SCORE:
                tcv = -tcv
            c = tcv.shape[-1] // 2
            disp = refine_disp_cost_interpolation(rk, tcv[..., c - 1:c + 2],
                                                  idx)
    elif args.matcher == "sgm":
        disp, _, _ = dense_sgm_stereo(
            func, img_l, img_r, r, r, D, P1=args.sgm_p1, P2=args.sgm_p2,
            n_directions=args.sgm_dirs, refine_kernel=rk, cv_dtype=cv_dtype)
    else:
        cv = unfold_based_cost_volume(func, img_l, img_r, r, r, D,
                                      cv_dtype=cv_dtype)
        strategy = MATCH_TRAITS[func].strategy
        idx = extract_selected_index(cv, strategy)
        disp = selected_index_to_disp(idx)
        if rk is not None:
            work_cv = -cv if strategy is ExtractionStrategy.SCORE else cv
            tcv = truncated_cost_volume(work_cv, idx, r, r, 1)
            disp = refine_disp_cost_interpolation(rk, tcv, idx)
    return disp.float().cpu().numpy()


def main(argv=None):
    args = _args(argv)
    from ..core import MatchingFunction
    from ..io import read_image, write_image

    dev = torch.device(args.device)
    func = MatchingFunction[args.match_func.upper()]
    imgs = [read_image(p, np.float32) for p in (args.left, args.right)]
    if imgs[0].ndim == 3 and imgs[0].shape[-1] > 3:
        imgs = [x[..., :3] for x in imgs]
    img_l, img_r = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                    for x in imgs)

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    disp_f = _match(args, func, img_l, img_r)    # .cpu() synchronises
    dt = time.perf_counter() - t0

    write_image(args.output, disp_f.astype(np.float32))

    report = {"matcher": args.matcher, "match_func": args.match_func,
              "disp_width": args.disp_width, "time_s": round(dt, 3),
              "output": args.output}

    if args.gt:
        from ..statistics import prop_good, inlier_mae
        gt = read_image(args.gt, np.float32)
        if gt.ndim == 3:
            gt = gt[..., 0]
        report["prop_good_2.0"] = round(prop_good(disp_f, gt, 2.0), 4)
        report["inlier_mae"] = round(inlier_mae(disp_f, gt, 2.0), 4)

    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
