"""Monte-Carlo evaluation of the port's ray-alignment solvers (the
counterpart of `cli/ray_alignment_eval.py`).

Reference parity: `examples/generic_ray_alignement_evaluation/main.cpp` —
generate random rigid transforms and ray bundles, optionally perturb the
directions with noise and inject outliers, run the Gauss-Newton, relaxed
(linear) and robust (RANSAC) solvers, and report rotation/translation
recovery errors per solver.  The arguments, the data (numpy, from
``--seed``) and the JSON report are the JAX tool's, plus ``--device``
(default ``cuda``; without a GPU that is an error, never a silent CPU
run).  The robust solver draws its index sets from a `torch.Generator`
(seed 0 on the device), not JAX's keys.

Usage:
  python -m libstevi_tpu_torch.cli.ray_alignment_eval -n 20 --rays 60 \\
      --noise 0.002 --outliers 0.1 [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .stereo_refine import device_arg


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("-n", "--n-trials", type=int, default=10)
    ap.add_argument("--rays", type=int, default=60)
    ap.add_argument("--noise", type=float, default=0.0,
                    help="gaussian direction noise (radians-ish)")
    ap.add_argument("--outliers", type=float, default=0.0,
                    help="fraction of scrambled correspondences")
    ap.add_argument("--solvers", nargs="+",
                    default=["gauss-newton", "relaxed", "robust"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    from ..geometry.raysalignment import (
        RayInfos, align_rays_sets, relaxed_align_rays_sets,
        robust_align_rays_sets)
    from ..geometry.rotations import rodrigues_formula

    rng = np.random.default_rng(args.seed)
    solvers = {
        "gauss-newton": align_rays_sets,
        "relaxed": relaxed_align_rays_sets,
        "robust": robust_align_rays_sets,
    }
    errs = {s: {"rot_deg": [], "trans": []} for s in args.solvers}

    def rays(o, v):
        return RayInfos(*(torch.from_numpy(np.asarray(a, np.float32)).to(dev)
                          for a in (o, v)))

    for _ in range(args.n_trials):
        rvec = rng.normal(0, 0.4, 3)
        t = rng.normal(0, 1.0, 3)
        # the float32 rotation, as the JAX tool makes it (on the CPU, so
        # the data do not depend on --device)
        R = rodrigues_formula(torch.tensor(rvec, dtype=torch.float32)).numpy()

        # rays in frame 2 observe points; frame 1 = R^T (x2 - t)
        pts = rng.normal(0, 2.0, (args.rays, 3)) + np.asarray([0, 0, 6.0])
        o2 = rng.normal(0, 0.5, (args.rays, 3))
        v2 = pts - o2
        v2 /= np.linalg.norm(v2, axis=1, keepdims=True)
        o1 = (pts @ np.linalg.inv(R).T * 0
              + (rng.normal(0, 0.5, (args.rays, 3))))
        # frame-1 origins chosen freely; directions point at the same
        # world points expressed in frame 1: x1 = R^T (x2 - t)
        p1 = (pts - t) @ R
        v1 = p1 - o1
        v1 /= np.linalg.norm(v1, axis=1, keepdims=True)

        if args.noise > 0:
            v1 = v1 + rng.normal(0, args.noise, v1.shape)
            v1 /= np.linalg.norm(v1, axis=1, keepdims=True)
        n_out = int(args.outliers * args.rays)
        if n_out:
            idx = rng.choice(args.rays, n_out, replace=False)
            v1[idx] = rng.normal(0, 1, (n_out, 3))
            v1[idx] /= np.linalg.norm(v1[idx], axis=1, keepdims=True)

        r1, r2 = rays(o1, v1), rays(o2, v2)
        for s in args.solvers:
            T = solvers[s](r1, r2)
            Re = T.R.cpu().numpy()
            te = T.t.cpu().numpy()
            dR = Re @ R.T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2,
                                               -1, 1)))
            errs[s]["rot_deg"].append(float(ang))
            errs[s]["trans"].append(float(np.linalg.norm(te - t)))

    report = {s: {"rot_deg_median": float(np.median(e["rot_deg"])),
                  "trans_median": float(np.median(e["trans"])),
                  "rot_deg_p90": float(np.percentile(e["rot_deg"], 90))}
              for s, e in errs.items()}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
