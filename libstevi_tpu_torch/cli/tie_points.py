"""Sparse tie-point pipeline of the port (the counterpart of
`cli/tie_points.py`): corners -> descriptors -> matching -> robust
relative pose.

Reference parity: `examples/tie_points_checker` + SURVEY §3.6 call stack:
Harris/FAST corners, non-local-max selection, intensity orientation,
BRIEF/whitened descriptors, optimal assignment matching, essential-matrix
estimation with cheirality selection, inlier statistics.  The arguments
and the JSON report are the JAX tool's, plus ``--device`` (default
``cuda``; without a GPU that is an error, never a silent CPU run).  The
RANSAC's 256 index sets of 8 are drawn on the CPU from a
`torch.Generator` seeded with 3 (not JAX's keys), so a CPU run and a card
run fit the same hypotheses.  Images are ``.stevimg``, ``.pfm``, ``.flo``
or ``.exr`` files, or any format imageio reads where it is installed.

Usage:
  python -m libstevi_tpu_torch.cli.tie_points LEFT RIGHT [-n 256]
      [--detector harris] [--descriptor whitened] [--f 500]
      [-o matches.json] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .stereo_refine import device_arg, gray_pair

N_HYPOTHESES = 256
RANSAC_SEED = 3


def sampson(E: torch.Tensor, data) -> torch.Tensor:
    """Sampson distances of the (N, 2) correspondences ``data`` = (a, b)
    to the epipolar constraint [b 1] E [a 1]^T = 0 (products written out:
    no matmul, so no TF32 on a GPU)."""
    a, b = data

    def rows(M, p):          # M @ [p, 1] for each point, (N, 3)
        return torch.stack([M[i, 0] * p[:, 0] + M[i, 1] * p[:, 1] + M[i, 2]
                            for i in range(3)], -1)

    Ex1 = rows(E, a)
    Etx2 = rows(E.T, b)
    x2Ex1 = b[:, 0] * Ex1[:, 0] + b[:, 1] * Ex1[:, 1] + Ex1[:, 2]
    den = (Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2
           + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2)
    return torch.abs(x2Ex1) / torch.sqrt(torch.clamp(den, min=1e-12))


def tie_points(img_l: torch.Tensor, img_r: torch.Tensor, n_points: int = 256,
               detector: str = "harris", descriptor: str = "whitened",
               radius: int = 4, f: float | None = None,
               inlier_threshold: float = 2e-3, draw=None):
    """The tool's pipeline on two gray images of one device.  Returns
    (report, left [x, y] matches, right [x, y] matches); the pose entries
    of the report need ``f`` and 8 matches.  ``draw()`` gives the RANSAC's
    (256, 8) index sets (default: `draw_index_sets` on the CPU, seed 3)."""
    from ..geometry.alignement import (essential_matrix_to_transforms,
                                       estimate_essential_matrix,
                                       select_transform)
    from ..optim.assignment import match_descriptors
    from ..optim.ransac import draw_index_sets, ransac
    from ..sparse import descriptors as D
    from ..sparse.corners import fast_corner_detection, harris_corner_score
    from ..sparse.nms import non_local_maximum_point_selection
    from ..sparse.orientation import intensity_oriented_coordinates

    H, W = img_l.shape
    dev = img_l.device

    def detect(img):
        if detector == "harris":
            score = harris_corner_score(img)
        else:
            score = fast_corner_detection(img, 0.05)
        coords, _, valid = non_local_maximum_point_selection(
            score, float(radius), n_points, 0.0)
        coords = coords[valid]
        # keep clear of borders for descriptor support
        m = 2 * radius + 2
        keep = ((coords[:, 0] > m) & (coords[:, 0] < W - m)
                & (coords[:, 1] > m) & (coords[:, 1] < H - m))
        return coords[keep]

    def describe(img, coords_xy):
        rc = coords_xy.flip(-1)           # descriptors take (row, col)
        if descriptor == "brief":
            pat = D.random_sampling_pattern(256, radius, seed=7)
            return D.brief_descriptor(rc, img, pat).cpu().numpy() \
                .astype(np.float64)
        if descriptor == "whitened":
            d = D.whitened_pixels_descriptor(rc, img, radius=radius)
        elif descriptor == "oriented":
            dirs = intensity_oriented_coordinates(rc, img, radius)
            d = D.oriented_whitened_pixels_descriptor(rc, img, dirs,
                                                      radius=radius)
        else:
            d = D.circular_fft_descriptor(rc, img, n_rings=4, n_per_ring=16)
        return d.cpu().numpy()

    cl, cr = detect(img_l), detect(img_r)
    dl, dr = describe(img_l, cl), describe(img_r, cr)
    ia, ib = match_descriptors(dl, dr)
    pl = cl.cpu().numpy()[ia]
    pr = cr.cpu().numpy()[ib]
    report = {"n_left": int(len(cl)), "n_right": int(len(cr)),
              "n_matches": int(len(ia))}

    if f and len(ia) >= 8:
        cx, cy = W / 2.0, H / 2.0
        h1, h2 = (torch.from_numpy(np.stack(
            [(p[:, 0] - cx) / f, (p[:, 1] - cy) / f], -1).astype(
                np.float32)).to(dev) for p in (pl, pr))
        if draw is None:
            gen = torch.Generator().manual_seed(RANSAC_SEED)
            sets = draw_index_sets(len(ia), 8, N_HYPOTHESES, gen)
            draw = lambda: sets                              # noqa: E731
        res = ransac(lambda s: estimate_essential_matrix(*s), sampson,
                     (h1, h2), n_samples=8, n_iterations=N_HYPOTHESES,
                     threshold=inlier_threshold, draw=draw)
        inl = res.inliers
        report["n_inliers"] = int(inl.sum())
        report["inlier_ratio"] = round(float(inl.float().mean()), 4)
        T1, T2 = essential_matrix_to_transforms(res.model)
        T = select_transform(T1, T2, h1[inl], h2[inl])
        report["rotation"] = T.R.cpu().numpy().round(5).tolist()
        report["translation"] = T.t.cpu().numpy().round(5).tolist()
    return report, pl, pr


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("left")
    ap.add_argument("right")
    ap.add_argument("-n", "--n-points", type=int, default=256)
    ap.add_argument("--detector", default="harris",
                    choices=["harris", "fast"])
    ap.add_argument("--descriptor", default="whitened",
                    choices=["brief", "whitened", "oriented", "circular"])
    ap.add_argument("--radius", type=int, default=4)
    ap.add_argument("--f", type=float, default=None,
                    help="focal length (pixels) for pose estimation")
    ap.add_argument("--inlier-threshold", type=float, default=2e-3)
    ap.add_argument("-o", "--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:N' or 'cpu'")
    args = ap.parse_args(argv)
    dev = device_arg(ap, args)

    img_l, img_r = gray_pair([args.left, args.right], dev)
    report, pl, pr = tie_points(img_l, img_r, args.n_points, args.detector,
                                args.descriptor, args.radius, args.f,
                                args.inlier_threshold)
    print(json.dumps(report, indent=1))
    if args.output:
        report["matches"] = np.concatenate([pl, pr], -1).tolist()
        with open(args.output, "w") as fp:
            json.dump(report, fp)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
