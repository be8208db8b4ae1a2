"""Stereo rig epipolar rectification (counterpart of
`libstevi_tpu/geometry/stereorigrectifier.py`).

Reference parity: `geometry/stereorigrectifier.h` —
`computeOptimalCamsRots` (:365: split the rotation between the cameras and
align both optical axes perpendicular to the baseline, then roll so the x
axes follow the baseline), `computeForwardVec`/`computeForwardMaps`
(:460,509: project the 4 corners through the derotation),
`computeROIs` (:567: Minimal = largest interpolation-free box; Same = a
4-parameter (scale, tx1, tx2, ty) least-squares fit of the corner boxes;
note the reference's Maximal branch is dead code — a duplicated
``== Same`` condition — so Maximal here implements the evident intent, the
union box), `computeResolution` (:731: 'Same' policy — new focal =
min height / vertical extent; the reference ignores the method argument),
`computeBackwardMaps` (:761: per-pixel inverse rotation + re-distortion),
and the disp->depth helpers `normalizedBasline`/`dispDelta` (:354-358).

The rotations and the corner boxes are 3-vectors and 4 corners (a few
host reads decide the branches); the backward maps are two vectorized
evaluations over the target pixel grid on ``device`` (no per-pixel
loops), resampled by `interpolation.resample_image`.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import vec
from .lensdistortion import full_lens_distortion_homogeneous, pixel_grid
from .rotations import rodrigues_formula
from ..optim.lsq import least_squares


def _perp_align_rotation(forward, t_dir):
    """The unit direction closest to `forward` that is perpendicular to
    the baseline, and its norm before normalizing
    (`stereorigrectifier.h:380-430`)."""
    cross = torch.linalg.cross(t_dir, forward)
    d = torch.linalg.cross(cross, t_dir)
    n = torch.linalg.vector_norm(d)
    return d / n, n


class StereoRigRectifier:
    """Inputs follow the reference constructor (`stereorigrectifier.h:28`):
    cam2-to-cam1 pose (r axis-angle, t), per-camera focal (px, scalar),
    principal point (x, y), image size (width, height), and optional
    k123 / t12 / B12 distortion coefficients; the tensors live on
    ``device`` (default ``cuda``)."""

    MINIMAL, MAXIMAL, SAME = "minimal", "maximal", "same"

    def __init__(self, r_cam2_to_cam1, t_cam2_to_cam1, f1, pp1, size1,
                 k1=None, t1=None, B1=None, f2=None, pp2=None, size2=None,
                 k2=None, t2=None, B2=None, device="cuda"):
        self.device = dev = torch.device(device)
        self.r = vec(r_cam2_to_cam1, dev)
        self.t = vec(t_cam2_to_cam1, dev)
        self.f1 = float(f1)
        self.pp1 = vec(pp1, dev)
        self.size1 = tuple(int(v) for v in size1)  # (width, height)
        self.k1, self.t1, self.B1 = k1, t1, B1
        self.f2 = float(f2 if f2 is not None else f1)
        self.pp2 = vec(pp2 if pp2 is not None else pp1, dev)
        self.size2 = tuple(int(v) for v in (size2 or size1))
        self.k2, self.t2, self.B2 = k2, t2, B2

        self.corr_r_cam1 = None
        self.corr_r_cam2 = None
        self.backward_cam1 = None
        self.backward_cam2 = None
        self.reprojection_flen = None
        self.new_pp_cam1 = None
        self.new_pp_cam2 = None
        self.nsize_cam1 = None
        self.nsize_cam2 = None
        self.normalized_baseline = None
        self.disp_delta = None

    # -- steps ------------------------------------------------------------

    def compute_optimal_cams_rots(self) -> bool:
        dev = self.device
        t_norm = float(torch.linalg.vector_norm(self.t))
        if t_norm < 1e-4:
            return False
        t_dir = self.t / t_norm
        RC2 = rodrigues_formula(self.r)
        fwd1 = vec([0.0, 0.0, 1.0], dev)
        fwd2 = RC2 @ fwd1

        dir1, n1 = _perp_align_rotation(fwd1, t_dir)
        dir2, n2 = _perp_align_rotation(fwd2, t_dir)
        if float(n1) < 1e-4 or float(n2) < 1e-4:
            return False
        if float(torch.dot(dir1, dir2)) < 0.2:
            return False

        dir_mean = (dir1 + dir2) / 2.0
        dir_mean = dir_mean / torch.linalg.vector_norm(dir_mean)

        def align_rot(u, v):
            """Rotation taking unit u onto unit v.  The angle comes from
            atan2(|u x v|, u.v) — arcsin(|cross|) caps at 90 degrees and
            mis-rotates obtuse pairs.  Exactly-antiparallel pairs rotate
            about an arbitrary perpendicular axis."""
            c = torch.linalg.cross(u, v)
            n = torch.linalg.vector_norm(c)
            ang = torch.arctan2(n, torch.dot(u, v))
            alt = torch.linalg.cross(u, vec([1.0, 0.0, 0.0], dev))
            alt2 = torch.linalg.cross(u, vec([0.0, 1.0, 0.0], dev))
            alt = torch.where(torch.linalg.vector_norm(alt) > 1e-6, alt, alt2)
            axis = torch.where(
                n > 1e-6, c / torch.clamp_min(n, 1e-12),
                alt / torch.clamp_min(torch.linalg.vector_norm(alt), 1e-12))
            return rodrigues_formula(axis * ang)

        Rot1 = align_rot(fwd1, dir_mean)
        Rot2 = align_rot(fwd2, dir_mean)

        x1 = vec([1.0, 0.0, 0.0], dev)
        x2 = RC2 @ x1
        a1 = align_rot(Rot1 @ x1, t_dir)
        a2 = align_rot(Rot2 @ x2, t_dir)

        self.corr_r_cam1 = a1 @ Rot1
        corr2_in_cam1 = a2 @ Rot2
        self.corr_r_cam2 = RC2.T @ corr2_in_cam1 @ RC2
        return True

    def _forward_vec(self, pts, pp, f, R):
        v = torch.cat([(pts - pp) / f,
                       torch.ones(pts.shape[:-1] + (1,), device=pts.device)],
                      -1)
        v = v @ R          # == R^T v, batched
        return v[..., :2] / v[..., 2:3]

    def compute_forward_maps(self) -> bool:
        w1, h1 = self.size1
        w2, h2 = self.size2
        c1 = vec([[0.0, 0.0], [w1, 0.0], [0.0, h1], [w1, h1]], self.device)
        c2 = vec([[0.0, 0.0], [w2, 0.0], [0.0, h2], [w2, h2]], self.device)
        self.fc1 = self._forward_vec(c1, self.pp1, self.f1,
                                     self.corr_r_cam1).cpu().numpy()
        self.fc2 = self._forward_vec(c2, self.pp2, self.f2,
                                     self.corr_r_cam2).cpu().numpy()
        return bool(np.isfinite(self.fc1).all()
                    and np.isfinite(self.fc2).all())

    def compute_rois(self, method: str) -> bool:
        tl1, tr1, bl1, br1 = self.fc1
        tl2, tr2, bl2, br2 = self.fc2

        if method == self.MINIMAL:
            top = max(tl1[1], tr1[1], tl2[1], tr2[1])
            bottom = min(bl1[1], br1[1], bl2[1], br2[1])
            c1_tl = np.array([max(tl1[0], bl1[0]), top])
            c1_br = np.array([min(tr1[0], br1[0]), bottom])
            c2_tl = np.array([max(tl2[0], bl2[0]), top])
            c2_br = np.array([min(tr2[0], br2[0]), bottom])
        elif method == self.SAME:
            min_h = min(self.size1[1], self.size2[1])
            ar1 = self.size1[0] / min_h
            ar2 = self.size2[0] / min_h
            # 4 params: scale, tx_cam1, tx_cam2, ty (`:590-680`); the
            # reference uses ar2 for cam1's bottom-right x row (:619) —
            # replicated
            obs = np.array([tl1[0], tl1[1], tr1[0], tr1[1], bl1[0], bl1[1],
                            br1[0], br1[1], tl2[0], tl2[1], tr2[0], tr2[1],
                            bl2[0], bl2[1], br2[0], br2[1]], np.float32)
            A = np.zeros((16, 4), np.float32)
            A[0, 1] = 1;  A[1, 3] = 1
            A[2, 0] = ar1; A[2, 1] = 1; A[3, 3] = 1
            A[4, 1] = 1;  A[5, 0] = 1; A[5, 3] = 1
            A[6, 0] = ar2; A[6, 1] = 1; A[7, 0] = 1; A[7, 3] = 1
            A[8, 2] = 1;  A[9, 3] = 1
            A[10, 0] = ar2; A[10, 2] = 1; A[11, 3] = 1
            A[12, 2] = 1; A[13, 0] = 1; A[13, 3] = 1
            A[14, 0] = ar2; A[14, 2] = 1; A[15, 0] = 1; A[15, 3] = 1
            x = least_squares(torch.from_numpy(A).to(self.device),
                              torch.from_numpy(obs).to(self.device))
            x = x.cpu().numpy()
            c1_tl = np.array([x[1], x[3]])
            c2_tl = np.array([x[2], x[3]])
            c1_br = np.array([x[0] * ar1 + x[1], x[0] + x[3]])
            c2_br = np.array([x[0] * ar2 + x[2], x[0] + x[3]])
        elif method == self.MAXIMAL:
            top = min(tl1[1], tr1[1], tl2[1], tr2[1])
            bottom = max(bl1[1], br1[1], bl2[1], br2[1])
            c1_tl = np.array([min(tl1[0], bl1[0]), top])
            c1_br = np.array([max(tr1[0], br1[0]), bottom])
            c2_tl = np.array([min(tl2[0], bl2[0]), top])
            c2_br = np.array([max(tr2[0], br2[0]), bottom])
        else:
            return False

        if (c1_tl[1] >= c1_br[1] or c1_tl[0] >= c1_br[0]
                or c2_tl[0] >= c2_br[0]):
            return False
        self.roi_c1 = (c1_tl, c1_br)
        self.roi_c2 = (c2_tl, c2_br)
        return True

    def compute_resolution(self, method: str = "same") -> bool:
        # only the 'Same' policy is implemented (as in the reference, which
        # ignores its method argument, `:739`)
        min_h = min(self.size1[1], self.size2[1])
        v_extent = self.roi_c1[1][1] - self.roi_c1[0][1]
        self.reprojection_flen = float(min_h / v_extent)
        self.nsize_cam1 = (self.size1[0], min_h)   # (width, height)
        self.nsize_cam2 = (self.size2[0], min_h)
        self.new_pp_cam1 = vec(-self.reprojection_flen * self.roi_c1[0],
                               self.device)
        self.new_pp_cam2 = vec(-self.reprojection_flen * self.roi_c2[0],
                               self.device)
        self.normalized_baseline = float(self.reprojection_flen
                                         * torch.linalg.vector_norm(self.t))
        self.disp_delta = float(self.new_pp_cam2[0] - self.new_pp_cam1[0])
        return True

    def _backward_map(self, nsize, npp, f_new, R, pp, f, k, t_, B):
        w, h = nsize
        pts = pixel_grid(h, w, self.device)
        v = torch.cat([(pts - npp) / f_new,
                       torch.ones((h, w, 1), device=self.device)], -1)
        v = torch.einsum("ab,hwb->hwa", R, v)
        r = v[..., :2] / v[..., 2:3]
        # the library's own forward model (radial AND tangential both
        # evaluated at the UNDISTORTED position, skew on the distorted one)
        px = full_lens_distortion_homogeneous(r, f, pp, k, t_, B)
        # stored as (row, col) like the reference (`:787-788`)
        return torch.stack([px[..., 1], px[..., 0]], -1)

    def compute_backward_maps(self) -> bool:
        self.backward_cam1 = self._backward_map(
            self.nsize_cam1, self.new_pp_cam1, self.reprojection_flen,
            self.corr_r_cam1, self.pp1, self.f1, self.k1, self.t1, self.B1)
        self.backward_cam2 = self._backward_map(
            self.nsize_cam2, self.new_pp_cam2, self.reprojection_flen,
            self.corr_r_cam2, self.pp2, self.f2, self.k2, self.t2, self.B2)
        return True

    def compute(self, roi_method: str = "minimal",
                resolution_method: str = "same") -> bool:
        """Full pipeline (`compute`, `stereorigrectifier.h:286-320`)."""
        return (self.compute_optimal_cams_rots()
                and self.compute_forward_maps()
                and self.compute_rois(roi_method)
                and self.compute_resolution(resolution_method)
                and self.compute_backward_maps())
