"""PCA and affine-subspace utilities (counterpart of
`libstevi_tpu/optim/pca.py`).

Reference parity: `optimization/principalComponentsAnalysis.h:11`
(`principalComponents` via SVD) and `optimization/affine_utils.h:28,99`
(`AffineSpace`: the sum(coeffs)==1 subspace parameterization shared by the
constrained solvers).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


def principal_components(data: torch.Tensor, n_components: int | None = None):
    """Rows are observations.  Returns (components (k, d), singular values,
    mean).  Each component's sign is the SVD's (it may differ from another
    library's)."""
    mean = torch.mean(data, dim=0)
    centered = data - mean
    _, s, vt = torch.linalg.svd(centered, full_matrices=False)
    if n_components is not None:
        vt = vt[:n_components]
        s = s[:n_components]
    return vt, s, mean


@dataclass(frozen=True)
class AffineSpace:
    """x = e_ref + spread(alpha) with sum(x) == 1, reference = last
    coefficient (`affine_utils.h:28-99`)."""

    A: torch.Tensor

    @property
    def M(self) -> torch.Tensor:
        return self.A[..., :, :-1] - self.A[..., :, -1:]

    @property
    def b(self) -> torch.Tensor:
        return self.A[..., :, -1]

    @staticmethod
    def full_coeffs(alpha: torch.Tensor) -> torch.Tensor:
        last = 1.0 - torch.sum(alpha, dim=-1, keepdim=True)
        return torch.cat([alpha, last], dim=-1)
