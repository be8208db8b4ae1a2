"""The optimization solvers (counterpart of `libstevi_tpu/optim/`): L2,
spherical, L1 (IRLS) and least-median best approximations over batches of
small systems, all through one small-system solver (`lsq.small_lstsq`),
Huber kernels, Gauss-Newton (`torch.func.jacfwd`), RANSAC, BFGS
(`torch.func.grad`), optimal assignment (scipy), L0 smoothing (FFTs) and
PCA.  Torch ops on the inputs' device; no kernel of the port's own."""

from .lsq import (least_squares, affine_best_l2_approximation,
                  spherical_affine_best_approximation, small_lstsq)
from .l1 import (weighted_median, least_absolute_differences,
                 affine_best_l1_approximation)
from .lmeds import least_absolute_median, affine_best_least_median_approximation
from .huber import huber_loss, pseudo_huber_loss, sqrt_huber_loss
from .gauss_newton import GaussNewton, ConvergenceType
from .ransac import ransac
from .bfgs import bfgs_minimize
from .assignment import optimal_assignment, extend_cost_for_n_best
from .pca import principal_components, AffineSpace
from .l0 import l0_smoothing, l0_approximation

__all__ = [
    "least_squares", "affine_best_l2_approximation",
    "spherical_affine_best_approximation", "small_lstsq",
    "weighted_median", "least_absolute_differences",
    "affine_best_l1_approximation",
    "least_absolute_median", "affine_best_least_median_approximation",
    "huber_loss", "pseudo_huber_loss", "sqrt_huber_loss",
    "GaussNewton", "ConvergenceType", "ransac", "bfgs_minimize",
    "optimal_assignment", "extend_cost_for_n_best",
    "principal_components", "AffineSpace",
    "l0_smoothing", "l0_approximation",
]
