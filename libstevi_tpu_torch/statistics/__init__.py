from .stereo_covering import compute_covering, compute_covering_proportion
from .covariance_kernels import matern_kernel, exponential_kernel, gaussian_kernel
from .metrics import prop_good, bad_n, inlier_mae, end_point_error

__all__ = ["compute_covering", "compute_covering_proportion",
           "matern_kernel", "exponential_kernel", "gaussian_kernel",
           "prop_good", "bad_n", "inlier_mae", "end_point_error"]
