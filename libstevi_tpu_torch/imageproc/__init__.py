"""Image processing (counterpart of `libstevi_tpu/imageproc/`): the N-d
convolution engine, the standard filters, finite differences, colour
conversions, histograms and thresholds, morphology, connected components,
edges, checkerboard detection (`checkerboard.detect_checkerboard`) and
hexagonal targets (`targets.detect_hex_targets`).  Torch ops on the
inputs' device; no kernel of the port's own.  The exports are the JAX
package's names for what is ported; the pipelines (Fourier, inpainting,
mean shift, intrinsic decomposition, shape from shading, foreground
segmentation) are not ported yet."""

from .convolutions import (Filter, FilterND, AxisType, PaddingType,
                           PaddingInfos, MovingWindowAxis,
                           AggregateWindowsAxis, BatchedInputAxis,
                           BatchedOutputAxis, convolve_2d)
from .filters import (gaussian_filter_taps, separated_gaussian_filter,
                      finite_differences_kernel, extend_linear_kernel,
                      gaussian_blur)
from .finite_differences import finite_difference
from .color import (linear_to_log, log_to_linear, rgb_to_gray, bgr_to_rgb,
                    rgb_to_hsv, hsv_to_rgb, rgb_to_hsi, yuv_to_rgb,
                    normalize_channels)
from .histogram import Histogram, otsu_threshold, balanced_histogram_threshold
from .morphology import (erosion, dilation, opening, closing, median_filter,
                         circular_structuring_element)
from .connected_components import connected_components, cluster_stats

__all__ = [
    "Filter", "FilterND", "AxisType", "PaddingType", "PaddingInfos",
    "MovingWindowAxis", "AggregateWindowsAxis", "BatchedInputAxis",
    "BatchedOutputAxis", "convolve_2d",
    "gaussian_filter_taps", "separated_gaussian_filter",
    "finite_differences_kernel", "extend_linear_kernel", "gaussian_blur",
    "finite_difference",
    "linear_to_log", "log_to_linear", "rgb_to_gray", "bgr_to_rgb",
    "rgb_to_hsv", "hsv_to_rgb", "rgb_to_hsi", "yuv_to_rgb",
    "normalize_channels",
    "Histogram", "otsu_threshold", "balanced_histogram_threshold",
    "erosion", "dilation", "opening", "closing", "median_filter",
    "circular_structuring_element",
    "connected_components", "cluster_stats",
]
