"""Image processing (counterpart of `libstevi_tpu/imageproc/`): the N-d
convolution engine, the standard filters, finite differences, colour
conversions, histograms and thresholds, morphology, connected components,
edges, checkerboard detection (`checkerboard.detect_checkerboard`) and
hexagonal targets (`targets.detect_hex_targets`), and the pipelines:
Fourier transforms, inpainting, mean shift, intrinsic decomposition,
shape from shading and graph-cut foreground segmentation
(`foreground_segmentation`, not exported, as in the JAX package).  Torch
ops on the inputs' device (numpy on the host where the JAX module is
numpy); no kernel of the port's own.  The exports are the JAX package's
names."""

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
from .inpainting import nearest_neighbor_inpainting, diffusion_inpainting
from .fourier import FourierTransformCalculator
from .meanshift import mean_shift_clustering
from .intrinsic_decomposition import (
    IntrinsicDecomposition, retinex_with_nonlocal_texture_constraint,
    auto_retinex_with_nonlocal_texture_constraint, retinex_fft,
    perform_intrinsic_image_decomposition)
from .shape_from_shading import (
    estimate_light_direction_from_shading, initial_normal_map_estimate,
    normal_map_from_single_shading_image,
    normal_map_from_intrinsic_decomposition, gradient_based_edges,
    rectify_normal_map, height_from_normal_map,
    flatten_height_map_in_area_of_interest, shape_from_shading,
    integrate_normals)

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
    "nearest_neighbor_inpainting", "diffusion_inpainting",
    "FourierTransformCalculator", "mean_shift_clustering",
    "IntrinsicDecomposition", "retinex_with_nonlocal_texture_constraint",
    "auto_retinex_with_nonlocal_texture_constraint", "retinex_fft",
    "perform_intrinsic_image_decomposition",
    "estimate_light_direction_from_shading", "initial_normal_map_estimate",
    "normal_map_from_single_shading_image",
    "normal_map_from_intrinsic_decomposition", "gradient_based_edges",
    "rectify_normal_map", "height_from_normal_map",
    "flatten_height_map_in_area_of_interest", "shape_from_shading",
    "integrate_normals",
]
