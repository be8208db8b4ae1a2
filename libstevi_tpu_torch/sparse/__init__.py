"""The sparse chain (counterpart of `libstevi_tpu/sparse/`): Harris and
FAST corners, non-local-maximum selection, intensity orientation, and the
BRIEF, whitened-pixel and circular-FFT descriptors.  Torch ops on the
inputs' device; no kernel of the port's own.  The exports are the JAX
package's."""

from .corners import (harris_corner_score, windowed_harris_corner_score,
                      masked_harris_corner_score, fast_corner_detection)
from .nms import non_local_maximum_point_selection
from .orientation import intensity_oriented_coordinates
from .descriptors import (brief_descriptor, whitened_pixels_descriptor,
                          oriented_whitened_pixels_descriptor,
                          random_sampling_pattern, dense_sampling_pattern,
                          radial_sampling_pattern)

__all__ = [
    "harris_corner_score", "windowed_harris_corner_score",
    "masked_harris_corner_score", "fast_corner_detection",
    "non_local_maximum_point_selection",
    "intensity_oriented_coordinates",
    "brief_descriptor", "whitened_pixels_descriptor",
    "oriented_whitened_pixels_descriptor",
    "random_sampling_pattern", "dense_sampling_pattern",
    "radial_sampling_pattern",
]
