from .downsampling import average_pooling_downsample
from .interpolation import (
    interpolate_image, bilinear_sample, bicubic_sample, resample_image,
)

__all__ = [
    "average_pooling_downsample",
    "interpolate_image", "bilinear_sample", "bicubic_sample",
    "resample_image",
]
