"""Pixel <-> homogeneous image-coordinate transforms (counterpart of
`libstevi_tpu/geometry/imagecoordinates.py`).

Reference parity: `geometry/imagecoordinates.h:32-159` —
`Image2HomogeneousCoordinates` ((pt - pp) / f with anchor sign flips) and
`Homogeneous2ImageCoordinates` (its inverse).  Points are (..., 2) [x, y]
tensors; f is a scalar or (2,) focal, pp the (2,) principal point, both
taken to the points' device as float32.
"""

from __future__ import annotations

import enum

import torch

from .core import vec


class ImageAnchors(enum.Enum):
    TOP_LEFT = 0
    TOP_RIGHT = 1
    BOTTOM_LEFT = 2
    BOTTOM_RIGHT = 3


_SIGNS = {ImageAnchors.TOP_LEFT: (1.0, 1.0),
          ImageAnchors.TOP_RIGHT: (1.0, -1.0),
          ImageAnchors.BOTTOM_LEFT: (-1.0, 1.0),
          ImageAnchors.BOTTOM_RIGHT: (-1.0, -1.0)}


def focal(f, like: torch.Tensor) -> torch.Tensor:
    """A scalar or (2,) focal length as a (2,) float32 tensor."""
    return vec(f, like.device).expand(2)


def image_to_homogeneous(pt: torch.Tensor, f, pp,
                         anchor: ImageAnchors = ImageAnchors.TOP_LEFT
                         ) -> torch.Tensor:
    r = (pt - vec(pp, pt.device)) / focal(f, pt)
    return r * vec(_SIGNS[anchor], pt.device)


def homogeneous_to_image(hom: torch.Tensor, f, pp,
                         anchor: ImageAnchors = ImageAnchors.TOP_LEFT
                         ) -> torch.Tensor:
    signs = vec(_SIGNS[anchor], hom.device)
    return hom * signs * focal(f, hom) + vec(pp, hom.device)
