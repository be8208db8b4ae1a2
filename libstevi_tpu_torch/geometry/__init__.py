"""Geometry (counterpart of `libstevi_tpu/geometry/`): rotations and
transforms, image coordinates, the Brown lens model and the single-camera
rectifier, two-view alignment, P3P/PnP, point-cloud and ray alignment, the
stereo rig rectifier, sensor frames and the BSP/BVH indexes.  Torch ops on
the inputs' device (constructors take ``device``, default ``cuda``); no
kernel of the port's own.  The exports are the JAX package's."""

from .core import (skew, unskew, AffineTransform, IterativeTermination)
from .rotations import (
    rodrigues_formula, inverse_rodrigues_formula, angle_axis_rotate,
    diff_rodrigues_lie_algebra, axis_angle_to_quaternion,
    quaternion_to_axis_angle, RigidBodyTransform, ShapePreservingTransform,
    interpolate_rigid_body_transform_on_manifold, euler_radxyz_to_rotation,
    euler_degxyz_to_rotation,
)
from .imagecoordinates import (
    ImageAnchors, image_to_homogeneous, homogeneous_to_image,
)
from .lensdistortion import (
    radial_distortion, tangential_distortion, skew_distortion,
    invert_radial_distortion, invert_radial_tangential_distortion,
    full_lens_distortion_homogeneous, invert_full_lens_distortion_homogeneous,
    ImageRectifier,
)
from .alignement import (
    project_points, reproject_points, reproject_points_lstsqr,
    estimate_essential_matrix, essential_matrix_to_transforms,
    select_transform, find_transform, p3p, pnp, pnp_refine,
)

__all__ = [
    "skew", "unskew", "AffineTransform", "IterativeTermination",
    "rodrigues_formula", "inverse_rodrigues_formula", "angle_axis_rotate",
    "diff_rodrigues_lie_algebra", "axis_angle_to_quaternion",
    "quaternion_to_axis_angle", "RigidBodyTransform",
    "ShapePreservingTransform",
    "interpolate_rigid_body_transform_on_manifold",
    "euler_radxyz_to_rotation", "euler_degxyz_to_rotation",
    "ImageAnchors", "image_to_homogeneous", "homogeneous_to_image",
    "radial_distortion", "tangential_distortion", "skew_distortion",
    "invert_radial_distortion", "invert_radial_tangential_distortion",
    "full_lens_distortion_homogeneous",
    "invert_full_lens_distortion_homogeneous", "ImageRectifier",
    "project_points", "reproject_points", "reproject_points_lstsqr",
    "estimate_essential_matrix", "essential_matrix_to_transforms",
    "select_transform", "find_transform", "p3p", "pnp", "pnp_refine",
]
