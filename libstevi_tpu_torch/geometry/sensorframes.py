"""Sensor-frame axis conventions (a copy of
`libstevi_tpu/geometry/sensorframes.py`, numpy only: importing that module
would load the JAX package).

Reference parity: `geometry/sensorframesconvention.h` — compile-time axis
system definitions (RAS / FLU / NED / ...) and conversion matrices between
frames (`getSensorFrameConversion`, :230).
"""

from __future__ import annotations

import enum

import numpy as np


class Axis(enum.Enum):
    RIGHT = (0, 1)
    LEFT = (0, -1)
    FRONT = (1, 1)
    BACK = (1, -1)
    UP = (2, 1)
    DOWN = (2, -1)

    # aliases used in the anatomical/navigation conventions
    ANTERIOR = (1, 1)
    POSTERIOR = (1, -1)
    SUPERIOR = (2, 1)
    INFERIOR = (2, -1)
    NORTH = (1, 1)
    SOUTH = (1, -1)
    EAST = (0, 1)
    WEST = (0, -1)


def _validate(axes):
    dims = [a.value[0] for a in axes]
    if sorted(dims) != [0, 1, 2]:
        raise ValueError("axis system must span three orthogonal directions")


class AxisSystemDefinition:
    """Three world directions naming the sensor's +x, +y, +z axes
    (`AxisSystemDefintion`, `sensorframesconvention.h:152`)."""

    def __init__(self, x: Axis, y: Axis, z: Axis):
        _validate((x, y, z))
        self.axes = (x, y, z)

    def to_canonical(self) -> np.ndarray:
        """Matrix mapping sensor coordinates into the canonical
        (RIGHT, FRONT, UP) world frame."""
        M = np.zeros((3, 3))
        for col, a in enumerate(self.axes):
            dim, sign = a.value
            M[dim, col] = sign
        return M


# common conventions
RAS = AxisSystemDefinition(Axis.RIGHT, Axis.ANTERIOR, Axis.SUPERIOR)
FLU = AxisSystemDefinition(Axis.FRONT, Axis.LEFT, Axis.UP)
NED = AxisSystemDefinition(Axis.NORTH, Axis.EAST, Axis.DOWN)
ENU = AxisSystemDefinition(Axis.EAST, Axis.NORTH, Axis.UP)


def get_sensor_frame_conversion(source: AxisSystemDefinition,
                                target: AxisSystemDefinition) -> np.ndarray:
    """Rotation matrix converting source-frame coordinates to target-frame
    coordinates (`getSensorFrameConversion`,
    `sensorframesconvention.h:230`)."""
    return target.to_canonical().T @ source.to_canonical()
