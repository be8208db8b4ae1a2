"""Carrying configuration across from the JAX package.

The stereo engine has no learned weights: what a JAX-package configuration
holds is enums, matching traits, penalties (P1, P2, Pout) and radii.
`to_port` maps the enums by class name and ``.value`` and rebuilds
`MatchTraits`; numbers pass through unchanged.  It never imports the JAX
package: it reads only the objects it is given.
"""

from __future__ import annotations

import enum

from .core import types, utils
from .ops import refinement, sgm
from .ops.unfold import PatchOrientation

PORT_ENUMS = {cls.__name__: cls for cls in (
    types.MatchingFunction, types.ExtractionStrategy, types.DispDirection,
    types.TruncatedCvDirection, utils.Contiguity,
    refinement.InterpolationKernel,
    refinement.IsotropyHypothesis, sgm.SgmDirection, PatchOrientation)}


def to_port(obj):
    """The port's counterpart of a JAX-package configuration object: an
    enum member maps to the port enum of the same name and value, a
    ``MatchTraits`` to the port's, a dict key by key; anything else (P1, P2,
    Pout, radii) is returned as it is."""
    if isinstance(obj, enum.Enum):
        return PORT_ENUMS[type(obj).__name__](obj.value)
    if type(obj).__name__ == "MatchTraits":
        return types.MatchTraits(obj.zero_mean, obj.normalized,
                                 to_port(obj.strategy), obj.census,
                                 obj.kernel)
    if isinstance(obj, dict):
        return {to_port(k): to_port(v) for k, v in obj.items()}
    return obj
