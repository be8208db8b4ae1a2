"""The check that nothing the run loaded is JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot), whole: ``libstevi_tpu_torch`` is the program under test, while
``libstevi_tpu``, the JAX package it was ported from, is forbidden.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "libstevi_tpu"})


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    modules this process has loaded), sorted."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & FORBIDDEN)
