"""libstevi_tpu_torch: the PyTorch + CUDA port of libstevi_tpu.

The port keeps the JAX package's module names (``core``, ``io``,
``statistics``, ``ops``, ``cli``) so each counterpart is easy to find, and
carries its slice of the stereo engine: the 1-D cost volumes, 4/8/16-
direction SGM, tie-last WTA, the SAME-mode truncated band and 1-D subpixel
refinement end to end in `ops.dense_sgm_stereo`, PatchMatch, and the
`stereo_match` CLI.  Plain functions on tensors; the device comes from the
inputs.  On a CUDA tensor the paths run hand-written kernels (``csrc/``,
built with nvcc on first use by `_build`); on a CPU tensor each kernel's
plain PyTorch version runs instead.

Importing the package builds nothing and needs neither a GPU nor nvcc.
"""

from . import core, io, ops, statistics

__all__ = ["core", "io", "ops", "statistics"]
