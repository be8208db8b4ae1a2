"""libstevi_tpu_torch: the PyTorch + CUDA port of libstevi_tpu.

The port keeps the JAX package's module names (``core``, ``geometry``,
``gui``, ``imageproc``, ``interpolation``, ``io``, ``statistics``, ``ops``,
``optim``, ``parallel``, ``sparse``, ``utils``, ``cli``) so each
counterpart is easy to find, and carries the stereo engine: the 1-D and 2-D cost volumes, 4/8/16-direction SGM, tie-last WTA, the truncated bands
and 1-D and 2-D subpixel refinement (end to end in
`ops.dense_sgm_stereo`), the matchers (PatchMatch stereo and flow, the
hierarchical matcher, fastmatch, DP stereo, guided filtering, template
matching, on-demand volumes), the ``interpolation`` package, the `optim`
solvers (L2 / spherical / L1 / least-median best approximations,
Gauss-Newton, RANSAC, BFGS, L0, PCA) with the feature-space subpixel
refinement they carry (`ops.image_refinement`), ``geometry`` (rotations,
the lens model, two-view / PnP / point-cloud / ray alignment, the stereo
rig rectifier) and ``statistics``, ``sparse`` (Harris / FAST corners,
non-local-maximum selection, orientation, BRIEF / whitened / circular-FFT
descriptors), the first half of ``imageproc`` (the N-d convolution
engine, filters, colour, histograms, morphology, connected components,
edges, checkerboard and hexagonal-target detection) and its pipelines
(Fourier, inpainting, mean shift, intrinsic decomposition, shape from
shading, graph-cut foreground segmentation), ``graphs`` (max-flow / min-cut
on the port's own native solver, ``native/maxflow.cpp``, built with g++ on
first use), the disparity estimator with background removal
(`ops.bg_segmentation`), the point-cloud IO (``io``: LAS through the
port's own ``native/las_codec.cpp``, PCD with LZF through
``native/lzf_codec.cpp``, SDC, metacloud), ``utils`` (profiling against
the H100's peaks, checkpoints in the JAX package's format), ``gui`` (the
display adapters and the matplotlib viewer), and every CLI of the JAX
package's `cli/`.
Plain functions on tensors; the device comes from the inputs.  On a CUDA tensor the paths
run hand-written kernels (``csrc/``, built with nvcc on first use by
`_build`); on a CPU tensor each kernel's plain PyTorch version runs
instead.

Importing the package builds nothing and needs neither a GPU nor nvcc.
"""

from . import (core, geometry, graphs, gui, imageproc, interpolation, io,
               ops, optim, sparse, statistics, utils)

__all__ = ["core", "geometry", "graphs", "gui", "imageproc", "interpolation",
           "io", "ops", "optim", "sparse", "statistics", "utils"]
