"""Roofline shares of a stage of the stereo pipeline.

Peaks are NVIDIA's published figures for one H100 SXM at its 700 W limit
(dense, no sparsity): 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside
the tensor cores.  A stage's work is counted from the cell's shapes, not
from what a kernel happens to move: each input byte read once, each output
byte written once, and the fewest float32 operations an entry of the stage
needs.  The least time the chip could take is the larger of bytes over the
bandwidth and operations over the float32 rate; the share is that time over
the device time of the kernels that implement the stage, summed over the
traced frames.  Where none of those kernels ran, the share is None.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def entries(config: dict) -> int:
    """H * W * D: the cost volume's entries."""
    return config["height"] * config["width"] * config["disp_width"]


def pixels(config: dict) -> int:
    return config["height"] * config["width"]


def volume_bytes(config: dict) -> int:
    return entries(config) * DTYPE_BYTES[config["volume_dtype"]]


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds the chip takes to move ``n_bytes`` and run
    ``n_ops`` float32 operations."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS)


def share(run, kernels, n_bytes: float, n_ops: float):
    """% of the roofline that the stage's ``kernels`` reach in the traced
    segment of ``run``, a frame's work being ``n_bytes`` and ``n_ops``;
    None where the trace holds none of them."""
    trace = run.trace
    if trace is None or trace.frames == 0:
        return None
    us, launches = trace.kernel_us(kernels)
    if launches == 0 or us <= 0:
        return None
    return 100.0 * trace.frames * bound_s(n_bytes, n_ops) / (us / 1e6)
