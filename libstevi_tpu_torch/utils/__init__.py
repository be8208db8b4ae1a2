"""Auxiliary subsystems (counterpart of `libstevi_tpu/utils/`): profiling,
tracing, the program's spans and counters, roofline accounting against
the H100's peaks, and checkpoint /
resume in the JAX package's file format."""

from .profiling import (trace, device_time, device_timer, cost_analysis,
                        roofline, span, count, counters, reset_counters,
                        H100_HBM_BYTES_PER_S, H100_PEAK_FLOPS_BF16,
                        H100_PEAK_FLOPS_F32)
from .checkpointing import (save_checkpoint, load_checkpoint,
                            latest_checkpoint, resumable_iterate)

__all__ = [
    "trace", "device_time", "device_timer", "cost_analysis", "roofline",
    "span", "count", "counters", "reset_counters",
    "H100_HBM_BYTES_PER_S", "H100_PEAK_FLOPS_BF16", "H100_PEAK_FLOPS_F32",
    "save_checkpoint", "load_checkpoint", "latest_checkpoint",
    "resumable_iterate",
]
