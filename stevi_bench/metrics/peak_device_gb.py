"""peak_device_gb: torch.cuda.max_memory_allocated over the window (reset
after the warm-up), in 1e9 bytes.  The reading is the CUDA caching
allocator's, which the harness takes on the host after the window; the
schema's sources name no allocator, so BENCHMARK.json labels it
host_clock."""


def read(run):
    return run.peak_window_bytes / 1e9 if run.peak_window_bytes else None
