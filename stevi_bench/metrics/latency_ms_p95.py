"""latency_ms_p95: the nearest-rank 95th percentile of the same latencies
as latency_ms_p50, over every frame of the window."""

from stevi_bench.stats import percentile


def read(run):
    return 1e3 * percentile(run.window.latencies, 95)
