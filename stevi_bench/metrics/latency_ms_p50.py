"""latency_ms_p50: the median over every frame of the window of the time
from the pair's upload to the moment the host sees its disparity in host
memory."""

from stevi_bench.stats import percentile


def read(run):
    return 1e3 * percentile(run.window.latencies, 50)
