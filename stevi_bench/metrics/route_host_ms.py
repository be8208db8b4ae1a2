"""route_host_ms.<cells>: host milliseconds a traced frame in the
program's ``stevi.route`` spans, the SGM route's run-time choice of form
(``sgm_cuda._one_launch`` and its ``cudaMemGetInfo`` on the scan route;
``fused_fits`` and ``chunk_width`` on the lane route)."""

from stevi_bench import program


def read(run):
    return program.span_ms(run, "stevi.route")
