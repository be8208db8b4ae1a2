"""glue_host_ms.<cells>: host milliseconds a traced frame inside the
program's ``stevi.dense_sgm_stereo`` span and outside its kernel stages'
spans (K1, K2, K3, K4d, K4b): the route's choice of form, the band, the
torch refinement and the Python between the launches.  Under the profiler
it holds the profiler's own cost of the spans and ops too."""

from stevi_bench import program

STAGES = ("stevi.k1", "stevi.k2", "stevi.k3", "stevi.k4d", "stevi.k4b")


def read(run):
    return program.span_ms(run, program.FRAME, STAGES)
