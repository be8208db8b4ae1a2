"""census_host_ms.<cells>: host milliseconds a traced frame in the
program's ``stevi.census`` spans: the census stage's launches (the words
and the Hamming volume) and their allocations.  None where the traced
frames drew no such span (a program without the census kernel)."""

from stevi_bench import program

SPAN = "stevi.census"


def read(run):
    c = program.counters(run)
    if c is None or not c.get("spans." + SPAN):
        return None
    return program.span_ms(run, SPAN)
