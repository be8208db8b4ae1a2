"""launches.<cells>: the program's CUDA kernel launches a frame, the sum
of its ``launches.*`` counters over the run (warm-up, window and traced
segment) over its SGM route decisions (``route.*``, one a frame of the
benchmark's entries)."""

from stevi_bench import program


def read(run):
    c = program.counters(run)
    if c is None:
        return None
    frames = sum(v for k, v in c.items() if k.startswith("route."))
    if not frames:
        return None
    return sum(v for k, v in c.items() if k.startswith("launches.")) / frames
