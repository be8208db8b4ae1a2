"""The program's own spans and counters, for the per-layer metrics whose
source is ``program_span`` or ``program_counter``.

The program keeps one registry of counts, ``counters()`` of the top-level
package of the configuration's ``program`` (``libstevi_tpu_torch``):
``launches.<wrapper>`` for each CUDA kernel launch, ``route.<route>`` for
each SGM route taken (one a frame of the benchmark's entries), and, for
each ``stevi.*`` span entered while a profiler records, ``spans.<span>``
(entries) and ``span_ns.<span>`` (host nanoseconds inside it).  In a
``--trace 1`` run the profiler records only in the traced segment's active
step, so the span counts cover exactly its frames.  A program that keeps
no such registry reads None, as does a run whose trace holds no device
work (the CPU's), which drove no device path.
"""

from __future__ import annotations

import importlib

FRAME = "stevi.dense_sgm_stereo"


def counters(run):
    """The program's counters (a name never counted reads 0), or None
    where its package keeps none or the run drove no device."""
    if run.trace is None or not run.trace.device:
        return None
    package = run.config["program"].split(".")[0]
    try:
        read = getattr(importlib.import_module(package), "counters", None)
    except ImportError:
        return None
    return read() if callable(read) else None


def span_ms(run, inside: str, minus=()) -> float | None:
    """Host milliseconds a traced frame in the span ``inside``, less those
    in its child spans ``minus``; None without a traced frame."""
    c = counters(run)
    frames = c.get("spans." + FRAME, 0) if c is not None else 0
    if not frames:
        return None
    ns = c.get("span_ns." + inside, 0) - sum(c.get("span_ns." + s, 0)
                                              for s in minus)
    return ns / 1e6 / frames
