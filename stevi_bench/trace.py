"""The reduction of a profiler trace to what the per-layer metrics read.

A traced segment runs under `torch.profiler` inside a ``bench.window`` span;
the harness marks its own host phases with ``bench.*`` spans (which the
profiler also draws on the device's timeline, over the work launched in
them: they are not device items).  `reduce`
turns the profiler's events into a `Trace`: the device intervals (kernels,
memcpys and memsets), the busy time as the union of those intervals inside
the window (overlapping streams count once), the idle gaps labelled by what
the host was doing when each began (the harness phase and the innermost op
under it), and the breakdown the result line carries.
"""

from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field

WINDOW = "bench.window"
TOP = 10


def short_name(name: str) -> str:
    """A device item's name without its return type, namespace and
    argument list, template arguments kept (at most 80 characters)."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for k, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
    return name[:80]


def base_name(name: str) -> str:
    """`short_name` without template arguments: the kernel's own name."""
    return short_name(name).split("<")[0].strip()


@dataclass
class Trace:
    device: list            # (short name, start us, end us)
    window: tuple           # (start us, end us) of the traced segment
    frames: int             # frames whose work the segment holds
    busy_us: float = 0.0
    gaps: dict = field(default_factory=dict)    # host label -> idle us

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def kernel_us(self, kernels) -> tuple[float, int]:
        """(device us, launches) of the items whose `base_name` is one of
        ``kernels``."""
        names = set(kernels)
        hits = [t - s for n, s, t in self.device if base_name(n) in names]
        return float(sum(hits)), len(hits)

    def breakdown(self) -> dict:
        ops = defaultdict(float)
        for n, s, t in self.device:
            ops[n] += (t - s) / 1e6
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[n, v / 1e6] for n, v in gaps]}


def union_us(spans, lo: float, hi: float) -> tuple[float, list]:
    """(covered us, uncovered gaps [(start, end)]) of [lo, hi] by the
    intervals ``spans``."""
    busy, end, gaps = 0.0, lo, []
    for s, t in sorted(spans):
        s, t = max(s, lo), min(t, hi)
        if t <= s:
            continue
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def label_gaps(gaps, host) -> dict:
    """Idle us by what the host was doing at each gap's start: ``host`` is
    [(start, end, name)] of one thread's properly nested spans; the label
    is the innermost ``bench.*`` span, then the innermost op under it."""
    out = defaultdict(float)
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    stack, k = [], 0
    for g0, g1 in sorted(gaps):
        while k < len(host) and host[k][0] <= g0:
            while stack and stack[-1][1] <= host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] <= g0:
            stack.pop()
        live = [e for e in stack if e[1] > g0]
        phase = [e[2] for e in live if e[2].startswith("bench.")
                 and e[2] != WINDOW]
        inner = live[-1][2] if live else "idle host"
        label = phase[-1] if phase else "outside bench spans"
        if inner != label and not inner.startswith("bench."):
            label = f"{label} > {inner}"
        out[label] += g1 - g0
    return dict(out)


def from_events(device, host, frames: int) -> Trace:
    """A `Trace` from device items [(name, start, end)] and host spans
    [(start, end, name)] of the main thread, the ``bench.window`` span
    among them."""
    win = [(s, t) for s, t, n in host if n == WINDOW]
    if not win:
        raise ValueError("trace: no bench.window span")
    lo, hi = win[0]
    device = [(short_name(n), s, t) for n, s, t in device
              if t > lo and s < hi]
    busy, gaps = union_us([(s, t) for _, s, t in device], lo, hi)
    return Trace(device, (lo, hi), frames, busy, label_gaps(gaps, host))


def reduce(prof, frames: int) -> Trace:
    """The `Trace` of a finished `torch.profiler.profile`'s active step."""
    from torch.autograd import DeviceType
    device, threads = [], defaultdict(list)
    for e in prof.events():
        if e.name.startswith("ProfilerStep"):
            continue
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            # a host span shows on the device's timeline too, covering the
            # work launched inside it: no device work of its own
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith("bench.")):
                device.append((e.name, *span))
        elif e.device_type == DeviceType.CPU:
            threads[e.thread].append((*span, e.name))
    main = next((t for t, ev in threads.items()
                 if any(n == WINDOW for _, _, n in ev)), None)
    return from_events(device, threads.get(main, []), frames)
