"""The benchmark's harness: one run of one cell.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  Everything particular to one of them is
data the harness finds by name:

- ``stevi_bench/configs/<config>.json``: the deployment (image size,
  disparity range, matcher, penalties, the volume's dtype), the program's
  entry (``program``, a dotted path to a function of a gray pair), the plain
  reference (``reference``, a module of ``stevi_bench/reference/``), and
  ``check``: how many pool pairs are compared and the limits;
- ``stevi_bench/traffic/<mix>.json``: the closed loop's pairs in flight,
  the pool of pairs and its scenes, the traced segment's length;
- ``stevi_bench/metrics/<metric>.py`` (or, for ``name.suffix``,
  ``<name>.py``): ``read(run)``, the metric's value or None.

A run: set-up (a pool of pairs made from the seed on the device and held
in pinned host memory, the cell's own shape warmed up; a checkout's first
run also builds the kernels the entry loads, at their first call), the
measured window of ``seconds``, with ``trace`` a traced segment after it,
then the check of the window's answers against the reference once the
program's buffers are released.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import random
import subprocess
import sys
import time
import warnings
from collections import deque
from contextlib import nullcontext
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import check, scenes
from . import trace as tracing
from .guard import forbidden_modules

BENCH = "stevi_bench"
clock = time.perf_counter


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    root: Path
    bench: dict

    def metrics(self, traced: bool) -> list[dict]:
        """The cell's end-to-end (untraced) or per-layer (traced)
        metrics."""
        key = "per_layer" if traced else "end_to_end"
        return [m for m in self.bench[key]
                if self.name in m.get("workloads", [self.name])]


def _json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_cell(root: Path, workload: str) -> Cell:
    root = Path(root)
    bench = _json(root / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return Cell(workload, _json(root / entry["file"]),
                _json(root / BENCH / "traffic" / f"{cell['traffic']}.json"),
                int(cell["chips"]), root, bench)


def metric_reader(root: Path, name: str):
    """``read`` of ``metrics/<name>.py``, else of the file named by the
    part of ``name`` before its first dot."""
    folder = Path(root) / BENCH / "metrics"
    for stem in dict.fromkeys((name, name.split(".")[0])):
        path = folder / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"{BENCH}_metric_{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise FileNotFoundError(f"no reader for metric {name!r} in {folder}")


def resolve(dotted: str):
    """The object a dotted path names (``package.module.function``)."""
    module, _, attr = dotted.rpartition(".")
    return getattr(importlib.import_module(module), attr)


def reference_module(cell: Cell):
    return importlib.import_module(
        f"{BENCH}.reference.{cell.config['reference']}")


# ---------------------------------------------------------------------------
# The traffic loop
# ---------------------------------------------------------------------------

@dataclass
class Window:
    seconds: float = 0.0
    done: int = 0
    latencies: list = field(default_factory=list)   # s, every frame
    host_entry: list = field(default_factory=list)  # s around the entry call


class Answers:
    """Host buffers the answers land in: during the window, the first and
    the last answer for each pool pair; outside it, a ring as deep as the
    pairs in flight."""

    def __init__(self, n_pairs: int, ring: int, shape, pin: bool):
        def buf():
            t = torch.empty(shape, dtype=torch.float32)
            return t.pin_memory() if pin else t
        self.first = [buf() for _ in range(n_pairs)]
        self.last = [buf() for _ in range(n_pairs)]
        self.ring = [buf() for _ in range(ring)]
        self.first_frame = [-1] * n_pairs
        self.last_frame = [-1] * n_pairs

    def window_slot(self, k: int, p: int) -> torch.Tensor:
        if self.first_frame[p] < 0:
            self.first_frame[p] = k
            return self.first[p]
        self.last_frame[p] = k
        return self.last[p]

    def ring_slot(self, k: int, p: int) -> torch.Tensor:
        return self.ring[k % len(self.ring)]

    def checked(self, p: int) -> list[torch.Tensor]:
        """The window's answers for pool pair ``p``."""
        return ([self.first[p]] if self.first_frame[p] >= 0 else []) + \
               ([self.last[p]] if self.last_frame[p] >= 0 else [])


def drive(traffic: dict, forward, pool, device, seconds: float, slot,
          span=None, max_frames: int | None = None) -> Window:
    """Send pool pairs (cycled in order) through ``forward`` in a closed
    loop for ``seconds`` (or ``max_frames`` frames), then wait for every
    answer.  A frame: the pair copied from host memory to the device, the
    entry called, the disparity copied into ``slot(k, p)`` and an event
    recorded.  A frame is sent as soon as fewer than ``traffic["in_flight"]``
    are out, and its latency runs from its upload to the moment the host
    sees its event."""
    span = span or (lambda name: nullcontext())
    cap = int(traffic["in_flight"])
    cuda = device.type == "cuda"
    win, out = Window(), deque()
    n_pool = len(pool)

    def submit(k):
        t_sent = clock()
        p = k % n_pool
        with span("bench.upload"):
            left = pool[p][0].to(device, non_blocking=True)
            right = pool[p][1].to(device, non_blocking=True)
        t0 = clock()
        with span("bench.entry"):
            disp = forward(left, right)
        win.host_entry.append(clock() - t0)
        with span("bench.readback"):
            slot(k, p).copy_(disp, non_blocking=True)
            event = None
            if cuda:
                event = torch.cuda.Event()
                event.record()
        out.append((t_sent, event))

    def complete():
        t_sent, event = out.popleft()
        if event is not None:
            with span("bench.wait"):
                event.synchronize()
        win.latencies.append(clock() - t_sent)
        win.done += 1

    t_open = clock()
    t_end = t_open + seconds
    k = 0
    while (max_frames is None or k < max_frames) and clock() < t_end:
        if len(out) >= cap:
            complete()
        submit(k)
        k += 1
    while out:
        complete()
    win.seconds = clock() - t_open
    return win


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

@dataclass
class Run:
    cell: Cell
    setup_s: float = 0.0
    window: Window | None = None
    trace: tracing.Trace | None = None
    peak_window_bytes: int = 0
    peak_bytes: int = 0

    @property
    def config(self) -> dict:
        return self.cell.config


def make_pool(cell: Cell, seed: int, device):
    c, scene = cell.config, cell.traffic["scene"]
    return scenes.make_pool(c["height"], c["width"], c["disp_width"], seed,
                            scene["pool"], scene["planes"], scene["noise"],
                            device)


def checked_pairs(cell: Cell, seed: int, answered=None) -> list[int]:
    """The pool pairs whose window answers are compared, drawn from the
    seed among ``answered`` (default: every pair of the pool)."""
    answered = sorted(range(cell.traffic["scene"]["pool"]) if answered is None
                      else answered)
    return random.Random(seed).sample(
        answered, min(len(answered), cell.config["check"]["pairs"]))


def reference_answers(cell: Cell, pool, pairs, device,
                      volume_dtype: str | None = None) -> dict:
    """{pair: (H, W) host disparity} of the reference, ``check.batch`` pairs
    at a time on ``device``."""
    ref = reference_module(cell)
    batch = cell.config["check"].get("batch", 1)
    out = {}
    for b in range(0, len(pairs), batch):
        group = pairs[b:b + batch]
        left = torch.stack([pool[p][0] for p in group]).to(device)
        right = torch.stack([pool[p][1] for p in group]).to(device)
        disp = ref.disparity(left, right, cell.config, volume_dtype).cpu()
        out.update(zip(group, disp))
        del left, right
    return out


def verify(cell: Cell, pool, answers: Answers, seed: int, device):
    """(correct, checks): the window's answers for the drawn pairs against
    the reference's."""
    answered = [p for p in range(len(pool)) if answers.checked(p)]
    if not answered:
        raise RuntimeError("no answer came in the window")
    pairs = checked_pairs(cell, seed, answered)
    ref = reference_answers(cell, pool, pairs, device)
    program, expected = [], []
    for p in pairs:
        for a in answers.checked(p):
            program.append(a)
            expected.append(ref[p])
    return check.judge(check.compare(program, expected),
                       cell.config["check"]["limits"])


def traced_segment(cell: Cell, forward, pool, answers: Answers,
                   device) -> tracing.Trace:
    """The traffic under `torch.profiler` for ``trace_seconds``, after a
    traced warm-up step that is dropped."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    # the schedule's one active cycle is all the trace is read from
    warnings.filterwarnings("ignore", message=".*Profiler clears events")
    tr = cell.traffic
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1)) as prof:
        drive(tr, forward, pool, device, math.inf, answers.ring_slot,
              record_function, max_frames=int(tr["in_flight"]) + 1)
        _sync(device)
        prof.step()
        with record_function(tracing.WINDOW):
            win = drive(tr, forward, pool, device, tr["trace_seconds"],
                        answers.ring_slot, record_function)
            _sync(device)
        prof.step()
    return tracing.reduce(prof, win.done)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_python_ms() -> float:
    """Milliseconds a fixed piece of pure Python takes on this host, the
    best of 5: the single-core speed that paces the host-bound cells."""
    best = math.inf
    for _ in range(5):
        t0 = clock()
        sum(i * i for i in range(100_000))
        best = min(best, clock() - t0)
    return 1e3 * best


def host_info() -> dict:
    """What of the host may move the host-bound cells: its CPU (the model
    name, or vendor, family and model where the sandbox hides the name, and
    the clock it states), the cores this process may use, and its
    single-core speed."""
    info = {"host_cpus": len(os.sched_getaffinity(0)),
            "host_python_ms": host_python_ms()}
    try:
        with open("/proc/cpuinfo") as f:
            fields = dict(line.split(":", 1) for line in f if ":" in line)
    except OSError:
        return info
    fields = {k.strip(): v.strip() for k, v in fields.items()}
    name = fields.get("model name", "unknown")
    if name == "unknown":
        name = " ".join(fields.get(k, "?")
                        for k in ("vendor_id", "cpu family", "model"))
    info["host_cpu"] = f"{name} {fields.get('cpu MHz', '?')} MHz"
    return info


def card_info(device, chips: int) -> dict:
    """The ``device`` field: the card's name, the cards used, and what
    ``nvidia-smi`` says of its power limit and clocks."""
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips}
    if device.type != "cuda":
        return info
    keys = ("power.limit", "clocks.sm", "clocks.max.sm")
    try:
        smi = subprocess.run(
            ["nvidia-smi", f"--id={torch.cuda.current_device()}",
             f"--query-gpu={','.join(keys)}", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        vals = [v.strip() for v in smi.stdout.strip().split(",")]
        for key, val in zip(("power_limit_w", "clocks_sm_mhz",
                             "clocks_max_sm_mhz"), vals):
            info[key] = float(val)
    except (OSError, subprocess.SubprocessError, ValueError):
        pass
    return info


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float | None = None, forward=None) -> dict:
    """One run of ``cell``; returns the result line's object (without the
    import check).  ``forward`` replaces the configuration's program."""
    t_start = clock() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
    forward = forward or resolve(cell.config["program"])
    t_imported = clock()
    tr, cfg = cell.traffic, cell.config
    pool = make_pool(cell, seed, device)
    t_pool = clock()
    answers = Answers(len(pool), int(tr["in_flight"]),
                      (cfg["height"], cfg["width"]), cuda)
    drive(tr, forward, pool, device, math.inf, answers.ring_slot,
          max_frames=2 * int(tr["in_flight"]) + 2)
    _sync(device)
    result = Run(cell)
    if cuda:
        result.peak_bytes = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    t_warm = clock()
    result.setup_s = t_warm - t_start
    result.window = drive(tr, forward, pool, device, seconds,
                          answers.window_slot)
    if cuda:
        result.peak_window_bytes = torch.cuda.max_memory_allocated(device)
    if traced:
        result.trace = traced_segment(cell, forward, pool, answers, device)
    if cuda:
        result.peak_bytes = max(result.peak_bytes,
                                torch.cuda.max_memory_allocated(device))
    dev_info = card_info(device, cell.chips)
    dev_info["memory_peak_bytes"] = result.peak_bytes
    dev_info.update(host_info())
    if result.trace is not None:
        dev_info["busy_s"] = result.trace.busy_s
        dev_info["window_s"] = result.trace.window_s
    if cuda:
        torch.cuda.empty_cache()
    correct, checks = verify(cell, pool, answers, seed, device)
    metrics = {}
    for m in cell.metrics(traced):
        value = metric_reader(cell.root, m["name"])(result)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": result.window.done, "failed": 0,
            "metrics": metrics, "device": dev_info}
    if result.trace is not None:
        line["breakdown"] = result.trace.breakdown()
        line["traced_frames"] = result.trace.frames
    line["setup_parts_s"] = {"start": t_imported - t_start,
                             "pool": t_pool - t_imported,
                             "warmup": t_warm - t_pool}
    line["checks"] = checks
    return line


def main(root: Path, args, t_start: float) -> int:
    """The command line's run: no result unless a CUDA card is there for
    each chip the cell asks for, and none if JAX or the JAX package was
    loaded."""
    cell = load_cell(root, args.workload)
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{cell.name}: needs {cell.chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    line = run(cell, args.seed, args.seconds, bool(args.trace),
               torch.device("cuda", 0), t_start)
    found = forbidden_modules()
    if found:
        print(f"{cell.name}: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
