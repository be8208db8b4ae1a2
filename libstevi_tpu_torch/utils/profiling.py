"""Profiling, tracing and roofline accounting (counterpart of
`libstevi_tpu/utils/profiling.py`).

- `trace` records a `torch.profiler` trace of its block (host ops and,
  on a GPU, every kernel) and writes it to ``log_dir`` as a Chrome /
  TensorBoard trace (``*.pt.trace.json``).
- `device_time` and `device_timer` time ``iters`` calls after a warm-up
  call: between two CUDA events where the arguments or the result lie on
  a GPU, by the host clock otherwise.  The JAX package chains its calls
  in one `fori_loop` to hide a remote device's round trips; a local GPU
  has none, so the calls here are plain calls queued back to back.
- `cost_analysis` runs ``fn`` once and counts its work as it runs.
  ``flops`` comes from `torch.utils.flop_counter.FlopCounterMode`, which
  counts matrix products and convolutions only: an elementwise or
  reduction op counts no flops here, where XLA's cost analysis counts
  one a result.  ``bytes accessed`` is the bytes of every aten op's
  tensor inputs and outputs (views and other aliases move nothing and
  are skipped; an in-place op counts its tensor as read and written),
  the traffic of the ops run one after another with nothing kept on
  chip.
  For one (64, 128) @ (128, 32) float32 product both packages give 524288
  flops and 57344 bytes.
- `roofline` returns the JAX function's keys, against the peaks below.
- `span` marks a stage of the program, `stevi.<stage>` by convention
  (nesting gives the parent): under `torch.profiler` (or
  `torch.autograd.profiler.emit_nvtx`) a `record_function` event of the
  same trace as the device's activity, whose host nanoseconds also go to
  the counters (``spans.<name>``, ``span_ns.<name>``); with no profiler
  running, one shared null context, which costs one C call.
- `count`, `counters` and `reset_counters` are the one registry of the
  program's counts: ``launches.<wrapper>`` (each CUDA kernel wrapper's
  launches), ``route.<scan|lane|dense>`` (the SGM engine of each
  `dense_sgm_stereo` / `sgm_wta_truncated` call), ``form.k2_one_launch``
  / ``form.k2_accumulate`` (K2's form in `sgm_wta_fused`) and
  ``form.lane_fused`` / ``form.lane_chunked`` (K4b or K4d in the lane
  route), and the traced spans' counts and host nanoseconds.

The peaks are an H100 SXM5 80GB HBM3's at its 700 W power limit, from
NVIDIA's data sheet (a card set to a lower limit runs slower under load).
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

# H100 SXM5 80GB HBM3, 700 W: HBM3 rate
H100_HBM_BYTES_PER_S = 3.35e12
# H100 SXM5 80GB HBM3, 700 W: float32 outside the tensor cores
H100_PEAK_FLOPS_F32 = 67e12
# H100 SXM5 80GB HBM3, 700 W: dense bfloat16 on the tensor cores
H100_PEAK_FLOPS_BF16 = 989e12


_counts: Counter = Counter()
_NULL_SPAN = contextlib.nullcontext()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] += n


def counters() -> Counter:
    """A copy of every counter (a name never counted reads 0)."""
    return _counts.copy()


def reset_counters() -> None:
    """Zero every counter."""
    _counts.clear()


class _Span:
    """`record_function(name)`, whose host time inside it also goes to
    the counters ``spans.<name>`` (entries) and ``span_ns.<name>``."""

    __slots__ = ("name", "rf", "t0")

    def __init__(self, name: str):
        self.name = name
        self.rf = torch.profiler.record_function(name)

    def __enter__(self):
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        _counts["span_ns." + self.name] += time.perf_counter_ns() - self.t0
        _counts["spans." + self.name] += 1
        return self.rf.__exit__(*exc)


def span(name: str):
    """A context marking a stage of the program: while a profiler records
    (`torch.autograd._profiler_enabled`), a `record_function` span that
    also counts its host time; else one shared null context."""
    if torch.autograd._profiler_enabled():
        return _Span(name)
    return _NULL_SPAN


@contextlib.contextmanager
def trace(log_dir: str):
    """`torch.profiler` trace of the block, written to ``log_dir`` when it
    ends; view it in Perfetto, chrome://tracing or TensorBoard.  Yields
    the profiler (its `key_averages()` summarises the run)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()


def _on_gpu(*trees) -> bool:
    leaves, _ = tree_flatten(trees)
    return any(isinstance(x, torch.Tensor) and x.is_cuda for x in leaves)


def device_timer(fn, *args):
    """Warm ``fn(*args)`` up once and return ``measure(iters) ->
    seconds a call``, which can be called again for repeated
    measurements (A/B loops)."""
    out = fn(*args)
    gpu = _on_gpu(args, out)
    if gpu:
        torch.cuda.synchronize()

    def measure(iters: int = 20) -> float:
        if gpu:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            return max(start.elapsed_time(end) / 1e3 / iters, 1e-9)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return max((time.perf_counter() - t0) / iters, 1e-9)

    return measure


def device_time(fn, *args, iters: int = 20) -> float:
    """Seconds a call of ``fn(*args)``: the mean over ``iters`` calls
    after a warm-up call (CUDA events on a GPU, the host clock else)."""
    return device_timer(fn, *args)(iters)


class _ByteCounter(TorchDispatchMode):
    """Adds up the bytes of every aten op's tensor inputs and outputs,
    except where the op only aliases: a view, or an op whose every output
    shares an input's storage without mutating it (``_unsafe_view``)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins, _ = tree_flatten((args, kwargs))
        ins = [x for x in ins if isinstance(x, torch.Tensor)]
        outs, _ = tree_flatten(out)
        outs = [x for x in outs if isinstance(x, torch.Tensor)]
        if func.is_view:
            return out
        if outs and not func._schema.is_mutable:
            storages = {x.untyped_storage().data_ptr() for x in ins}
            if all(x.untyped_storage().data_ptr() in storages
                   for x in outs):
                return out
        self.bytes += sum(x.numel() * x.element_size() for x in ins + outs)
        return out


def cost_analysis(fn, *args) -> dict:
    """``{"flops", "bytes accessed"}`` of one run of ``fn(*args)``
    (matrix products' and convolutions' flops only; see the module's
    docstring)."""
    from torch.utils.flop_counter import FlopCounterMode
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops, counter:
        fn(*args)
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(counter.bytes)}


def roofline(fn, *args, iters: int = 20,
             hbm_bytes_per_s: float = H100_HBM_BYTES_PER_S,
             peak_flops: float = H100_PEAK_FLOPS_F32) -> dict:
    """Measure ``fn`` and situate it on the roofline model: the flops and
    bytes of `cost_analysis`, the memory- and compute-bound floors, the
    measured time a call (`device_time`), the achieved fraction of the
    binding floor and which resource binds."""
    ca = cost_analysis(fn, *args)
    flops = ca["flops"]
    byts = ca["bytes accessed"]
    t_mem = byts / hbm_bytes_per_s
    t_comp = flops / peak_flops
    t_bound = max(t_mem, t_comp)
    measured = device_time(fn, *args, iters=iters)
    return {
        "flops": flops,
        "bytes_accessed": byts,
        "arithmetic_intensity": flops / byts if byts else float("inf"),
        "memory_bound_s": t_mem,
        "compute_bound_s": t_comp,
        "measured_s": measured,
        "bound_by": "memory" if t_mem >= t_comp else "compute",
        "fraction_of_roofline": (t_bound / measured) if measured > 0
        else float("nan"),
    }
