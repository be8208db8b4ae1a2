"""The readers of the program's own spans and counters (route_host_ms,
glue_host_ms, launches) on synthetic counters."""

import sys
import types
from collections import Counter
from pathlib import Path
from types import SimpleNamespace

import pytest

from stevi_bench import harness, trace

ROOT = Path(__file__).resolve().parents[2]
MS = 1_000_000      # ns


def _reader(name):
    return harness.metric_reader(ROOT, name)


@pytest.fixture
def program(monkeypatch):
    """A package ``fakeprog`` whose ``counters()`` returns what the test
    puts in the yielded Counter; a run of it with one device item."""
    counts = Counter()
    pkg = types.ModuleType("fakeprog")
    pkg.counters = lambda: Counter(counts)
    monkeypatch.setitem(sys.modules, "fakeprog", pkg)
    tr = trace.from_events([("sgm_wta_kernel", 1, 2)],
                           [(0, 10, "bench.window")], frames=2)
    run = SimpleNamespace(trace=tr, config={"program": "fakeprog.entry.f"})
    return counts, run


def test_launches_a_frame(program):
    counts, run = program
    counts.update({"launches.box_cv": 30, "launches.window_stats": 30,
                   "launches.direction_volumes": 30, "launches.sgm_wta": 30,
                   "route.scan": 30, "form.k2_one_launch": 30,
                   "spans.stevi.k2": 7, "span_ns.stevi.k2": 7 * MS})
    assert _reader("launches.live")(run) == 4.0
    counts.update({"launches.chunked_sweep": 80, "route.lane": 10})
    assert _reader("launches.middf")(run) == pytest.approx(200 / 40)


def test_span_readers_per_traced_frame(program):
    counts, run = program
    counts.update({"spans.stevi.dense_sgm_stereo": 4,
                   "span_ns.stevi.dense_sgm_stereo": 10 * MS,
                   "span_ns.stevi.route": 2 * MS,
                   "span_ns.stevi.k1": 1 * MS, "span_ns.stevi.k2": 3 * MS,
                   "span_ns.stevi.k3": 2 * MS,
                   "span_ns.stevi.bands": 0.5 * MS,
                   "route.scan": 100, "launches.sgm_wta": 100})
    assert _reader("route_host_ms.live")(run) == pytest.approx(0.5)
    # 10 - (1 + 3 + 2) ms over 4 frames: the route and the band are glue
    assert _reader("glue_host_ms.stream")(run) == pytest.approx(1.0)
    counts.update({"span_ns.stevi.k4d": 1 * MS, "span_ns.stevi.k4b": 1 * MS})
    assert _reader("glue_host_ms.middf")(run) == pytest.approx(0.5)


def test_no_traced_frame_reads_null(program):
    counts, run = program
    counts.update({"route.scan": 3, "launches.sgm_wta": 3,
                   "span_ns.stevi.route": MS})
    assert _reader("route_host_ms.stream")(run) is None
    assert _reader("glue_host_ms.live")(run) is None
    assert _reader("launches.live")(run) == 1.0
    counts.clear()
    assert _reader("launches.live")(run) is None


@pytest.mark.parametrize("name", ["launches.live", "route_host_ms.live",
                                  "glue_host_ms.middf"])
def test_a_program_without_counters_reads_null(program, monkeypatch, name):
    counts, run = program
    counts.update({"route.scan": 1, "launches.sgm_wta": 4,
                   "spans.stevi.dense_sgm_stereo": 1,
                   "span_ns.stevi.dense_sgm_stereo": MS})
    assert _reader(name)(run) is not None
    monkeypatch.delattr(sys.modules["fakeprog"], "counters")
    assert _reader(name)(run) is None
    run.config = {"program": "no_such_package_here.entry.f"}
    assert _reader(name)(run) is None


@pytest.mark.parametrize("name", ["launches.live", "route_host_ms.live",
                                  "glue_host_ms.middf"])
def test_a_run_without_device_work_reads_null(program, name):
    counts, run = program
    counts.update({"route.scan": 1, "launches.sgm_wta": 4,
                   "spans.stevi.dense_sgm_stereo": 1,
                   "span_ns.stevi.dense_sgm_stereo": MS})
    run.trace = trace.from_events([], [(0, 10, "bench.window")], frames=2)
    assert _reader(name)(run) is None
    run.trace = None
    assert _reader(name)(run) is None


def test_gaps_inside_program_spans_are_labelled_by_their_stage():
    """The trace reduction as it is labels a gap that starts inside a
    program span by the span, under the harness's phase."""
    device = [("box_cv_kernel", 0, 2), ("sgm_pass_kernel", 5, 9)]
    host = [(0, 20, "bench.window"), (0, 12, "bench.entry"),
            (0, 11, "stevi.dense_sgm_stereo"), (1, 4, "stevi.route"),
            (1.5, 3.5, "cudaMemGetInfo"), (4, 6, "stevi.k2"),
            (12, 20, "bench.readback")]
    tr = trace.from_events(device, host, frames=1)
    assert tr.gaps == {"bench.entry > cudaMemGetInfo": 3.0,
                       "bench.entry > stevi.dense_sgm_stereo": 11.0}
    tr = trace.from_events(device, host[:4] + host[5:], frames=1)
    assert tr.gaps == {"bench.entry > stevi.route": 3.0,
                       "bench.entry > stevi.dense_sgm_stereo": 11.0}
