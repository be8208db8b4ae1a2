"""The port's spans and counters (`utils.profiling.span`, `count`,
`counters`, `reset_counters`) on the CPU: the span tree the SGM path draws
under `torch.profiler`, the route and form counters, and the registry."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

import libstevi_tpu_torch
from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.ops import dense_sgm_stereo, sgm_wta_truncated
from libstevi_tpu_torch.ops import sgm_lane_cuda as lane
from libstevi_tpu_torch.utils import profiling
from libstevi_tpu_torch.utils.profiling import (count, counters,
                                                reset_counters, span)

torch.set_num_threads(2)

STAGES = {"stevi.k1", "stevi.route", "stevi.k2", "stevi.k3", "stevi.k4d",
          "stevi.k4b", "stevi.bands", "stevi.refine"}


def _pair(H, W, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((H, W), generator=g), torch.rand((H, W), generator=g)


def _spans(prof):
    """The profiler's ``stevi.*`` host events: [(name, parent name)] in
    the order they began."""
    ev = sorted((e for e in prof.events() if e.name.startswith("stevi.")),
                key=lambda e: e.time_range.start)
    return [(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in ev]


def _traced(fn, *args, **kw):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args, **kw)
    return out, _spans(prof)


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = span("stevi.a"), span("stevi.b")
    assert a is b is profiling._NULL_SPAN
    with a:
        pass
    entry.flagship_forward(*_pair(12, 40))
    assert not [k for k in counters() if k.startswith("span")]


def test_span_under_a_profiler_is_a_record_function_event():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert torch.autograd._profiler_enabled()
        s = span("stevi.test")
        assert s is not profiling._NULL_SPAN
        with s:
            torch.ones(4).sum()
    assert [n for n, _ in _spans(prof)] == ["stevi.test"]
    c = counters()
    assert c["spans.stevi.test"] == 1 and c["span_ns.stevi.test"] > 0


def test_scan_route_draws_its_stages_in_order():
    _, spans = _traced(entry.flagship_forward, *_pair(12, 40))
    assert spans[0] == ("stevi.dense_sgm_stereo", None)
    assert spans[1:] == [(n, "stevi.dense_sgm_stereo") for n in
                         ("stevi.k1", "stevi.route", "stevi.k2", "stevi.k3",
                          "stevi.bands")]


def test_lane_route_draws_k4b_bands_and_refine():
    _, spans = _traced(entry.hd_wide_forward, *_pair(6, 12))
    names = [n for n, _ in spans]
    assert names[0] == "stevi.dense_sgm_stereo"
    assert {n for n, p in spans[1:]} <= STAGES
    assert all(p == "stevi.dense_sgm_stereo" for _, p in spans[1:])
    assert names[1:] == ["stevi.k1", "stevi.route", "stevi.k4b",
                         "stevi.bands", "stevi.refine"]


def test_chunked_lane_form_draws_k4d_then_k4b():
    cv = torch.rand((5, 9, 330), generator=torch.Generator().manual_seed(3))
    _, spans = _traced(lane.chunked_adj, cv, 0, 9, 0.1, 0.5, 100.0, 8,
                       wta_radius=1)
    assert [n for n, _ in spans] == ["stevi.route", "stevi.k4d",
                                     "stevi.k4b"]
    assert counters()["launches.chunked_sweep"] == 0    # CPU: plain


def test_span_host_time_nests():
    _traced(entry.flagship_forward, *_pair(12, 40))
    c = counters()
    frame = c["span_ns.stevi.dense_sgm_stereo"]
    assert c["spans.stevi.dense_sgm_stereo"] == 1
    inner = [c["span_ns." + s] for s in STAGES if c["spans." + s]]
    assert len(inner) == 5 and all(t > 0 for t in inner)
    assert sum(inner) <= frame


def test_profiler_warmup_step_draws_no_span():
    sched = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=[ProfilerActivity.CPU], schedule=sched) as prof:
        entry.flagship_forward(*_pair(12, 40))
        prof.step()
        entry.flagship_forward(*_pair(12, 40))
        prof.step()
    assert counters()["spans.stevi.dense_sgm_stereo"] == 1


@pytest.mark.parametrize("forward,shape,route,form", [
    (entry.flagship_forward, (12, 40), "scan", "k2_accumulate"),
    (entry.hd_wide_forward, (6, 12), "lane", "lane_fused"),
])
def test_route_and_form_count_one_decision_a_call(forward, shape, route,
                                                  form):
    for n in (1, 2):
        forward(*_pair(*shape, seed=n))
        c = counters()
        assert c["route." + route] == n and c["form." + form] == n
        assert sum(v for k, v in c.items() if k.startswith("route.")) == n
        assert sum(v for k, v in c.items() if k.startswith("form.")) == n
    assert not [k for k in c if k.startswith("launches.")]   # CPU: plain


def test_dense_route_and_wta_truncated_count_their_route():
    L, R = _pair(8, 20)
    dense_sgm_stereo(MatchingFunction.ZNCC, L, R, 1, 1, 6, 0.5, 0.1)
    assert counters() == {"route.dense": 1}
    reset_counters()
    cv = torch.rand((6, 14, 8))
    sgm_wta_truncated(cv, 0.1, 0.5)
    sgm_wta_truncated(cv, 0.1, 0.5)
    c = counters()
    assert c["route.scan"] == 2 and "form.k2_one_launch" not in c


def test_registry_counts_copies_and_resets():
    count("launches.example")
    count("launches.example", 3)
    c = counters()
    assert c["launches.example"] == 4 and c["never.counted"] == 0
    c["launches.example"] = 100
    assert counters()["launches.example"] == 4
    reset_counters()
    assert counters() == {}
    assert libstevi_tpu_torch.counters is counters
