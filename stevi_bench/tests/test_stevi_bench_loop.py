"""The traffic loop and the statistics over all frames of a window."""

import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from stevi_bench import harness
from stevi_bench.stats import percentile

ROOT = Path(__file__).resolve().parents[2]


def test_percentile_nearest_rank():
    v = list(range(1, 101))
    assert percentile(v, 50) == 50
    assert percentile(v, 95) == 95
    assert percentile([3.0], 95) == 3.0
    assert percentile([4, 1, 3, 2], 50) == 2
    with pytest.raises(ValueError):
        percentile([], 50)


def _pool(n=3):
    return [(torch.zeros(2, 3), torch.zeros(2, 3)) for _ in range(n)]


def _sleeper(seconds):
    def forward(left, right):
        time.sleep(seconds)
        return left + 1
    return forward


def test_closed_loop_counts_every_frame():
    ans = harness.Answers(3, 1, (2, 3), pin=False)
    win = harness.drive({"in_flight": 1},
                        _sleeper(0.01), _pool(), torch.device("cpu"), 0.3,
                        ans.window_slot)
    assert win.done == len(win.latencies) == len(win.host_entry)
    assert 10 <= win.done <= 31
    assert win.seconds >= 0.3
    assert min(win.latencies) >= 0.01
    assert all(f >= 0 for f in ans.first_frame)
    assert torch.equal(ans.last[0], torch.ones(2, 3))


def test_closed_loop_stops_at_max_frames():
    ans = harness.Answers(3, 2, (2, 3), pin=False)
    win = harness.drive({"in_flight": 2},
                        _sleeper(0.001), _pool(), torch.device("cpu"),
                        float("inf"), ans.ring_slot, max_frames=7)
    assert win.done == len(win.latencies) == 7


def test_rate_and_tails_over_all_frames():
    win = harness.Window(seconds=2.0, done=10,
                         latencies=[0.001 * k for k in range(1, 11)],
                         host_entry=[0.0005] * 10)
    run = SimpleNamespace(window=win)
    read = lambda n: harness.metric_reader(ROOT, n)(run)  # noqa: E731
    assert read("pairs_per_s") == 5.0
    assert read("latency_ms_p50") == pytest.approx(5.0)
    assert read("latency_ms_p95.middf") == pytest.approx(10.0)
    assert read("latency_ms_p50.middf") == pytest.approx(5.0)
    assert read("host_ms.live") == pytest.approx(0.5)
    assert read("host_ms.stream") == pytest.approx(0.5)


def test_checked_pairs_come_from_answered_pairs():
    cell = harness.load_cell(ROOT, "middf_d640.live")
    every = harness.checked_pairs(cell, 2 ** 31 + 1)
    assert len(every) == cell.config["check"]["pairs"]
    assert every == harness.checked_pairs(cell, 2 ** 31 + 1)
    few = harness.checked_pairs(cell, 2 ** 31 + 1, answered=[3, 0, 5])
    assert set(few) <= {0, 3, 5} and len(few) == 2
    assert harness.checked_pairs(cell, 7, answered=[4]) == [4]
