"""A run whose timed path is broken underneath reads ``correct`` false;
the sound run reads it true.  The look for a chip is skipped: the cell
runs on the CPU at a small size, with the configuration's own limits."""

import pytest
import torch

from stevi_bench import harness


def _altered(forward):
    """An answer altered where it is produced: a band of rows a quarter
    of a pixel off."""
    def f(left, right):
        disp = forward(left, right).clone()
        disp[: disp.shape[0] // 4] += 0.25
        return disp
    return f


def _stale(forward):
    """The previous pair's answer handed back for this one."""
    last = []

    def f(left, right):
        disp = forward(left, right)
        out = last[0] if last else disp
        last[:] = [disp]
        return out
    return f


def _half(forward):
    """Half of the frame left out: its lower half never matched."""
    def f(left, right):
        disp = forward(left, right).clone()
        disp[disp.shape[0] // 2:] = float("nan")
        return disp
    return f


@pytest.mark.parametrize("fault", [None, _altered, _stale, _half])
@pytest.mark.parametrize("workload", ["vga_d120.stream", "vga_d120.live"])
def test_faults_read_incorrect(workload, fault, small_cell):
    cell = small_cell(workload)
    forward = harness.resolve(cell.config["program"])
    if fault is not None:
        forward = fault(forward)
    line = harness.run(cell, 2 ** 31 + 3, 0.5, False, torch.device("cpu"),
                       forward=forward)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"


def test_traced_run_on_the_cpu(small_cell):
    cell = small_cell("vga_d120.live")
    line = harness.run(cell, 2 ** 31 + 4, 0.3, True, torch.device("cpu"))
    assert line["correct"]
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device ran: the device's metrics are left out, not reported as 0
    assert set(line["metrics"]) == {"host_ms.live"}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["vga_d120.stream", "vga_d120.live"])
def test_cell_on_the_card(workload, cuda_device):
    cell = harness.load_cell(harness.Path(__file__).resolve().parents[2],
                             workload)
    line = harness.run(cell, 2 ** 31 + 11, 1.0, True, cuda_device)
    assert line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0
