"""The trace reduction and the roofline arithmetic on synthetic data."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from stevi_bench import harness, roofline, trace

ROOT = Path(__file__).resolve().parents[2]
VGA = {"height": 480, "width": 640, "disp_width": 120, "n_directions": 8,
       "volume_dtype": "bfloat16"}
MIDDF = {"height": 1988, "width": 2632, "disp_width": 640,
         "n_directions": 8, "volume_dtype": "float32"}


def test_union_and_gaps():
    busy, gaps = trace.union_us([(5, 15), (0, 10), (20, 30), (22, 25)],
                                0, 40)
    assert busy == 25
    assert gaps == [(15, 20), (30, 40)]
    busy, gaps = trace.union_us([(-5, 3), (38, 50)], 0, 40)
    assert busy == 5 and gaps == [(3, 38)]


def _synthetic():
    device = [("void sgm_pass_kernel<4, __nv_bfloat16>(Args)", 0, 10),
              ("void sgm_wta_kernel<__nv_bfloat16>(WtaArgs)", 10, 16),
              ("Memcpy HtoD (Pinned -> Device)", 18, 19),
              ("box_cv_kernel<3>(float const*)", 20, 30),
              ("late_kernel", 45, 50)]
    host = [(0, 40, "bench.window"), (0, 17, "bench.upload"),
            (16, 17.5, "aten::copy_"), (17.5, 19.5, "bench.entry"),
            (30, 40, "bench.wait"), (30, 40, "cudaEventSynchronize")]
    return trace.from_events(device, host, frames=2)


def test_trace_busy_idle_and_labels():
    tr = _synthetic()
    assert tr.window == (0, 40)
    assert len(tr.device) == 4             # the item past the window is out
    assert tr.busy_us == pytest.approx(27)
    assert tr.gaps == {"bench.upload > aten::copy_": 2.0,
                       "bench.entry": 1.0,
                       "bench.wait > cudaEventSynchronize": 10.0}
    assert tr.kernel_us(["sgm_pass_kernel", "sgm_wta_kernel"]) == (16.0, 2)
    assert tr.kernel_us(["renamed_kernel"]) == (0.0, 0)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["sgm_pass_kernel<4, __nv_bfloat16>", 1e-5]
    assert bd["idle_gaps"][0] == ["bench.wait > cudaEventSynchronize", 1e-5]
    assert len(bd["device_ops"]) <= 10 and len(bd["idle_gaps"]) <= 10


def test_names():
    assert trace.base_name("void (anonymous namespace)::fused_rows_kernel"
                           "(RowArgs)") == "fused_rows_kernel"
    assert trace.short_name("void k<a<b>, c>(x)") == "k<a<b>, c>"


def _reader(name):
    return harness.metric_reader(ROOT, name)


def test_stage_counts():
    k1 = harness.metric_reader(ROOT, "box_cv_roofline.stream")
    assert k1.__globals__["stage"](VGA) == (2 * 4 * 307200
                                            + 2 * 36864000, 8 * 36864000)
    sgm = harness.metric_reader(ROOT, "sgm_scan_roofline.live")
    assert sgm.__globals__["stage"](VGA) == (2 * 36864000 + 4 * 307200,
                                             64 * 36864000)
    lane = harness.metric_reader(ROOT, "sgm_lane_roofline.middf")
    n = 1988 * 2632 * 640
    assert lane.__globals__["stage"](MIDDF) == (4 * n + 4 * 1988 * 2632,
                                                64 * n)
    # the VGA SGM stage is bound by its operations, Middlebury's by bytes
    assert roofline.bound_s(2 * 36864000 + 4 * 307200, 64 * 36864000) == \
        pytest.approx(64 * 36864000 / 67e12)
    assert roofline.bound_s(4 * n, 64 * n) == pytest.approx(4 * n / 3.35e12)


def test_roofline_reads_null_without_its_kernels():
    tr = _synthetic()
    run = SimpleNamespace(trace=tr, config=VGA)
    share = _reader("sgm_scan_roofline.stream")(run)
    bound = roofline.bound_s(2 * 36864000 + 4 * 307200, 64 * 36864000)
    assert share == pytest.approx(100 * 2 * bound / 16e-6)
    assert _reader("sgm_lane_roofline.middf")(run) is None
    assert _reader("idle_share.live")(run) == pytest.approx(100 * 13 / 40)
    assert _reader("device_items.live")(run) == 2.0
    run.trace = None
    assert _reader("box_cv_roofline.live")(run) is None
