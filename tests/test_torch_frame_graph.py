"""The flagship's frame replayed as one CUDA graph (`utils.frame_graph`,
`entry.FLAGSHIP_GRAPHS`) and the preallocated buffers it holds
(`ops.sgm.dense_sgm_buffers`).

The tests marked ``cuda`` skip where no CUDA device is present; on a
machine with a card, where JAX is absent (``tests/conftest.py`` imports
it): ``python -m pytest tests/test_torch_frame_graph.py --noconftest``.
The others run on the CPU, where inputs bypass the cache."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from libstevi_tpu_torch import entry
from libstevi_tpu_torch.core import MatchingFunction
from libstevi_tpu_torch.ops import dense_sgm_stereo
from libstevi_tpu_torch.ops.box_cuda import box_cv
from libstevi_tpu_torch.ops.sgm import dense_sgm_buffers
from libstevi_tpu_torch.ops.sgm_cuda import sgm_wta_fused
from libstevi_tpu_torch.utils.frame_graph import FrameGraphs, frame_key
from libstevi_tpu_torch.utils.profiling import counters, reset_counters

ZNCC = MatchingFunction.ZNCC
GRAPHS = entry.FLAGSHIP_GRAPHS


@pytest.fixture(autouse=True)
def _clean():
    GRAPHS.clear()
    reset_counters()
    yield
    GRAPHS.clear()
    reset_counters()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pairs(H, W, n, device="cpu", seed=0):
    """``n`` distinct pairs: a smoothed noise texture seen from the right,
    and shifted by 4 to 40 columns with noise 0.01 from the left."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tex = rng.uniform(0, 1, (H, W + 48))
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, 1, 1)) / 3
        d = int(rng.integers(4, 41))
        right = tex[:, :W]
        left = tex[:, d:d + W] + rng.normal(0, 0.01, (H, W))
        out.append(tuple(torch.from_numpy(x.astype(np.float32)).to(device)
                         for x in (left, right)))
    return out


def _eager(img_l, img_r):
    return dense_sgm_stereo(ZNCC, img_l, img_r, **entry.FLAGSHIP)[0]


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _launches(c):
    return sum(v for k, v in c.items() if k.startswith("launches."))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (64, 160)])
def test_replayed_frames_equal_the_eager_frames_bitwise(dev, shape):
    pairs = _pairs(*shape, 6, dev, seed=shape[0])
    expected = [_eager(*p) for p in pairs]
    reset_counters()
    got = [entry.flagship_forward(*p) for p in pairs]
    torch.cuda.synchronize()
    assert all(_same_bits(g, e) for g, e in zip(got, expected))
    c = counters()
    assert c["graph.capture"] == 1 and c["graph.replay"] == 4


@pytest.mark.cuda
def test_results_held_at_once_do_not_alias(dev):
    pairs = _pairs(480, 640, 6, dev, seed=1)
    expected = [_eager(*p) for p in pairs]
    for p in pairs[:2]:                  # eager, then the capture
        entry.flagship_forward(*p)
    held = [entry.flagship_forward(*p) for p in pairs[2:]]  # in flight
    torch.cuda.synchronize()
    assert len({t.data_ptr() for t in held}) == len(held)
    assert all(_same_bits(g, e) for g, e in zip(held, expected[2:]))
    assert counters()["graph.replay"] == 4


@pytest.mark.cuda
def test_a_new_geometry_captures_anew_and_two_are_held(dev):
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    a, b, c = [_pairs(*s, 1, dev, seed=s[0])[0]
               for s in ((48, 160), (64, 160), (40, 176))]

    def call(pair, captures, replays):
        entry.flagship_forward(*pair)
        got = counters()
        assert (got["graph.capture"], got["graph.replay"]) == (captures,
                                                                replays)

    for k, pair in enumerate((a, b, c)):      # eager, capture, replay each
        call(pair, k, k)
        call(pair, k + 1, k)
        call(pair, k + 1, k + 1)
    call(c, 3, 4)                             # c and b held, a evicted
    call(b, 3, 5)
    call(a, 3, 5)                             # eager again; evicts c
    call(a, 4, 5)
    call(b, 4, 6)
    call(c, 4, 6)                             # eager again
    GRAPHS.clear()
    torch.cuda.synchronize()
    held = sum(t.numel() * t.element_size() for p in (a, b, c) for t in p)
    assert torch.cuda.memory_allocated() == before + held


@pytest.mark.cuda
def test_a_replayed_frame_counts_one_frame(dev):
    pairs = _pairs(480, 640, 3, dev, seed=2)
    for p in pairs[:2]:
        entry.flagship_forward(*p)
    c0 = counters()
    assert c0["graph.capture"] == 1 and c0["route.scan"] == 2
    assert _launches(c0) == 8 and c0["form.k2_one_launch"] == 2
    entry.flagship_forward(*pairs[2])
    c1 = counters()
    assert _launches(c1) - _launches(c0) == 4
    for k in ("route.scan", "form.k2_one_launch", "graph.replay",
              "launches.window_stats", "launches.box_cv",
              "launches.direction_volumes", "launches.sgm_wta"):
        assert c1[k] - c0[k] == 1, k
    assert c1["graph.capture"] == 1


@pytest.mark.cuda
def test_hd_wide_forward_is_never_captured(dev):
    pair = _pairs(16, 704, 1, dev)[0]
    for _ in range(3):
        entry.hd_wide_forward(*pair)
    c = counters()
    assert c["route.lane"] == 3
    assert c["graph.capture"] == 0 and c["graph.replay"] == 0


@pytest.mark.cuda
def test_a_replayed_frame_draws_its_spans_and_kernels(dev):
    pairs = _pairs(480, 640, 3, dev, seed=3)
    for p in pairs[:2]:
        entry.flagship_forward(*p)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        entry.flagship_forward(*pairs[2])
        torch.cuda.synchronize()
    events = prof.events()
    host = {(e.name, e.cpu_parent.name if e.cpu_parent else None)
            for e in events if e.name.startswith("stevi.")}
    assert host == {("stevi.dense_sgm_stereo", None),
                    ("stevi.route", "stevi.dense_sgm_stereo")}
    kernels = " ".join(e.name for e in events
                       if e.device_type == torch.autograd.DeviceType.CUDA)
    for name in ("box_stats_kernel", "box_cv_kernel", "sgm_pass_kernel",
                 "sgm_wta_kernel"):
        assert name in kernels, name
    c = counters()
    assert c["spans.stevi.dense_sgm_stereo"] == 1
    assert c["spans.stevi.route"] == 1 and c["span_ns.stevi.route"] > 0
    assert c["spans.stevi.k1"] == 0


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------

def test_cpu_inputs_bypass_the_cache():
    pairs = _pairs(12, 40, 3)
    for p in pairs:
        assert _same_bits(entry.flagship_forward(*p), _eager(*p))
    c = counters()
    assert not [k for k in c if k.startswith("graph.")]
    assert c["route.scan"] == 6


def test_cpu_frames_run_the_forward_every_call():
    calls = []

    def forward(img_l, img_r, **buffers):
        calls.append(buffers)
        return img_l

    def buffers(img_l, img_r):
        raise AssertionError("no buffers for CPU inputs")

    graphs = FrameGraphs(forward, buffers)
    pair = _pairs(4, 8, 1)[0]
    for _ in range(3):
        assert graphs(*pair) is pair[0]
    assert calls == [{}] * 3


def _variant(case, t):
    if case == "shape":
        return t[:, :-1]
    if case == "dtype":
        return t.double()
    if case == "stride":
        return t.t().contiguous().t()
    return torch.empty_like(t, device="meta")


@pytest.mark.parametrize("case", ["shape", "dtype", "stride", "device"])
def test_frame_key_separates(case):
    left, right = _pairs(6, 6, 1)[0]
    key = frame_key(left, right)
    assert frame_key(left.clone(), right.clone()) == key
    assert frame_key(_variant(case, left), right) != key
    assert frame_key(left, _variant(case, right)) != key


@pytest.mark.parametrize("form", ["stack", "accumulator"])
def test_preallocated_buffers_give_the_same_bits(form):
    left, right = _pairs(12, 40, 1)[0]
    bufs = dense_sgm_buffers(left, 120, 8, torch.bfloat16)
    assert bufs["volume"].dtype == torch.bfloat16
    assert bufs["k2"].shape == (12, 40, 120)     # CPU: the accumulator
    if form == "stack":
        bufs["k2"] = torch.empty((7, 12, 40, 120))
    reset_counters()
    got = dense_sgm_stereo(ZNCC, left, right, **entry.FLAGSHIP, **bufs)
    want = dense_sgm_stereo(ZNCC, left, right, **entry.FLAGSHIP)
    for g, w in zip(got, want):
        assert _same_bits(g.float(), w.float())
    assert counters()["form.k2_one_launch"] == (form == "stack")


def test_sixteen_directions_take_a_float32_volume():
    left, _ = _pairs(6, 20, 1)[0]
    assert dense_sgm_buffers(left, 8, 16, torch.bfloat16)["volume"].dtype \
        == torch.float32


@pytest.mark.parametrize("config,func,channels", [
    pytest.param("HD_WIDE", ZNCC, 0,        # the lane route
                 id="HD_WIDE-MatchingFunction.ZNCC"),
    # multichannel images: the census kernel takes gray pairs only
    pytest.param("FLAGSHIP", MatchingFunction.CENSUS, 1,
                 id="FLAGSHIP-MatchingFunction.CENSUS"),
])
def test_buffers_are_refused_off_the_k1_scan_route(config, func, channels):
    left, right = _pairs(6, 20, 1)[0]
    if channels:
        left, right = left[..., None], right[..., None]
    cfg = getattr(entry, config)
    volume = torch.empty((6, 20, cfg["disp_width"]))
    with pytest.raises(ValueError, match="K1 \\+ scan route"):
        dense_sgm_stereo(func, left, right, **cfg, volume=volume)


def test_box_cv_writes_out_and_checks_it():
    left, right = _pairs(6, 20, 1)[0]
    out = torch.empty((6, 20, 8), dtype=torch.bfloat16)
    assert box_cv(ZNCC, left, right, 3, 3, 8, torch.bfloat16, out=out) is out
    assert torch.equal(out, box_cv(ZNCC, left, right, 3, 3, 8,
                                   torch.bfloat16))
    with pytest.raises(ValueError, match="out must be"):
        box_cv(ZNCC, left, right, 3, 3, 8, torch.float32, out=out)


def test_sgm_wta_fused_refuses_a_stack_of_another_size():
    cv = torch.rand((6, 20, 8))
    with pytest.raises(ValueError, match="acc of shape"):
        sgm_wta_fused(cv, 0.1, 0.5, 100.0, 8, 1, 3, 3, True,
                      acc=torch.empty((6, 6, 20, 8)))
