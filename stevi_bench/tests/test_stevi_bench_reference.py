"""The plain reference against the port's CPU path, and the control."""

from pathlib import Path

import pytest
import torch

from stevi_bench import check, harness, scenes
from stevi_bench.reference import zncc_sgm

ROOT = Path(__file__).resolve().parents[2]

CONFIGS = {"vga": "libstevi_vga_zncc_sgm8_d120",
           "middf": "middlebury2014_f_zncc_sgm8_d640"}


def _config(key, **over):
    c = harness._json(ROOT / "stevi_bench" / "configs" / f"{CONFIGS[key]}.json")
    c.update(over)
    return c


def _pair(H, W, D, seed):
    gen = torch.Generator().manual_seed(seed)
    left, right, _ = scenes.make_pair(H, W, D, gen, 6, 0.01)
    return left, right


def _port(config, left, right):
    from libstevi_tpu_torch.core import MatchingFunction
    from libstevi_tpu_torch.ops import InterpolationKernel, dense_sgm_stereo
    return dense_sgm_stereo(
        MatchingFunction.ZNCC, left, right, h_radius=config["h_radius"],
        v_radius=config["v_radius"], disp_width=config["disp_width"],
        P1=config["P1"], P2=config["P2"], Pout=config["Pout"],
        n_directions=config["n_directions"],
        cost_vol_radius=config["cost_vol_radius"],
        refine_kernel=InterpolationKernel.PARABOLA,
        cv_dtype=getattr(torch, config["volume_dtype"]))[0]


@pytest.mark.parametrize("key,H,W,D", [
    ("vga", 48, 64, 16),        # the scan route's plain versions (K1-K3)
    ("vga", 40, 160, 120),      # the configuration's own range
    ("middf", 48, 64, 16),      # float32 volume, scan route
    ("middf", 20, 400, 336),    # past D = 320: the lane route (K4b/K4d)
])
def test_reference_matches_port_cpu(key, H, W, D):
    config = _config(key, height=H, width=W, disp_width=D)
    left, right = _pair(H, W, D, 7)
    port = _port(config, left, right)
    ref = zncc_sgm.disparity(left[None], right[None], config)[0]
    numbers = check.compare([port], [ref])
    assert numbers["mismatch_share"] <= 1e-3, numbers
    assert numbers["subpixel_gap_px"] <= 1e-4, numbers
    assert port.isnan().equal(ref.isnan())


def test_reference_batches_alike():
    config = _config("vga", height=32, width=96, disp_width=24)
    pairs = [_pair(32, 96, 24, s) for s in (1, 2)]
    left = torch.stack([p[0] for p in pairs])
    right = torch.stack([p[1] for p in pairs])
    both = zncc_sgm.disparity(left, right, config)
    for b in range(2):
        one = zncc_sgm.disparity(left[b:b + 1], right[b:b + 1], config)[0]
        assert torch.equal(both[b].nan_to_num(-1), one.nan_to_num(-1))


def test_reference_recovers_a_shift():
    """A fronto-parallel shift of 5 px: the winner is 5 inside the band's
    valid region."""
    config = _config("vga", height=32, width=96, disp_width=16,
                     volume_dtype="float32")
    gen = torch.Generator().manual_seed(3)
    right = torch.rand(32, 96, generator=gen)
    left = torch.roll(right, 5, 1)
    disp = zncc_sgm.disparity(left[None], right[None], config)[0]
    inner = disp[4:-4, 4:80]
    assert (inner - 5).abs().max() < 0.05


@pytest.mark.parametrize("workload", ["vga_d120.live", "middf_d640.live"])
def test_control_fails_the_limits(workload, small_cell):
    """The reference with its volume one precision lower, in the program's
    place, fails the cell's check at a size the CPU holds."""
    shape = {"vga_d120.live": (48, 160), "middf_d640.live": (16, 704)}
    cell = small_cell(workload, *shape[workload])
    pool = harness.make_pool(cell, 2 ** 31 + 5, torch.device("cpu"))
    pairs = harness.checked_pairs(cell, 2 ** 31 + 5)
    exp = harness.reference_answers(cell, pool, pairs, torch.device("cpu"))
    low = harness.reference_answers(cell, pool, pairs, torch.device("cpu"),
                                    cell.config["check"]["control_dtype"])
    numbers = check.compare([low[p] for p in pairs], [exp[p] for p in pairs])
    correct, _ = check.judge(numbers, cell.config["check"]["limits"])
    assert not correct, numbers
