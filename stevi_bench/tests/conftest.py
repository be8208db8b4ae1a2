"""Test settings of the benchmark's own tests (run with
``python -m pytest stevi_bench/tests -q`` from the repository's root)."""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips where none is present")


@pytest.fixture
def cuda_device():
    """The first CUDA device; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def small_cell():
    """A factory of cells of BENCHMARK.json at a size the CPU runs in a
    second or two: the configuration's matcher, limits and program, a
    smaller image and pool."""
    def make(workload: str, height: int = 48, width: int = 160,
             pool: int = 4, root: Path = ROOT):
        from stevi_bench import harness
        cell = harness.load_cell(root, workload)
        cell.config.update(height=height, width=width)
        cell.traffic["scene"]["pool"] = pool
        cell.config["check"]["pairs"] = min(cell.config["check"]["pairs"],
                                            pool)
        cell.traffic["trace_seconds"] = 0.3
        return cell
    return make
