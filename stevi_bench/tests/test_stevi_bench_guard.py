"""The import check: top-level module names compared whole."""

import subprocess
import sys
from pathlib import Path

import pytest

from stevi_bench.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("modules,found", [
    (["libstevi_tpu_torch", "libstevi_tpu_torch.ops.sgm", "torch"], []),
    (["libstevi_tpu", "libstevi_tpu.ops"], ["libstevi_tpu"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["jax_tools", "jaxtyping", "flaxen", "libstevi_tpu_extra"], []),
])
def test_top_level_names_whole(modules, found):
    assert forbidden_modules(modules) == found


def _loaded(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _loaded("import stevi_bench.harness, stevi_bench.control, "
                     "stevi_bench.reference.zncc_sgm, libstevi_tpu_torch.entry")
    assert "libstevi_tpu_torch" in loaded
    assert not forbidden_modules(loaded)


def test_reference_loads_nothing_of_the_program():
    loaded = _loaded("import stevi_bench.reference.zncc_sgm")
    assert not loaded & {"libstevi_tpu_torch", "libstevi_tpu", "jax"}
