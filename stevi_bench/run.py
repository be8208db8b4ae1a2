"""The benchmark of libstevi_tpu_torch on NVIDIA GPUs.

    python3 stevi_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout.  The cell is an entry of ``workloads`` in
``BENCHMARK.json``.  Prints, as the last line of standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit (also the last lines of
standard error).  Exits non-zero with no result where the cell's CUDA
devices are missing, or where JAX or the JAX package was loaded.  Build
and kernel caches stay inside the checkout (``libstevi_tpu_torch/_build``
and ``.stevi_bench_cache/``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache = ROOT / ".stevi_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    from stevi_bench import harness
    return harness.main(ROOT, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
