"""The readings the correctness limits are set from, at a cell's own size.

    python3 stevi_bench/control.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--program-dtype bfloat16] [--seconds 3] \
        [--out FILE]

For each of ``--seeds``: a run of the cell as the benchmark makes it (set-up,
a window of ``--seconds`` at the cell's own load, the check of the drawn
pairs' answers), which gives the program's numbers.  For each of
``--control-seeds``: the control, the reference computed with the volume in
the configuration's ``check.control_dtype`` (the next precision below the
configuration's) put in the program's place, compared by the same check;
with ``--program-dtype``, also the program itself with its volume stored in
that dtype, through the same window.  The benchmark's own runs never run
this.  Each reading is one JSON line on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def program_at(config: dict, dtype: str):
    """The configuration's matcher through the program's
    `dense_sgm_stereo` with the volume stored in ``dtype``."""
    import torch
    from libstevi_tpu_torch.core import MatchingFunction
    from libstevi_tpu_torch.ops import InterpolationKernel, dense_sgm_stereo
    kw = dict(h_radius=config["h_radius"], v_radius=config["v_radius"],
              disp_width=config["disp_width"], P1=config["P1"],
              P2=config["P2"], Pout=config["Pout"],
              n_directions=config["n_directions"],
              cost_vol_radius=config["cost_vol_radius"],
              refine_kernel=InterpolationKernel.PARABOLA,
              cv_dtype=getattr(torch, dtype))

    def forward(left, right):
        return dense_sgm_stereo(MatchingFunction.ZNCC, left, right, **kw)[0]
    return forward


def control_numbers(cell, seed: int, device) -> dict:
    """The check's numbers with the reference at ``control_dtype`` in the
    program's place, on the pairs a run of ``seed`` checks."""
    from stevi_bench import check, harness
    pool = harness.make_pool(cell, seed, device)
    pairs = harness.checked_pairs(cell, seed)
    expected = harness.reference_answers(cell, pool, pairs, device)
    low = harness.reference_answers(cell, pool, pairs, device,
                                    cell.config["check"]["control_dtype"])
    return check.compare([low[p] for p in pairs],
                         [expected[p] for p in pairs])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--program-dtype", default=None)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from stevi_bench import harness
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.load_cell(ROOT, args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(kind, seed, numbers, t0, extra=None):
        rec = {"workload": cell.name, "kind": kind, "seed": seed,
               "numbers": numbers, "seconds": round(time.time() - t0, 2)}
        rec.update(extra or {})
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t0 = time.time()
        line = harness.run(cell, seed, args.seconds, False, device)
        emit("program", seed, {k: v["value"] for k, v in
                               line["checks"].items()}, t0,
             {"metrics": {k: v["value"] for k, v in line["metrics"].items()},
              "correct": line["correct"]})
    for seed in control_seeds:
        t0 = time.time()
        emit(f"control_reference_{cell.config['check']['control_dtype']}",
             seed, control_numbers(cell, seed, device), t0)
        if args.program_dtype:
            t0 = time.time()
            line = harness.run(cell, seed, args.seconds, False, device,
                               forward=program_at(cell.config,
                                                  args.program_dtype))
            emit(f"control_program_{args.program_dtype}", seed,
                 {k: v["value"] for k, v in line["checks"].items()}, t0)
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
