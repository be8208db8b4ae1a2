"""Where a frame's device time goes: each entry path under `torch.profiler`.

    python -m libstevi_tpu_torch.profile_frames [--frames sgm16,sgm16_d384,hd]
        [--reps 5] [--top 8]

Needs one CUDA device.  For each frame (a random pair from seed 3, at the
frame's own size; ``dist`` is `entry.distributed_forward` on that pair and
its mirror as a batch of 2, over a (batch=2, tile=2, dsh=2) mesh of 8
virtual shards on the card) it runs 3 warm-ups, times the frame with CUDA events
(median of 5), then profiles ``--reps`` frames after one traced warm-up
frame that it drops, and prints:
- device busy ms a frame: the union of the device intervals of every
  kernel, memcpy and memset, over the profiled frames, divided by ``reps``;
- the idle share: 1 - busy / the CUDA-event frame time;
- the ``--top`` device items by time, with µs a frame, launches a frame and
  share of busy.
The card's name and power limit (``nvidia-smi``) head the output.
"""

from __future__ import annotations

import argparse
import re
import subprocess
import sys
from collections import defaultdict

import numpy as np
import torch

from . import entry
from .core import MatchingFunction
from .ops import dense_sgm_stereo

FRAMES = {
    "flagship": ((entry.HEIGHT, entry.WIDTH), entry.flagship_forward),
    "sgm16": ((entry.HEIGHT, entry.WIDTH), entry.sgm16_forward),
    # SGM-16 past D = 320: K1, the lane route (K4b) and the any-D K2k
    "sgm16_d384": ((entry.HEIGHT, entry.WIDTH),
                   lambda L, R: dense_sgm_stereo(
                       MatchingFunction.ZNCC, L, R,
                       **dict(entry.SGM16, disp_width=384))[0]),
    "census": ((entry.HEIGHT, entry.WIDTH), entry.census_sgm_forward),
    "hd": ((entry.HD_HEIGHT, entry.HD_WIDTH), entry.hd_forward),
    "wide": ((entry.HEIGHT, entry.WIDTH), entry.wide_forward),
    "hd_wide": ((entry.HD_HEIGHT, entry.HD_WIDTH), entry.hd_wide_forward),
    # K1, K4d's four sweeps and K4b's column scans
    "uhd_wide": ((entry.UHD_HEIGHT, entry.UHD_WIDTH), entry.uhd_wide_forward),
    "patchmatch": ((entry.HEIGHT, entry.WIDTH), entry.patchmatch_forward),
    "wta_zsad": ((entry.HEIGHT, entry.WIDTH),
                 lambda L, R: entry.wta_forward(MatchingFunction.ZSAD, L, R)),
    "dist": ((entry.HEIGHT, entry.WIDTH), lambda L, R: dist_frame(L, R)),
}


def dist_frame(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """The flagship configuration through `distributed_full_step` over a
    (batch=2, tile=2, dsh=2) mesh of 8 virtual shards on L's device, the
    pair and its mirror as a batch of 2."""
    from .parallel import MeshSpec, make_stereo_mesh
    mesh = make_stereo_mesh(MeshSpec(batch=2, tile=2, dsh=2),
                            [L.device] * 8)
    return entry.distributed_forward(torch.stack([L, R.flip(-1)]),
                                     torch.stack([R, L.flip(-1)]), mesh)


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth = 0
    for k, ch in enumerate(name):     # cut at the argument list
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
    return name[:80]


def event_ms(fn, reps=5):
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_frame(fn, reps: int):
    """(busy µs a frame, {item: [µs a frame, launches a frame]}) over
    ``reps`` frames, after one frame that runs under the tracer and is
    dropped (a `torch.profiler.schedule` warm-up): late in a long process
    a trace without it has lost its first frame's device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=reps,
                                   repeat=1)) as prof:
        for _ in range(1 + reps):
            fn()
            torch.cuda.synchronize()
            prof.step()
    spans, items = [], defaultdict(lambda: [0.0, 0.0])
    for e in prof.events():
        # the schedule's step annotation spans the whole step on the device
        # timeline: not device work
        if e.device_type != DeviceType.CUDA or e.name.startswith(
                "ProfilerStep"):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        item = items[short_name(e.name)]
        item[0] += e.time_range.elapsed_us() / reps
        item[1] += 1 / reps
    busy, end = 0.0, float("-inf")
    for s, t in sorted(spans):        # union: overlapping streams count once
        busy += max(0.0, t - max(s, end))
        end = max(end, t)
    return busy / reps, dict(items)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", default=",".join(FRAMES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_frames: needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}", flush=True)
    dev = torch.device("cuda")
    for name in args.frames.split(","):
        (H, W), forward = FRAMES[name]
        rng = np.random.default_rng(3)
        L, R = (torch.from_numpy(rng.uniform(0, 1, (H, W)).astype(np.float32))
                .to(dev) for _ in range(2))

        def fn():
            return forward(L, R)
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        frame = event_ms(fn)
        busy, items = profile_frame(fn, args.reps)
        print(f"{name} {H}x{W}: frame {frame:.3f} ms (CUDA events, median of "
              f"5), device busy {busy / 1e3:.3f} ms a frame, idle share "
              f"{1 - busy / 1e3 / frame:.3f} ({smi})", flush=True)
        top = sorted(items.items(), key=lambda kv: -kv[1][0])[:args.top]
        for item, (us, n) in top:
            print(f"  {us:10.1f} us {n:7.1f} launches {100 * us / busy:5.1f}%"
                  f"  {item}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
