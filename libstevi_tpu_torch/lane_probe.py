"""Where K4b's and K4c's time goes on the card: per-pass times and per-phase
cycle counts of the lane-layout SGM kernels (`csrc/sgm_lane.cu`).

    python -m libstevi_tpu_torch.lane_probe

For 480x640x384 and 720x1280x640 f32 (random volumes, P1 0.1, P2 0.5,
Pout 100) it prints:
- each pass's time (CUDA events, median of 5 after 2 warm-ups): the row
  sweep down (fresh) and up (accumulating), the forward column scan, the
  WTA scan without and with a stack of 8 knight volumes;
- each kernel's cycles a step by phase, from a copy of the source with
  clock64() counters (`instrumented_source`) built beside the real one:
  block 1's thread 0 (a part warp of its left edge column) and its issuer
  (a part warp of an interior column, which also publishes the block's
  row count and stages the rows) in the row sweeps, block 1's thread 0 in
  the column scans.  The counters live in registers and are written
  once at the end, so they add a few instructions a phase and no memory
  traffic; a phase's cycles include waiting for issue behind the SM's other
  warps.

Needs a CUDA card and nvcc; nothing here runs on a path an entry takes.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import tempfile
from pathlib import Path

import torch

from . import _build
from .ops import sgm_lane_cuda as lane

ROW_PHASES = ("mbar_wait", "prev_of (+ halo)", "compute", "minima",
              "barrier", "publish + stage")
COL_PHASES = ("carry min", "mbar_wait", "compute", "minima", "barrier",
              "stage")
SHAPES = ((480, 640, 384), (720, 1280, 640))

# (anchor, replacement) pairs: the counters, then a phase mark after each
# anchor; every anchor must occur exactly once
_PATCHES = (
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long probe_acc[64];\n"
     "#define PHASE(k) if (me_) { const long long c_ = clock64(); "
     "acc_[k] += c_ - last_; last_ = c_; }\n"),
    # the column scans: block 1, thread 0; offsets 0 (scan), 8 (WTA)
    ("\n  for (int t = 0; t < W; ++t) {\n",
     "\n  long long last_ = clock64(), acc_[6] = {0, 0, 0, 0, 0, 0};\n"
     "  const bool me_ = blockIdx.x == 1 && threadIdx.x == 0;\n"
     "  const int off_ = WTA ? 8 : 0;\n"
     "  for (int t = 0; t < W; ++t) {\n"),
    ("    const float m = t ? parts_min(cmin + ((t - 1) & 1) * G, G) : 0.f;\n",
     "    const float m = t ? parts_min(cmin + ((t - 1) & 1) * G, G) : 0.f;\n"
     "    PHASE(0)\n"),
    ("    if (S > 0) mbar_wait(&col_bars[t % S], (unsigned)(t / S) & 1u);\n",
     "    if (S > 0) mbar_wait(&col_bars[t % S], (unsigned)(t / S) & 1u);\n"
     "    PHASE(1)\n"),
    ("    lc = warp_min(lc);\n", "    PHASE(2)\n    lc = warp_min(lc);\n"),
    ("    __syncthreads();  // the carry, C and the parts' minima whole; the "
     "stage read\n",
     "    PHASE(3)\n    __syncthreads();  // the carry, C and the parts' "
     "minima whole; the stage read\n    PHASE(4)\n"),
    ("    if (S > 0 && t + S < W) stage_pix(t + S);  // the stage is read\n",
     "    if (S > 0 && t + S < W) stage_pix(t + S);  // the stage is read\n"
     "    PHASE(5)\n"),
    ("        if (lane == 0) a.idx[p] = best;\n      }\n    }\n  }\n}\n",
     "        if (lane == 0) a.idx[p] = best;\n      }\n    }\n  }\n"
     "  if (me_) for (int k = 0; k < 6; ++k) probe_acc[off_ + k] = acc_[k];\n"
     "}\n"),
    # the row sweep: block 1, thread 0 (an edge column's part warp) and the
    # issuer (an interior column's, which also publishes and stages);
    # offsets 16 and 24
    ("  for (int t = 0; t < H; ++t) {\n    const int i = row_of(t);\n",
     "  long long last_ = clock64(), acc_[6] = {0, 0, 0, 0, 0, 0};\n"
     "  const bool me_ = blockIdx.x == 1 && (threadIdx.x == 0 ||"
     " threadIdx.x == issuer);\n"
     "  const int off_ = threadIdx.x == 0 ? 16 : 24;\n"
     "  for (int t = 0; t < H; ++t) {\n    const int i = row_of(t);\n"),
    ("      if (stage_acc) acr = staged(st + L.slot, acr);\n    }\n",
     "      if (stage_acc) acr = staged(st + L.slot, acr);\n    }\n"
     "    PHASE(0)\n"),
    ("      const bool at_edge = DIAG && (lc == 0 || lc == nc - 1);\n",
     "      PHASE(1)\n"
     "      const bool at_edge = DIAG && (lc == 0 || lc == nc - 1);\n"),
    ("      if (mins_on) {\n        lv = warp_min(lv);\n",
     "      PHASE(2)\n      if (mins_on) {\n        lv = warp_min(lv);\n"),
    ("    __syncthreads();  // row i's carries complete, the stage read\n",
     "    PHASE(3)\n"
     "    __syncthreads();  // row i's carries complete, the stage read\n"
     "    PHASE(4)\n"),
    ("      if (S > 0 && t + S < H) stage_row(t + S);\n    }\n  }\n}\n",
     "      if (S > 0 && t + S < H) stage_row(t + S);\n    }\n    PHASE(5)\n"
     "  }\n"
     "  if (me_) for (int k = 0; k < 6; ++k) probe_acc[off_ + k] = acc_[k];\n"
     "}\n"),
)

_READ = '''
extern "C" int probe_read(void* dst) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(dst, probe_acc, sizeof(probe_acc));
  unsigned long long z[64] = {0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(probe_acc, z, sizeof(z));
  return (int)e;
}
'''


def instrumented_source() -> str:
    """`csrc/sgm_lane.cu` with the clock64() phase counters and the
    `probe_read` entry (raises if the source no longer has an anchor)."""
    src = (_build.CSRC / "sgm_lane.cu").read_text()
    for anchor, new in _PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"lane_probe: anchor not found once: "
                               f"{anchor[:60]!r}")
        src = src.replace(anchor, new)
    return src + _READ


def _median_ms(fn, reps=5):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _volumes(H, W, D):
    g = torch.Generator(device="cuda").manual_seed(1)
    cv = torch.rand((H, W, D), generator=g, device="cuda") * 3
    return cv, torch.rand((H, W, D), generator=g, device="cuda")


def pass_times(H: int, W: int, D: int) -> dict:
    """Each K4b pass's time at (H, W, D) f32, in ms."""
    cv, acc = _volumes(H, W, D)
    kw = dict(col0=0, W_pout=W, P1=0.1, P2=0.5, Pout=100.0)
    out = {
        "rows down": _median_ms(
            lambda: lane.fused_rows_pass(cv, None, False, True, **kw)),
        "rows up (acc)": _median_ms(
            lambda: lane.fused_rows_pass(cv, acc, True, True, **kw)),
        "column scan": _median_ms(
            lambda: lane.fused_cols_pass(cv, acc, False, **kw)),
        "WTA scan": _median_ms(lambda: lane.fused_cols_wta(cv, acc, 1, **kw)),
    }
    kv = torch.rand((8, H, W, D), device="cuda")
    out["WTA scan over 8 knights"] = _median_ms(
        lambda: lane.fused_cols_wta(cv, acc, 1, knights=kv, **kw))
    return out


def _instrumented_lib(tmp: Path) -> ctypes.CDLL:
    cu = tmp / "sgm_lane_probe.cu"
    cu.write_text(instrumented_source())
    so = tmp / "sgm_lane_probe.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, types in _build.SIGNATURES["sgm_lane"].items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def phase_counts(lib: ctypes.CDLL, H: int, W: int, D: int) -> dict:
    """Cycles a step by phase of each kernel at (H, W, D), run through the
    instrumented library ``lib``."""
    cv, acc = _volumes(H, W, D)
    kw = dict(col0=0, W_pout=W, P1=0.1, P2=0.5, Pout=100.0)
    buf = (ctypes.c_ulonglong * 64)()
    real = _build.load
    _build.load = lambda name: lib if name == "sgm_lane" else real(name)
    try:
        runs = {
            "rows down": (lambda: lane.fused_rows_pass(cv, None, False, True,
                                                       **kw), H),
            "rows up (acc)": (lambda: lane.fused_rows_pass(cv, acc, True,
                                                           True, **kw), H),
            "column scan": (lambda: lane.fused_cols_pass(cv, acc, False,
                                                         **kw), W),
            "WTA scan": (lambda: lane.fused_cols_wta(cv, acc, 1, **kw), W),
        }
        out = {}
        for name, (fn, steps) in runs.items():
            fn()                                    # warm-up
            _build.check(lib, lib.probe_read(ctypes.addressof(buf)), name)
            fn()
            _build.check(lib, lib.probe_read(ctypes.addressof(buf)), name)
            v = list(buf)
            for off, tag, names in ((0, "scan", COL_PHASES),
                                    (8, "WTA scan", COL_PHASES),
                                    (16, "edge part warp", ROW_PHASES),
                                    (24, "issuer (interior) part warp",
                                     ROW_PHASES)):
                if any(v[off:off + 6]):
                    out[f"{name}: {tag}"] = {
                        k: round(c / steps) for k, c in
                        zip(names, v[off:off + 6])}
        return out
    finally:
        _build.load = real


def main() -> int:
    if not torch.cuda.is_available():
        print("lane_probe: needs a CUDA card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        lib = _instrumented_lib(Path(tmp))
        for H, W, D in SHAPES:
            print(f"{H}x{W}x{D} f32 ({smi}); row layout down "
                  f"{lane.row_layout(W, D, 8, False)._asdict()}, up "
                  f"{lane.row_layout(W, D, 8, True)._asdict()}; column "
                  f"scans {lane.cols_layout(H, D, 0, False)._asdict()}",
                  flush=True)
            print("  ms a pass (median of 5):",
                  json.dumps({k: round(v, 4) for k, v in
                              pass_times(H, W, D).items()}), flush=True)
            for k, v in phase_counts(lib, H, W, D).items():
                print(f"  cycles a step, {k}: {json.dumps(v)} (sum "
                      f"{sum(v.values())})", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
