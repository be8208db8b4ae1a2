"""Where the any-D K2's time goes on the card: pass times and per-phase cycle
counts of `sgm_pass_group_kernel` (`csrc/sgm_scan.cu`, D > 320 with the
carry in registers).

    python -m libstevi_tpu_torch.pass_probe

For a 12x64x330 shard passed left to right (the D = 330 relays' K2), a
540x3840x384 shard (one of the distributed 4K UHD step's four) passed left
to right and top to bottom with carries, and 480x640x384 left to right
(f32 volumes, P1 0.3, P2 1.1, Pout 7) it prints:
- the pass's time on the device (torch.profiler, the mean of 10 launches)
  and as a call (CUDA events, median of 5 after 2 warm-ups);
- the kernel's cycles a step by phase, from a copy of the source with
  clock64() counters (`instrumented_source`) built beside the real one,
  for line 1's thread 0 (warp 0's lane 0, which issues the cost vector's
  bulk copies) and thread 32 (warp 1's): reading the minima and the
  neighbours' ends, waiting on the ring's barrier, loading the stage,
  refilling it (the proxy fence and the bulk copies), the DP and its
  stores, publishing the new minimum and ends, and the block barrier.
  The counters live in registers and are written once at the end; a
  phase's cycles include waiting for issue behind the SM's other warps.
The layout printed is the one the launcher reports it ran (`sgm_pass.layout`).

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
from .ops import sgm_cuda
from .ops.sgm import SgmDirection

PHASES = ("minima + ends", "mbar_wait", "stage loads", "refill", "DP + stores",
          "publish", "barrier")
# (H, W, D, direction, carries)
CASES = ((12, 64, 330, "LEFT2RIGHT", False),
         (540, 3840, 384, "LEFT2RIGHT", False),
         (540, 3840, 384, "UP2DOWN", True),
         (480, 640, 384, "LEFT2RIGHT", False))
Q = (0.3, 1.1, 7.0)

# (anchor, replacement) pairs in the group kernel: the counters, then a
# phase mark after each anchor; every anchor must occur exactly once
_PATCHES = (
    ("namespace {\n",
     "namespace {\n__device__ unsigned long long probe_acc[64];\n"
     "#define PHASE(k) if (me_) { const long long c_ = clock64(); "
     "acc_[k] += c_ - last_; last_ = c_; }\n"),
    ("  publish(0);\n  __syncthreads();\n  int i = L.si, j = L.sj, slot = 0;\n"
     "  for (int t = 0; t < L.len; ++t) {\n",
     "  publish(0);\n  __syncthreads();\n  int i = L.si, j = L.sj, slot = 0;\n"
     "  long long last_ = clock64(), acc_[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "  const bool me_ = blockIdx.x == 1 && blockIdx.y == 0 &&"
     " (threadIdx.x == 0 || threadIdx.x == 32);\n"
     "  const int off_ = threadIdx.x == 0 ? 0 : 8;\n"
     "  for (int t = 0; t < L.len; ++t) {\n"),
    ("    const float e_hi = g + 1 < G ? gedges[b][g + 1][0] : INFINITY;\n",
     "    const float e_hi = g + 1 < G ? gedges[b][g + 1][0] : INFINITY;\n"
     "    PHASE(0)\n"),
    ("    const T* cs = staged(st, cvp + pix * D);\n",
     "    PHASE(1)\n    const T* cs = staged(st, cvp + pix * D);\n"),
    ("    __syncwarp();  // the stage is read: refill it with the pixel S "
     "ahead\n    if (t + S < L.len)\n      stage_pixel(st, cb, ab, cvp, accp, "
     "n_acc, 0, pix + S * step, D,\n                  &bar[slot], lane, "
     "cnt);\n",
     "    PHASE(2)\n    __syncwarp();  // the stage is read: refill it with "
     "the pixel S ahead\n    if (t + S < L.len)\n      stage_pixel(st, cb, "
     "ab, cvp, accp, n_acc, 0, pix + S * step, D,\n                  "
     "&bar[slot], lane, cnt);\n    PHASE(3)\n"),
    ("    publish(b ^ 1);\n    __syncthreads();  // the minima and ends of "
     "this step whole\n",
     "    PHASE(4)\n    publish(b ^ 1);\n    PHASE(5)\n    __syncthreads();  "
     "// the minima and ends of this step whole\n    PHASE(6)\n"),
    ("    slot = slot + 1 == S ? 0 : slot + 1;\n  }\n}\n\n// The shared and "
     "device instances",
     "    slot = slot + 1 == S ? 0 : slot + 1;\n  }\n"
     "  if (me_) for (int k = 0; k < 7; ++k) probe_acc[off_ + k] = acc_[k];\n"
     "}\n\n// The shared and device instances"),
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
    """`csrc/sgm_scan.cu` with the clock64() phase counters in
    `sgm_pass_group_kernel` and the `probe_read` entry (raises if the
    source no longer has an anchor)."""
    src = (_build.CSRC / "sgm_scan.cu").read_text()
    for anchor, new in _PATCHES:
        if src.count(anchor) != 1:
            raise RuntimeError(f"pass_probe: anchor not found once: "
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


def device_ms(fn, reps=10) -> float:
    """The mean device time of the kernels one ``fn()`` launches, in ms
    (torch.profiler)."""
    from .profile_frames import profile_frame
    fn()
    torch.cuda.synchronize()
    busy, _ = profile_frame(fn, reps)
    return busy / 1e3


def _case(H, W, D, direction, carries):
    g = torch.Generator(device="cuda").manual_seed(D)
    cv = torch.rand((H, W, D), generator=g, device="cuda") * 4
    acc = torch.rand((H, W, D), generator=g, device="cuda")
    d = SgmDirection[direction]
    if carries:
        c = torch.rand((W, D), generator=g, device="cuda")
        return (lambda: sgm_cuda.sgm_shard_pass(cv, acc, d, *Q, True, c, H,
                                                4 * H)), (H if d.step[0]
                                                          else W)
    return (lambda: sgm_cuda.sgm_pass(cv, acc, d, *Q)), (W if d.step[0] == 0
                                                         else H)


def _instrumented_lib(tmp: Path) -> ctypes.CDLL:
    name = "sgm_scan_probe"
    cu = tmp / f"{name}.cu"
    cu.write_text(instrumented_source())
    so = tmp / f"{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, types in _build.SIGNATURES["sgm_scan"].items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p]
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def phase_counts(lib: ctypes.CDLL, fn, steps: int) -> dict:
    """Cycles a step by phase of the launch ``fn`` makes, run through the
    instrumented library ``lib``: {thread: {phase: cycles}}."""
    buf = (ctypes.c_ulonglong * 64)()
    real = _build.load
    _build.load = lambda name: lib if name == "sgm_scan" else real(name)
    try:
        fn()                                    # warm-up
        _build.check(lib, lib.probe_read(ctypes.addressof(buf)), "probe")
        fn()
        _build.check(lib, lib.probe_read(ctypes.addressof(buf)), "probe")
    finally:
        _build.load = real
    v = list(buf)
    return {tag: {k: round(c / steps) for k, c in zip(PHASES, v[o:o + 7])}
            for o, tag in ((0, "warp 0 lane 0"), (8, "warp 1 lane 0"))}


def main() -> int:
    if not torch.cuda.is_available():
        print("pass_probe: needs a CUDA card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    with tempfile.TemporaryDirectory() as tmp:
        lib = _instrumented_lib(Path(tmp))
        for H, W, D, direction, carries in CASES:
            fn, steps = _case(H, W, D, direction, carries)
            dev = device_ms(fn)
            layout = (sgm_cuda.sgm_shard_pass if carries
                      else sgm_cuda.sgm_pass).layout
            print(f"{H}x{W}x{D} f32 {direction}{' with carries' * carries} "
                  f"({smi}); layout {layout}: device {dev:.4f} ms, call "
                  f"{_median_ms(fn):.4f} ms a pass, {steps} steps a line",
                  flush=True)
            for who, v in phase_counts(lib, fn, steps).items():
                print(f"  cycles a step, {who}: {json.dumps(v)} "
                      f"(sum {sum(v.values())})", flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
