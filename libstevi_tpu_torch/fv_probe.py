"""Where K5's time goes on the card: the tiled instance of `csrc/fv_cv.cu`
timed whole and with one part taken out at a time.

    python -m libstevi_tpu_torch.fv_probe

At 480x640, D = 120 (RIGHT_TO_LEFT's shifts), F = 49 and 147, 'sad' and
'dot' into f32, it prints each form's time on the device (torch.profiler,
the mean of 10 launches):
- the kernel as it is (`fv_cv.cu`);
- without the stores of the volume (`no stores`);
- without the feature copies into shared memory (`no staging`: the
  arithmetic runs on whatever the buffers hold);
- without the compare-adds over f (`no arithmetic`: staging, barriers and
  stores only).
Each copy is built from the source by string anchors
(`ablated_source`); their results are not checked.  The general instance
(a shift list of step 2) is timed beside them.

Needs a CUDA card and nvcc; nothing here runs on a path an entry takes.
"""

from __future__ import annotations

import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from . import _build
from .ops import fv_backend

# ablation -> (anchor, replacement); every anchor must occur exactly once
ABLATIONS = {
    # the sums stay live: the compiler cannot drop the arithmetic
    "no stores": ("  if (!live) return;\n",
                  "  float keep_ = 0.f;\n"
                  "  for (int a = 0; a < JC; ++a)\n"
                  "    for (int b = 0; b < DC; ++b) keep_ += acc[a][b];\n"
                  "  if (keep_ == 1.2345e30f) store(out, keep_);\n"
                  "  return;\n"),
    "no staging": ("    asm volatile(\"cp.async.commit_group;\\n\" ::: "
                   "\"memory\");\n  };\n",
                   "  };\n"),
    "no arithmetic": ("    const int nf = live ? min(FC, F - q * FC) : 0;\n",
                      "    const int nf = 0;\n"),
}
_STAGING_LOOPS = ("        cp_async4(sb + fl * ss + u, src + (row + j) * F + f0 "
                  "+ fl, true);\n",
                  "        cp_async4(tb + fl * ts + u, ok ? tgt + (row + j) * F "
                  "+ f0 + fl : tgt,\n                  ok);\n")


def ablated_source(which: str) -> str:
    """`csrc/fv_cv.cu` with one part of the tiled instance taken out (raises
    if the source no longer has an anchor)."""
    src = (_build.CSRC / "fv_cv.cu").read_text()
    patches = [ABLATIONS[which]]
    if which == "no staging":
        patches += [(a, "        ;\n") for a in _STAGING_LOOPS]
    for anchor, new in patches:
        if src.count(anchor) != 1:
            raise RuntimeError(f"fv_probe: anchor not found once: "
                               f"{anchor[:60]!r}")
        src = src.replace(anchor, new)
    return src


def _lib(tmp: Path, which: str) -> ctypes.CDLL:
    name = "fv_cv_" + which.replace(" ", "_")
    cu = tmp / f"{name}.cu"
    cu.write_text(ablated_source(which))
    so = tmp / f"{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    for fn, types in _build.SIGNATURES["fv_cv"].items():
        getattr(lib, fn).argtypes = types
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def main() -> int:
    from .pass_probe import device_ms
    if not torch.cuda.is_available():
        print("fv_probe: needs a CUDA card")
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    g = torch.Generator(device="cuda").manual_seed(0)
    real = _build.load
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"as it is": None}
        libs.update({k: _lib(Path(tmp), k) for k in ABLATIONS})
        for F in (49, 147):
            fs, ft = (torch.rand((480, 640, F), generator=g, device="cuda")
                      - 0.5 for _ in range(2))
            for kernel in ("sad", "dot"):
                times = {}
                for name, lib in libs.items():
                    _build.load = (real if lib is None else
                                   lambda n, lib=lib: lib if n == "fv_cv"
                                   else real(n))
                    try:
                        times[name] = round(device_ms(
                            lambda: fv_backend.fused_fv_cost_volume(
                                kernel, fs, ft, range(120))), 4)
                    finally:
                        _build.load = real
                times["general instance"] = round(device_ms(
                    lambda: fv_backend.fused_fv_cost_volume(
                        kernel, fs, ft, list(range(0, 240, 2)))), 4)
                print(f"K5 480x640x120 F={F} '{kernel}' f32 ({smi}): device "
                      f"ms {times}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
