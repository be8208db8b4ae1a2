"""Builds the hand-written CUDA kernels under ``csrc/`` and binds them with
ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface (no PyTorch headers),
so ``nvcc`` compiles it in seconds into ``_build/<name>-<hash>.so``; the hash
covers the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.  Nothing is built when the package is imported:
`load` builds on first use, `build_all` builds every source up front (in
parallel) and returns the seconds it took.

Pointers and the stream go through ctypes as ``c_void_p`` (a plain Python
int would be cut to 32 bits), and every launch function returns the
``cudaError_t`` of ``cudaGetLastError()`` after its launch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C signature of every launch function, per source file.
SIGNATURES = {
    "box_cv": {
        # src, tgt, stats, H, W, h, v, ncc, n, stream
        "box_stats_launch": [_P] * 3 + [_I] * 5 + [_F, _P],
        # src, tgt, sum_s, inv_s, sum_t, inv_t, out, H, W, D, h, v, kind,
        # inv_n, negate, out_bf16, stream
        "box_cv_launch": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    },
    "sgm_lane": {
        # in, out, H, W_in, W_out, Dp, base, slope, stream
        "shift_rows_launch": [_P, _P] + [_I] * 6 + [_P],
        # cv, acc, out, edge, flags, cin, cout, H, W, D, ncols, G, S,
        # stage_acc, use_mins, col0, W_pout, P1, P2, Pout, reverse, diag,
        # i0, H_img, stream
        "fused_rows_launch": [_P] * 7 + [_I] * 10 + [_F] * 3 + [_I] * 4
                             + [_P],
        # cv, acc, knights, n_knights, out, idx, bands, spill, H, W, D,
        # col0, W_pout, P1, P2, Pout, reverse, r, wta, G, S, stream
        "fused_cols_launch": [_P] * 3 + [_I] + [_P] * 4 + [_I] * 5
                             + [_F] * 3 + [_I] * 5 + [_P],
        # cv, acc, out, hist, flags, spill, H, W, D, cw, G, use_mins, col0,
        # W_pout, P1, P2, Pout, reverse, shift_down, corner_c0,
        # corner_slope, with_vertical, with_diag, stream
        "chunked_sweep_launch": [_P] * 6 + [_I] * 8 + [_F] * 3 + [_I] * 6
                                + [_P],
    },
    "sgm_scan": {
        # cv, cv_bf16, acc, cin, cout, spill, n, steps (2n ints: di, dj),
        # H, W, D, P1, P2, Pout, accumulate, col0, W_pout, i0, H_img, used
        # (5 ints out: the any-D layout), stream
        "sgm_pass_launch": [_P, _I, _P, _P, _P, _P, _I, _P] + [_I] * 3
                           + [_F] * 3 + [_I] * 5 + [_P, _P],
        # cv, cv_bf16, vol, cin, cout, spill, n, steps (4n ints: v0, v1,
        # h0, h1), H, W, D, phase, P1, P2, Pout, col0, W_pout, s0, N_img,
        # stream
        "sgm_knight_launch": [_P, _I, _P, _P, _P, _P, _I, _P] + [_I] * 4
                             + [_F] * 3 + [_I] * 4 + [_P],
        # cv, cv_bf16, acc, n_acc, idx, bands, disp, H, W, D, P1, P2, Pout,
        # r, h_radius, v_radius, stream
        "sgm_wta_launch": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _F, _F,
                           _F] + [_I] * 3 + [_P],
    },
    "fv_cv": {
        # src, tgt, shifts, out, H, W, F, D, min_shift, span, kind,
        # out_bf16, step, stream
        "fv_cv_launch": [_P] * 4 + [_I] * 9 + [_P],
    },
    "patchmatch": {
        # cv, disp_in, cost_in, disp_out, cost_out, runs, H, W, D, lower,
        # axis, reverse, stream
        "pm_sweep_launch": [_P] * 6 + [_I] * 6 + [_P],
        # cv, cand, base, disp_in, cost_in, disp_out, cost_out, H, W, D, K,
        # lower, search, k0, n_random, stream
        "pm_probe_launch": [_P] * 7 + [_I] * 8 + [_P],
    },
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((str(Path(home) / "bin" / "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _start(name: str):
    """Start nvcc for one source unless its library exists; returns
    (process or None, target path)."""
    out = _lib_path(name)
    if out.exists():
        return None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), out


def _finish(started, out: Path) -> None:
    if started is None:
        return
    proc, tmp = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    os.replace(tmp, out)         # atomic: concurrent builders never see half a file


def build_all() -> float:
    """Build every kernel source (in parallel); returns the wall seconds."""
    t0 = time.perf_counter()
    jobs = [_start(name) for name in SIGNATURES]
    for started, out in jobs:
        _finish(started, out)
    return time.perf_counter() - t0


def ptxas_report(name: str) -> str:
    """What ``nvcc -Xptxas -v`` printed for one source (registers, shared
    memory, spills), or '' when the library was built by another process."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, with argtypes set."""
    _finish(*_start(name))
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.cuda_error_string.argtypes = [ctypes.c_int]
    lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a non-zero ``cudaError_t``."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
