"""Host-side C++ of the port, built with ``g++`` on first use and bound
with ctypes (the counterpart of `libstevi_tpu/native/`, for the sources
the port carries).

``native/<name>.cpp`` compiles into the package's git-ignored ``_build/``
as ``<name>-<hash>.so``, the hash covering the source and the flags, as
`_build` names the CUDA libraries: an edited source is rebuilt and a stale
library is never loaded.  No compiled library is committed and nothing
falls back: where ``g++`` is missing or fails, `library` raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from .._build import BUILD_DIR

SRC = Path(__file__).parent
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def lib_path(name: str) -> Path:
    """Where ``native/<name>.cpp`` builds to under the current flags."""
    src = (SRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(name: str) -> Path:
    """Compile ``native/<name>.cpp`` unless its library exists; returns
    the library's path.  Raises where ``g++`` is missing or fails."""
    out = lib_path(name)
    if out.exists():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: native/{name}.cpp is built with "
                           "the system's C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([gxx, *GXX_FLAGS, str(SRC / f"{name}.cpp"), "-o",
                          str(tmp)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for native/{name}.cpp:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)         # atomic: a concurrent build never sees half a file
    return out


@functools.cache
def maxflow_library() -> ctypes.CDLL:
    """The float-capacity Boykov-Kolmogorov max-flow (`maxflow.cpp`)."""
    lib = ctypes.CDLL(str(build("maxflow")))
    lib.bk_maxflow.restype = ctypes.c_double
    lib.bk_maxflow.argtypes = [
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    return lib
