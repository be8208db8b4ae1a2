"""Host-side C++ of the port, built with ``g++`` on first use and bound
with ctypes (the counterpart of `libstevi_tpu/native/`): the LAS codec
(`las_codec.cpp`), the LZF codec of PCD ``binary_compressed`` payloads
(`lzf_codec.cpp`) and the max-flow solver (`maxflow.cpp`).

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


class LasInfo(ctypes.Structure):
    """`las_read_info`'s header summary (`las_codec.cpp`)."""
    _fields_ = [
        ("version_major", ctypes.c_uint8),
        ("version_minor", ctypes.c_uint8),
        ("point_format", ctypes.c_uint8),
        ("point_record_len", ctypes.c_uint16),
        ("n_points", ctypes.c_uint64),
        ("header_size", ctypes.c_uint32),
        ("offset_to_points", ctypes.c_uint64),
        ("scale", ctypes.c_double * 3),
        ("offset", ctypes.c_double * 3),
        ("mins", ctypes.c_double * 3),
        ("maxs", ctypes.c_double * 3),
        ("n_vlrs", ctypes.c_uint32),
        ("n_evlrs", ctypes.c_uint32),
        ("start_of_evlrs", ctypes.c_uint64),
        ("extra_bytes", ctypes.c_uint16),
        ("file_source_id", ctypes.c_uint16),
        ("global_encoding", ctypes.c_uint16),
    ]


class LasVlrMeta(ctypes.Structure):
    """One (E)VLR's header fields (`las_read_vlr_meta`)."""
    _fields_ = [
        ("user_id", ctypes.c_char * 17),
        ("description", ctypes.c_char * 33),
        ("record_id", ctypes.c_uint16),
        ("payload_len", ctypes.c_uint64),
    ]


@functools.cache
def las_library() -> ctypes.CDLL:
    """The LAS codec (`las_codec.cpp`): every point format 0-10, VLRs /
    EVLRs, chunked reads and the chunk-streaming writer."""
    lib = ctypes.CDLL(str(build("las_codec")))
    P, I, LL, U64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_uint64)
    sigs = {
        "las_read_info": ([ctypes.c_char_p, ctypes.POINTER(LasInfo)], I),
        "las_read_vlr_meta": ([ctypes.c_char_p, I,
                               ctypes.POINTER(LasVlrMeta)], I),
        "las_read_vlr_payload": ([ctypes.c_char_p, I, ctypes.c_char_p, LL],
                                 LL),
        "las_read_points_chunk": ([ctypes.c_char_p, U64, U64] + [P] * 12
                                  + [I], LL),
        "las_write_points_v2": ([ctypes.c_char_p, LL, I] + [P] * 12
                                + [I, I] + [P] * 7, I),
        "las_writer_open": ([ctypes.c_char_p, I, I, I] + [P] * 7 + [I], P),
        "las_writer_append": ([P, LL] + [P] * 12, LL),
        "las_writer_close": ([P], I),
        "las_writer_abort": ([P], None),
        "las_read_points": ([ctypes.c_char_p] + [P] * 5, LL),
        "las_write_points": ([ctypes.c_char_p, P, LL] + [P] * 4 + [I], I),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, res
    return lib


@functools.cache
def lzf_library() -> ctypes.CDLL:
    """The LZF codec (`lzf_codec.cpp`) of PCD ``binary_compressed``."""
    lib = ctypes.CDLL(str(build("lzf_codec")))
    for fn in (lib.lzf_decompress, lib.lzf_compress):
        fn.argtypes = [ctypes.c_char_p, ctypes.c_long,
                       ctypes.c_char_p, ctypes.c_long]
        fn.restype = ctypes.c_long
    return lib


def lzf_decompress(data: bytes, out_size: int) -> bytes:
    """Decode an LZF stream of ``out_size`` bytes; raises on a bad one."""
    out = ctypes.create_string_buffer(out_size)
    n = lzf_library().lzf_decompress(data, len(data), out, out_size)
    if n < 0:
        raise IOError("malformed LZF stream")
    return out.raw[:n]


def lzf_compress(data: bytes) -> bytes:
    """LZF-encode ``data`` (the JAX package's codec: the same bytes)."""
    cap = len(data) + len(data) // 16 + 64
    out = ctypes.create_string_buffer(cap)
    n = lzf_library().lzf_compress(data, len(data), out, cap)
    if n < 0:
        raise IOError("LZF compression overflow")
    return out.raw[:n]
