"""Riegl SDC point-cloud codec, a copy of `libstevi_tpu/io/sdc_io.py`.

Reference parity: `io/sdc_pointcloud_io.{h,cpp}` — header = uint32
headerSize + uint16 major/minor version + free-form header bytes; records
are packed little-endian with the version-dependent field set
(`sdc_pointcloud_io.h:22-90`): time f64, range/theta f32, x/y/z f32,
amplitude/width u16, targettype/target/numtarget u8, rgindex u16,
channeldesc u8, then classid u8 (>=5.2), rho f32 (>=5.3), reflectance i16
(>=5.4).
"""

from __future__ import annotations

import struct

import numpy as np

from .pointcloud_io import PointCloud

_FIELDS = [
    ("time", "<f8"), ("range", "<f4"), ("theta", "<f4"),
    ("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
    ("amplitude", "<u2"), ("width", "<u2"), ("targettype", "u1"),
    ("target", "u1"), ("numtarget", "u1"), ("rgindex", "<u2"),
    ("channeldesc", "u1"),
    ("classid", "u1"),        # >= 5.2
    ("rho", "<f4"),           # >= 5.3
    ("reflectance", "<i2"),   # >= 5.4
]


def _n_fields(major: int, minor: int) -> int:
    if major >= 5:
        if minor >= 4:
            return 16
        if minor >= 3:
            return 15
        if minor >= 2:
            return 14
    return 13


def _record_dtype(major: int, minor: int) -> np.dtype:
    return np.dtype(_FIELDS[:_n_fields(major, minor)])


def read_sdc(path: str) -> PointCloud:
    with open(path, "rb") as f:
        header_size, = struct.unpack("<I", f.read(4))
        major, minor = struct.unpack("<HH", f.read(4))
        f.seek(header_size)
        rec = _record_dtype(major, minor)
        data = np.frombuffer(f.read(), rec)
    xyz = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float64)
    attrs = {name: np.array(data[name]) for name, _ in
             _FIELDS[:_n_fields(major, minor)]
             if name not in ("x", "y", "z")}
    return PointCloud(xyz, attrs)


def write_sdc(path: str, cloud: PointCloud, major: int = 5,
              minor: int = 4) -> bool:
    rec = _record_dtype(major, minor)
    n = cloud.n_points
    out = np.zeros(n, rec)
    out["x"] = cloud.positions[:, 0]
    out["y"] = cloud.positions[:, 1]
    out["z"] = cloud.positions[:, 2]
    for name, _ in _FIELDS[:_n_fields(major, minor)]:
        if name in ("x", "y", "z"):
            continue
        if name in cloud.attributes:
            out[name] = cloud.attributes[name]
    with open(path, "wb") as f:
        f.write(struct.pack("<I", 8))
        f.write(struct.pack("<HH", major, minor))
        f.write(out.tobytes())
    return True
