"""Point-cloud abstraction and codecs, a copy of
`libstevi_tpu/io/pointcloud_io.py`: positions and attributes stay numpy
arrays on the host (file IO is host work in both packages), and the LAS and
LZF codecs are the port's own builds (`native/`).

Reference parity: `io/pointcloud_io.{h,cpp}` — the generic attribute /
access interfaces (`pointcloud_io.h:64-553`) collapse to a `PointCloud`
dataclass (positions + named attribute arrays); `openPointCloud`
(`pointcloud_io.h:815`) sniffs the format by extension.  Codecs:
  * LAS (`las_pointcloud_io.{h,cpp}`): native C++ codec
    (`native/las_codec.cpp`, ctypes-bound) covering LAS 1.0-1.4, ALL
    point formats 0-10, VLR/EVLR records and extra-bytes attributes;
    streaming chunked access via `las_stream.LasReader`;
  * PCD (`pcd_pointcloud_io.{h,cpp}`): ascii + binary readers/writers;
  * attribute mapper/remover (`attributeMapper.h`, `attributeRemover.h`):
    `rename_attributes` / `drop_attributes`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np


@dataclass
class PointCloud:
    """positions (N, 3) float64 + named per-point attribute arrays."""

    positions: np.ndarray
    attributes: dict = field(default_factory=dict)

    @property
    def n_points(self) -> int:
        return len(self.positions)

    def rename_attributes(self, mapping: dict) -> "PointCloud":
        """`attributeMapper.h:11-86`."""
        attrs = {mapping.get(k, k): v for k, v in self.attributes.items()}
        return PointCloud(self.positions, attrs)

    def drop_attributes(self, names) -> "PointCloud":
        """`attributeRemover.h:13-181`."""
        attrs = {k: v for k, v in self.attributes.items() if k not in names}
        return PointCloud(self.positions, attrs)


# ---------------------------------------------------------------------------
# LAS (native codec)
# ---------------------------------------------------------------------------

def read_las(path: str) -> PointCloud:
    """Full in-memory read via the streaming layer (`io/las_stream.py`):
    all point formats 0-10, bit-fields split into attributes, extra-bytes
    decoded per LASF_Spec descriptors."""
    from .las_stream import LasReader
    r = LasReader(path)
    ch = r.read_chunk(0, r.n_points)
    xyz = ch.pop("xyz")
    return PointCloud(xyz, ch)


def write_las(path: str, cloud: PointCloud, point_format: int | None = None,
              **kw) -> bool:
    """Write any point format 0-10; non-standard attributes become
    extra-bytes with auto-generated descriptors (`io/las_stream.py`)."""
    from .las_stream import write_las_v2
    return write_las_v2(path, np.ascontiguousarray(cloud.positions,
                                                   np.float64),
                        cloud.attributes, point_format=point_format, **kw)


# ---------------------------------------------------------------------------
# PCD
# ---------------------------------------------------------------------------

_PCD_TYPES = {("F", 4): np.float32, ("F", 8): np.float64,
              ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
              ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32}


def read_pcd(path: str) -> PointCloud:
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_points = 0
        data_mode = "ascii"
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("#") or not line:
                continue
            key, _, rest = line.partition(" ")
            key = key.upper()
            if key == "FIELDS":
                fields = rest.split()
            elif key == "SIZE":
                sizes = [int(v) for v in rest.split()]
            elif key == "TYPE":
                types = rest.split()
            elif key == "COUNT":
                counts = [int(v) for v in rest.split()]
            elif key == "POINTS":
                n_points = int(rest)
            elif key == "DATA":
                data_mode = rest.strip()
                break
        if not counts:
            counts = [1] * len(fields)
        dtypes = [_PCD_TYPES[(t, s)] for t, s in zip(types, sizes)]

        if data_mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, ndmin=2)
            cols = {}
            c = 0
            for name, cnt in zip(fields, counts):
                cols[name] = raw[:, c:c + cnt].squeeze(-1) if cnt == 1 \
                    else raw[:, c:c + cnt]
                c += cnt
        elif data_mode == "binary":
            rec = np.dtype([(name, dt, (cnt,)) if cnt > 1 else (name, dt)
                            for name, dt, cnt in zip(fields, dtypes, counts)])
            arr = np.frombuffer(f.read(rec.itemsize * n_points), rec,
                                n_points)
            cols = {name: np.array(arr[name]) for name in fields}
        elif data_mode == "binary_compressed":
            # u32 compressed size, u32 uncompressed size, LZF payload; the
            # uncompressed data is field-major (SOA).  The reference stubs
            # this mode out (`gotoNextBinaryCompressed`,
            # `pcd_pointcloud_io.cpp:516` returns false); we decode it.
            from ..native import lzf_decompress
            csz, usz = np.frombuffer(f.read(8), np.uint32, 2)
            raw = lzf_decompress(f.read(int(csz)), int(usz))
            cols = {}
            off = 0
            for name, dt, cnt in zip(fields, dtypes, counts):
                nb = np.dtype(dt).itemsize * cnt * n_points
                block = np.frombuffer(raw[off:off + nb], dt)
                cols[name] = (block if cnt == 1
                              else block.reshape(n_points, cnt))
                off += nb
        else:
            raise IOError(f"unsupported PCD data mode {data_mode!r}")

    xyz = np.stack([cols.pop("x"), cols.pop("y"), cols.pop("z")],
                   -1).astype(np.float64)
    return PointCloud(xyz, cols)


def write_pcd(path: str, cloud: PointCloud, binary: bool = True,
              compressed: bool = False) -> bool:
    xyz = np.asarray(cloud.positions, np.float32)
    fields = ["x", "y", "z"] + list(cloud.attributes)
    arrays = [xyz[:, 0], xyz[:, 1], xyz[:, 2]] \
        + [np.asarray(v) for v in cloud.attributes.values()]
    type_char = []
    sizes = []
    for a in arrays:
        if a.dtype.kind == "f":
            type_char.append("F")
        elif a.dtype.kind == "i":
            type_char.append("I")
        else:
            type_char.append("U")
        sizes.append(a.dtype.itemsize)
    n = len(xyz)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(fields)}\n"
        f"SIZE {' '.join(str(s) for s in sizes)}\n"
        f"TYPE {' '.join(type_char)}\n"
        f"COUNT {' '.join('1' for _ in fields)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary_compressed' if compressed else 'binary' if binary else 'ascii'}\n")
    with open(path, "wb") as f:
        f.write(header.encode())
        if compressed:
            from ..native import lzf_compress
            raw = b"".join(np.ascontiguousarray(a).tobytes()
                           for a in arrays)          # field-major (SOA)
            payload = lzf_compress(raw)
            f.write(np.asarray([len(payload), len(raw)],
                               np.uint32).tobytes())
            f.write(payload)
        elif binary:
            rec = np.dtype([(name, a.dtype) for name, a in
                            zip(fields, arrays)])
            out = np.empty(n, rec)
            for name, a in zip(fields, arrays):
                out[name] = a
            f.write(out.tobytes())
        else:
            cols = np.column_stack([a.astype(np.float64) for a in arrays])
            np.savetxt(f, cols, fmt="%.8g")
    return True


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

class InMemoryStream:
    """Chunked access adapter over an in-memory PointCloud — gives PCD /
    SDC / MetaCloud the same streaming interface as `las_stream.LasReader`
    (the `FullPointCloudAccessInterface` role, `pointcloud_io.h:486`)."""

    def __init__(self, cloud: PointCloud):
        self._cloud = cloud

    @property
    def n_points(self) -> int:
        return self._cloud.n_points

    @property
    def attributes(self) -> list:
        return list(self._cloud.attributes)

    def read_chunk(self, start: int, count: int) -> dict:
        sl = slice(start, min(start + count, self.n_points))
        out = {"xyz": self._cloud.positions[sl]}
        for k, v in self._cloud.attributes.items():
            out[k] = np.asarray(v)[sl]
        return out

    def chunks(self, size: int = 1 << 20):
        for start in range(0, self.n_points, size):
            yield self.read_chunk(start, size)


def map_point_cloud_attributes(cloud: PointCloud, mapping: dict,
                               only_keep: bool = False) -> PointCloud:
    """`mapPointCloudAttributes` (`attributeMapper.h:181-213`,
    `examples/io_map/main.cpp:29`): rename attributes AND position
    components — the mapping's keys/values live in one namespace where
    ``x``/``y``/``z`` denote the geometry axes, so ``{"x": "y", "y":
    "x"}`` swaps the first two coordinate columns and ``{"z": "newZ"}``
    turns the height into a plain attribute (the vacated geometry axis
    reads as 0, like the reference's empty-optional fallback).
    ``only_keep`` drops attributes whose name is not a mapping key
    (geometry columns always resolve, by mapped name).

    Collision rules (lossless or loud): explicitly-mapped names own
    their target; a second explicit mapping to the same target, or an
    unmapped name whose own slot is claimed by a mapping, raises
    ``ValueError`` instead of silently dropping data — map the displaced
    name away (``{"intensity": "z", "z": "old_z"}``) or drop it first."""
    pos = np.asarray(cloud.positions, np.float64)
    names = {"x": pos[:, 0], "y": pos[:, 1], "z": pos[:, 2]}
    names.update(cloud.attributes)
    out = {}
    for k in names:                       # explicit mappings first
        if k in mapping:
            nk = mapping[k]
            if nk in out:
                raise ValueError(f"two attributes map to {nk!r}")
            out[nk] = names[k]
    for k, v in names.items():            # identity-kept names
        if k in mapping:
            continue
        if only_keep and k not in ("x", "y", "z"):
            continue
        if k in out:
            raise ValueError(
                f"mapping target {k!r} collides with the existing "
                f"attribute {k!r}; map it away or drop it first")
        out[k] = v
    zeros = np.zeros(cloud.n_points)
    new_pos = np.stack([np.asarray(out.pop(ax, zeros), np.float64)
                        for ax in ("x", "y", "z")], -1)
    return PointCloud(new_pos, out)


class AttributeMapperStream:
    """Chunk-streaming attribute mapper (`attributeMapper.h:39-114`,
    `PointCloudPointAttributeMapper`): wraps any point-cloud stream and
    applies `map_point_cloud_attributes` semantics per chunk, so a
    larger-than-RAM LAS can be re-labelled without materializing it."""

    def __init__(self, stream, mapping: dict, only_keep: bool = False):
        self._s = stream
        self._mapping = dict(mapping)
        self._only_keep = only_keep

    @property
    def n_points(self) -> int:
        return self._s.n_points

    @property
    def attributes(self) -> list:
        m, keep = self._mapping, self._only_keep
        src = list(getattr(self._s, "attributes"))
        out, seen = [], set()
        for k in src:
            if keep and k not in m:
                continue
            nk = m.get(k, k)
            if nk not in seen and nk not in ("x", "y", "z"):
                seen.add(nk)
                out.append(nk)
        for ax in ("x", "y", "z"):          # geometry mapped INTO attrs
            nk = m.get(ax, ax)
            if nk not in ("x", "y", "z") and nk not in seen:
                seen.add(nk)
                out.append(nk)
        return out

    def read_chunk(self, start: int, count: int) -> dict:
        ch = self._s.read_chunk(start, count)
        xyz = ch.pop("xyz")
        cloud = PointCloud(xyz, ch)
        mapped = map_point_cloud_attributes(cloud, self._mapping,
                                            self._only_keep)
        out = {"xyz": mapped.positions}
        out.update(mapped.attributes)
        return out

    def chunks(self, size: int = 1 << 20):
        for start in range(0, self.n_points, size):
            yield self.read_chunk(start, size)


def open_point_cloud_stream(path: str):
    """Format-sniffing *streaming* reader: LAS streams natively from disk
    (clouds larger than RAM iterate in bounded memory); other codecs load
    once and adapt.  Returns an object with ``n_points``, ``attributes``,
    ``read_chunk(start, count)`` and ``chunks(size)`` —
    the format-agnostic access-interface layer of `pointcloud_io.h:322-525`
    re-designed around chunked SOA numpy access."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".las":
        from .las_stream import LasReader
        return LasReader(path)
    return InMemoryStream(open_point_cloud(path))


def write_point_cloud_stream(path: str, stream,
                             chunk_size: int = 1 << 20) -> bool:
    """Stream a point-cloud source to disk in bounded memory.  LAS
    destinations use the native chunked writer (`las_stream.
    LasChunkWriter` — header backpatched at close), so a larger-than-RAM
    source streams end-to-end; other codecs materialize (their writers
    are single-shot) — documented trade-off, not silent."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".las":
        from .las_stream import LasChunkWriter
        with LasChunkWriter(path) as w:
            for ch in stream.chunks(chunk_size):
                xyz = ch.pop("xyz")
                w.write_chunk(xyz, ch)
        return True
    chunks = list(stream.chunks(chunk_size))
    cloud = PointCloud(
        np.concatenate([c["xyz"] for c in chunks]),
        {k: np.concatenate([c[k] for c in chunks])
         for k in chunks[0] if k != "xyz"})
    return save_point_cloud(path, cloud)


def open_point_cloud(path: str) -> PointCloud:
    """Format-sniffing reader (`openPointCloud`, `pointcloud_io.h:815`)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".las":
        return read_las(path)
    if ext == ".pcd":
        return read_pcd(path)
    if ext == ".sdc":
        from .sdc_io import read_sdc
        return read_sdc(path)
    if ext == ".metacloud":
        from .metacloud_io import read_metacloud
        return read_metacloud(path)
    raise IOError(f"unsupported point-cloud format: {ext}")


def save_point_cloud(path: str, cloud: PointCloud) -> bool:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".las":
        return write_las(path, cloud)
    if ext == ".pcd":
        return write_pcd(path, cloud)
    if ext == ".sdc":
        from .sdc_io import write_sdc
        return write_sdc(path, cloud)
    if ext == ".metacloud":
        from .metacloud_io import write_metacloud
        return write_metacloud(path, cloud)
    raise IOError(f"unsupported point-cloud format: {ext}")
