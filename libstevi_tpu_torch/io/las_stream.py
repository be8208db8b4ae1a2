"""LAS header / VLR / chunked point access — the streaming access layer,
a copy of `libstevi_tpu/io/las_stream.py` on the port's own codec.

Reference parity: `io/las_pointcloud_io.h` — the header interface
(`:26-197`), VLR/EVLR records (`:199-330`), extra-bytes descriptors
(`:332-487`) and the point/full access interfaces of `io/pointcloud_io.h`
(`:322,353,486`), which let a reader stream a cloud larger than RAM.
Re-designed: instead of per-point virtual accessors, `LasReader` exposes
*chunked SOA reads* — `read_chunk(start, count)` returns a dict of numpy
arrays — which is both the natural vectorized shape for numpy/torch and the
unit a distributed loader shards over hosts.

The byte-level codec is native C++ (`native/las_codec.cpp`, ctypes); this
module owns format *metadata*: bit-field splitting, extra-bytes descriptor
parsing (LASF_Spec record 4) and attribute packing for the writer.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np

# extra-bytes data_type codes 1-10 (LAS 1.4 spec table 24)
_EB_TYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
             5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
             9: np.float32, 10: np.float64}
_EB_CODES = {np.dtype(v): k for k, v in _EB_TYPES.items()}

_LEGACY_GPS = (1, 3, 4, 5)
_RGB_FMTS = (2, 3, 5, 7, 8, 10)
_NIR_FMTS = (8, 10)
_WAVE_FMTS = (4, 5, 9, 10)


@dataclass
class Vlr:
    """One (extended) variable-length record (`las_pointcloud_io.h:199`)."""
    user_id: str
    record_id: int
    payload: bytes
    description: str = ""
    is_evlr: bool = False


@dataclass
class ExtraBytesDescriptor:
    """One 192-byte LASF_Spec record-4 entry (`las_pointcloud_io.h:332`)."""
    name: str
    data_type: int                     # 0 = raw bytes (size in `options`)
    options: int = 0
    scale: float | None = None
    offset: float | None = None
    no_data: float | None = None
    description: str = ""

    @property
    def nbytes(self) -> int:
        if self.data_type == 0:
            return self.options
        return np.dtype(_EB_TYPES[self.data_type]).itemsize

    @property
    def dtype(self):
        return None if self.data_type == 0 else _EB_TYPES[self.data_type]

    @staticmethod
    def _anchor(data_type):
        """The 8-byte anchor dtype for no_data/min/max per LAS 1.4
        table 24: the value is stored in the descriptor's own type
        FAMILY — int64 for signed codes, uint64 unsigned, float64
        floating (a uint64 anchor corrupts e.g. no_data = -1)."""
        if data_type in (9, 10, 0):
            return np.float64
        if data_type in (2, 4, 6, 8):
            return np.int64
        return np.uint64

    def pack(self) -> bytes:
        buf = bytearray(192)
        buf[2] = self.data_type
        options = self.options
        if self.data_type != 0:
            options = 0
            if self.no_data is not None:
                options |= 0x01
            if self.scale is not None:
                options |= 0x08
            if self.offset is not None:
                options |= 0x10
        buf[3] = options
        # encode FIRST, then bound by BYTE length: a char-count slice
        # resizes the bytearray on multi-byte encodings and corrupts
        # every descriptor after this one
        nb = self.name.encode()[:32]
        buf[4:4 + len(nb)] = nb
        anchor = self._anchor(self.data_type)
        if self.no_data is not None:
            buf[40:48] = np.array([self.no_data], anchor).tobytes()
        if self.scale is not None:
            buf[112:120] = np.array([self.scale], np.float64).tobytes()
        if self.offset is not None:
            buf[136:144] = np.array([self.offset], np.float64).tobytes()
        db = self.description.encode()[:32]
        buf[160:160 + len(db)] = db
        return bytes(buf)

    @classmethod
    def unpack(cls, raw: bytes) -> "ExtraBytesDescriptor":
        data_type = raw[2]
        options = raw[3]
        name = raw[4:36].split(b"\0")[0].decode("ascii", "replace")
        desc = raw[160:192].split(b"\0")[0].decode("ascii", "replace")
        scale = off = nd = None
        if data_type != 0:
            anchor = cls._anchor(data_type)
            if options & 0x01:
                nd = float(np.frombuffer(raw[40:48], anchor)[0])
            if options & 0x08:
                scale = float(np.frombuffer(raw[112:120], np.float64)[0])
            if options & 0x10:
                off = float(np.frombuffer(raw[136:144], np.float64)[0])
        return cls(name, data_type, options, scale, off, nd, desc)


def parse_extra_bytes_vlr(payload: bytes) -> list[ExtraBytesDescriptor]:
    return [ExtraBytesDescriptor.unpack(payload[k:k + 192])
            for k in range(0, len(payload) - 191, 192)]


@dataclass
class LasHeader:
    version: tuple
    point_format: int
    point_record_len: int
    n_points: int
    scale: np.ndarray
    offset: np.ndarray
    mins: np.ndarray
    maxs: np.ndarray
    extra_bytes: int
    file_source_id: int = 0
    global_encoding: int = 0
    vlrs: list = field(default_factory=list)


def _lib():
    from ..native import las_library
    return las_library()


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


class LasReader:
    """Streaming LAS access: header + VLRs eagerly, points on demand in
    (start, count) chunks — `FullPointCloudAccessInterface` re-designed
    for SOA numpy access (`pointcloud_io.h:486-525`)."""

    #: standard attributes always present
    BASE_ATTRS = ("intensity", "return_number", "number_of_returns",
                  "scan_direction", "edge_of_flight_line", "classification",
                  "scan_angle", "user_data", "point_source_id")

    def __init__(self, path: str):
        from ..native import LasInfo
        self.path = path
        lib = _lib()
        info = LasInfo()
        rc = lib.las_read_info(path.encode(), ctypes.byref(info))
        if rc != 0:
            raise IOError(f"not a LAS file ({rc}): {path}")
        self._info = info
        vlrs = []
        from ..native import LasVlrMeta
        for i in range(info.n_vlrs + info.n_evlrs):
            meta = LasVlrMeta()
            if lib.las_read_vlr_meta(path.encode(), i,
                                     ctypes.byref(meta)) != 0:
                continue
            buf = ctypes.create_string_buffer(int(meta.payload_len))
            got = lib.las_read_vlr_payload(path.encode(), i, buf,
                                           int(meta.payload_len))
            vlrs.append(Vlr(meta.user_id.decode("ascii", "replace"),
                            meta.record_id, buf.raw[:max(got, 0)],
                            meta.description.decode("ascii", "replace"),
                            is_evlr=i >= info.n_vlrs))
        self.header = LasHeader(
            (info.version_major, info.version_minor), info.point_format,
            info.point_record_len, info.n_points,
            np.array(info.scale), np.array(info.offset),
            np.array(info.mins), np.array(info.maxs), info.extra_bytes,
            info.file_source_id, info.global_encoding, vlrs)
        self.extra_descriptors = []
        for v in vlrs:
            if v.user_id.startswith("LASF_Spec") and v.record_id == 4:
                self.extra_descriptors = parse_extra_bytes_vlr(v.payload)
        # descriptors describing more bytes than the record holds: ignore
        if sum(d.nbytes for d in self.extra_descriptors) > info.extra_bytes:
            self.extra_descriptors = []

    @property
    def n_points(self) -> int:
        return self.header.n_points

    @property
    def attributes(self) -> list:
        pf = self.header.point_format
        names = list(self.BASE_ATTRS)
        if pf >= 6:
            names += ["synthetic", "keypoint", "withheld", "overlap",
                      "scanner_channel"]
        else:
            names += ["synthetic", "keypoint", "withheld"]
        if pf in _LEGACY_GPS or pf >= 6:
            names.append("gps_time")
        if pf in _RGB_FMTS:
            names.append("rgb")
        if pf in _NIR_FMTS:
            names.append("nir")
        if pf in _WAVE_FMTS:
            names.append("wave_packet")
        if self.extra_descriptors:
            names += [d.name for d in self.extra_descriptors]
        elif self.header.extra_bytes:
            names.append("extra_bytes")
        return names

    def read_chunk(self, start: int, count: int) -> dict:
        """Decode points [start, start+count) into {name: array};
        positions under key 'xyz' (count, 3) float64."""
        info = self._info
        pf = self.header.point_format
        count = max(0, min(count, self.n_points - start))
        n = count
        xyz = np.empty((n, 3), np.float64)
        intensity = np.empty(n, np.uint16)
        ret_info = np.empty(n, np.uint16)
        classification = np.empty(n, np.uint8)
        scan_angle = np.empty(n, np.int16)
        user_data = np.empty(n, np.uint8)
        psid = np.empty(n, np.uint16)
        gps = np.empty(n, np.float64) if (pf in _LEGACY_GPS or pf >= 6) \
            else None
        rgb = np.empty((n, 3), np.uint16) if pf in _RGB_FMTS else None
        nir = np.empty(n, np.uint16) if pf in _NIR_FMTS else None
        wave = np.empty((n, 29), np.uint8) if pf in _WAVE_FMTS else None
        eb = self.header.extra_bytes
        extra = np.empty((n, eb), np.uint8) if eb else None

        got = _lib().las_read_points_chunk(
            self.path.encode(), start, count, _ptr(xyz), _ptr(intensity),
            _ptr(ret_info), _ptr(classification), _ptr(scan_angle),
            _ptr(user_data), _ptr(psid), _ptr(gps), _ptr(rgb), _ptr(nir),
            _ptr(wave), _ptr(extra), eb)
        if got < 0:
            raise IOError(f"LAS chunk read failed ({got}): {self.path}")
        got = int(got)

        out = {"xyz": xyz[:got], "intensity": intensity[:got],
               "scan_angle": scan_angle[:got], "user_data": user_data[:got],
               "point_source_id": psid[:got]}
        ri = ret_info[:got]
        cls = classification[:got]
        if pf >= 6:
            out["return_number"] = (ri & 0xF).astype(np.uint8)
            out["number_of_returns"] = ((ri >> 4) & 0xF).astype(np.uint8)
            out["synthetic"] = ((ri >> 8) & 1).astype(bool)
            out["keypoint"] = ((ri >> 9) & 1).astype(bool)
            out["withheld"] = ((ri >> 10) & 1).astype(bool)
            out["overlap"] = ((ri >> 11) & 1).astype(bool)
            out["scanner_channel"] = ((ri >> 12) & 3).astype(np.uint8)
            out["scan_direction"] = ((ri >> 14) & 1).astype(np.uint8)
            out["edge_of_flight_line"] = ((ri >> 15) & 1).astype(np.uint8)
            out["classification"] = cls
        else:
            out["return_number"] = (ri & 0x7).astype(np.uint8)
            out["number_of_returns"] = ((ri >> 3) & 0x7).astype(np.uint8)
            out["scan_direction"] = ((ri >> 6) & 1).astype(np.uint8)
            out["edge_of_flight_line"] = ((ri >> 7) & 1).astype(np.uint8)
            out["classification"] = cls & 0x1F
            out["synthetic"] = (cls >> 5 & 1).astype(bool)
            out["keypoint"] = (cls >> 6 & 1).astype(bool)
            out["withheld"] = (cls >> 7 & 1).astype(bool)
        if gps is not None:
            out["gps_time"] = gps[:got]
        if rgb is not None:
            out["rgb"] = rgb[:got]
        if nir is not None:
            out["nir"] = nir[:got]
        if wave is not None:
            out["wave_packet"] = wave[:got]
        if extra is not None:
            ex = extra[:got]
            if self.extra_descriptors:
                off = 0
                for d in self.extra_descriptors:
                    nb = d.nbytes
                    chunk = ex[:, off:off + nb]
                    if d.dtype is None:
                        out[d.name] = chunk.copy()
                    else:
                        vals = np.ascontiguousarray(chunk).view(
                            d.dtype).reshape(-1)
                        if d.scale is not None or d.offset is not None:
                            vals = vals * (d.scale or 1.0) + (d.offset or 0.0)
                        out[d.name] = vals
                    off += nb
            else:
                out["extra_bytes"] = ex.copy()
        return out

    def chunks(self, size: int = 1 << 20):
        """Iterate the whole cloud in fixed-size chunks (streaming)."""
        for start in range(0, self.n_points, size):
            yield self.read_chunk(start, size)


def _pack_ret_info(n, pf, attrs) -> np.ndarray | None:
    """Inverse of the bit splits in `LasReader.read_chunk`."""
    def get(name, default=None):
        v = attrs.get(name)
        return None if v is None else np.asarray(v)
    rn = get("return_number")
    nr = get("number_of_returns")
    sd = get("scan_direction")
    ed = get("edge_of_flight_line")
    if pf >= 6:
        extra_bits = [get("synthetic"), get("keypoint"), get("withheld"),
                      get("overlap"), get("scanner_channel")]
    else:
        extra_bits = []
    if all(v is None for v in [rn, nr, sd, ed] + extra_bits):
        return None
    ri = np.zeros(n, np.uint16)
    if pf >= 6:
        ri |= (np.uint16(1) if rn is None else rn.astype(np.uint16) & 0xF)
        ri |= ((np.uint16(1) if nr is None
                else nr.astype(np.uint16) & 0xF) << 4)
        for bit, name in zip((8, 9, 10, 11),
                             ("synthetic", "keypoint", "withheld",
                              "overlap")):
            v = get(name)
            if v is not None:
                ri |= (v.astype(np.uint16) & 1) << bit
        v = get("scanner_channel")
        if v is not None:
            ri |= (v.astype(np.uint16) & 3) << 12
        if sd is not None:
            ri |= (sd.astype(np.uint16) & 1) << 14
        if ed is not None:
            ri |= (ed.astype(np.uint16) & 1) << 15
    else:
        ri |= (np.uint16(1) if rn is None else rn.astype(np.uint16) & 0x7)
        ri |= ((np.uint16(1) if nr is None
                else nr.astype(np.uint16) & 0x7) << 3)
        if sd is not None:
            ri |= (sd.astype(np.uint16) & 1) << 6
        if ed is not None:
            ri |= (ed.astype(np.uint16) & 1) << 7
    return ri


def _pack_classification(pf, attrs, n) -> np.ndarray | None:
    cls = attrs.get("classification")
    if pf >= 6:
        return None if cls is None else np.asarray(cls, np.uint8)
    bits = [attrs.get(k) for k in ("synthetic", "keypoint", "withheld")]
    if cls is None and all(b is None for b in bits):
        return None
    out = np.zeros(n, np.uint8) if cls is None \
        else (np.asarray(cls, np.uint8) & 0x1F)
    for bit, v in zip((5, 6, 7), bits):
        if v is not None:
            out |= (np.asarray(v).astype(np.uint8) & 1) << bit
    return out


_STD_ATTRS = {"intensity", "return_number", "number_of_returns",
              "scan_direction", "edge_of_flight_line", "classification",
              "synthetic", "keypoint", "withheld", "overlap",
              "scanner_channel", "scan_angle", "user_data",
              "point_source_id", "gps_time", "rgb", "nir", "wave_packet",
              "extra_bytes"}


class LasChunkWriter:
    """Bounded-memory chunk-streaming LAS writer (`native/las_codec.cpp`
    `las_writer_open/append/close`): the header is backpatched with the
    final point count / bounds / offset at close, so clouds larger than
    RAM stream to disk through fixed-size SOA chunks — the write-side
    complement of `LasReader`.  The point format and extra-bytes
    descriptors are fixed from the FIRST chunk's attribute names/dtypes
    (same inference as `write_las_v2`); later chunks must carry the same
    attributes.  The coordinate offset comes from the first chunk's
    minima; at the default 1e-4 scale, later chunks must stay within
    ~200 km of it (int32 quantization range)."""

    def __init__(self, path: str, point_format: int | None = None,
                 vlrs: list | None = None,
                 extra_descriptors: list | None = None,
                 scale=None, force_v14: bool = False):
        self._path = path
        self._pf = point_format
        self._vlrs = list(vlrs or [])
        self._descriptors = extra_descriptors
        self._scale = scale
        self._force_v14 = force_v14
        self._handle = None
        self._eb = 0
        self.n_written = 0

    # -- format / descriptor inference (first chunk) -----------------------

    def _open(self, attrs: dict):
        from ..native import las_library
        if self._pf is None:
            has_gps = "gps_time" in attrs
            has_rgb = "rgb" in attrs
            has_nir = "nir" in attrs
            has_wave = "wave_packet" in attrs
            if has_nir:
                self._pf = 10 if has_wave else 8
            elif has_wave:
                self._pf = 9 if has_gps or not has_rgb else 5
            else:
                self._pf = {(False, False): 0, (True, False): 1,
                            (False, True): 2, (True, True): 3}[
                    (has_gps, has_rgb)]
        # an attribute the chosen format cannot hold would be SILENTLY
        # dropped by the record packer — refuse instead
        for name, fmts in (("rgb", _RGB_FMTS), ("nir", _NIR_FMTS),
                           ("wave_packet", _WAVE_FMTS)):
            if name in attrs and self._pf not in fmts:
                raise ValueError(
                    f"point format {self._pf} cannot store {name!r}; "
                    f"pass point_format from {fmts}")
        custom = {k: np.asarray(v) for k, v in attrs.items()
                  if k not in _STD_ATTRS}
        vlrs = list(self._vlrs)
        if self._descriptors is None:
            self._descriptors = []
            for name, v in custom.items():
                if v.dtype == bool:
                    v = v.astype(np.uint8)
                code = _EB_CODES.get(np.dtype(v.dtype))
                if code is None:
                    raise ValueError(f"cannot encode attribute {name!r} "
                                     f"dtype {v.dtype} as LAS extra bytes")
                self._descriptors.append(ExtraBytesDescriptor(name, code))
        if self._descriptors:
            self._eb = sum(d.nbytes for d in self._descriptors)
            vlrs.append(Vlr("LASF_Spec", 4,
                            b"".join(d.pack() for d in self._descriptors),
                            "extra bytes"))
        elif "extra_bytes" in attrs:
            self._eb = np.ascontiguousarray(attrs["extra_bytes"],
                                            np.uint8).shape[1]

        # the header-VLR length field is u16: silently truncating it
        # corrupts every record after the payload — promote to an EVLR
        # (forces a 1.4 header, which the native layer derives from isev)
        vlrs = [Vlr(v.user_id, v.record_id, v.payload, v.description,
                    is_evlr=True)
                if not v.is_evlr and len(v.payload) > 0xFFFF else v
                for v in vlrs]

        n_vlr = len(vlrs)
        if n_vlr:
            uid = np.zeros((n_vlr, 16), np.uint8)
            rid = np.zeros(n_vlr, np.uint16)
            desc = np.zeros((n_vlr, 32), np.uint8)
            plens = np.zeros(n_vlr, np.uint64)
            isev = np.zeros(n_vlr, np.uint8)
            payload = b"".join(v.payload for v in vlrs)
            for i, v in enumerate(vlrs):
                u = v.user_id.encode()[:16]
                uid[i, :len(u)] = np.frombuffer(u, np.uint8)
                d = v.description.encode()[:32]
                desc[i, :len(d)] = np.frombuffer(d, np.uint8)
                rid[i] = v.record_id
                plens[i] = len(v.payload)
                isev[i] = 1 if v.is_evlr else 0
            payload_arr = np.frombuffer(payload, np.uint8).copy() \
                if payload else np.zeros(0, np.uint8)
        else:
            uid = rid = desc = plens = isev = payload_arr = None
        scale_arr = None if self._scale is None \
            else np.ascontiguousarray(self._scale, np.float64)
        self._handle = las_library().las_writer_open(
            self._path.encode(), self._pf, self._eb, n_vlr,
            _ptr(uid), _ptr(rid), _ptr(desc), _ptr(plens),
            _ptr(payload_arr), _ptr(isev), _ptr(scale_arr),
            1 if self._force_v14 else 0)
        if not self._handle:
            raise IOError(f"LAS writer open failed: {self._path}")

    # -- per-chunk packing ---------------------------------------------------

    def _pack_extra(self, attrs: dict, n: int) -> np.ndarray | None:
        if self._descriptors:
            extra = np.zeros((n, self._eb), np.uint8)
            off = 0
            for d in self._descriptors:
                v = attrs.get(d.name)
                if v is None:
                    raise ValueError(f"chunk lacks attribute {d.name!r}")
                v = np.asarray(v)
                if v.dtype == bool:
                    v = v.astype(np.uint8)
                # invert the descriptor's value-space transform: the
                # reader returns raw*scale+offset, so a read->write copy
                # must store (v-offset)/scale back as raw counts
                if d.scale is not None or d.offset is not None:
                    v = (v.astype(np.float64) - (d.offset or 0.0)) \
                        / (d.scale if d.scale is not None else 1.0)
                    v = np.round(v) if d.dtype is not None \
                        and np.dtype(d.dtype).kind in "iu" else v
                raw = np.ascontiguousarray(
                    v.astype(d.dtype) if d.dtype is not None else v)
                extra[:, off:off + d.nbytes] = \
                    raw.view(np.uint8).reshape(n, d.nbytes)
                off += d.nbytes
            return extra
        if "extra_bytes" in attrs:
            return np.ascontiguousarray(attrs["extra_bytes"], np.uint8)
        return None

    def write_chunk(self, xyz: np.ndarray,
                    attributes: dict | None = None) -> int:
        from ..native import las_library
        attrs = dict(attributes or {})
        xyz = np.ascontiguousarray(xyz, np.float64)
        n = len(xyz)
        if self._handle is None:
            self._open(attrs)
        pf = self._pf
        ri = _pack_ret_info(n, pf, attrs)
        cls = _pack_classification(pf, attrs, n)

        def prep(name, dt):
            v = attrs.get(name)
            return None if v is None else np.ascontiguousarray(v, dt)

        extra = self._pack_extra(attrs, n)
        got = las_library().las_writer_append(
            self._handle, n, _ptr(xyz), _ptr(prep("intensity", np.uint16)),
            _ptr(ri), _ptr(cls), _ptr(prep("scan_angle", np.int16)),
            _ptr(prep("user_data", np.uint8)),
            _ptr(prep("point_source_id", np.uint16)),
            _ptr(prep("gps_time", np.float64)),
            _ptr(prep("rgb", np.uint16)), _ptr(prep("nir", np.uint16)),
            _ptr(prep("wave_packet", np.uint8)), _ptr(extra))
        if got < 0:
            raise IOError(f"LAS chunk append failed ({got}): {self._path}")
        self.n_written += int(got)
        return int(got)

    def close(self):
        from ..native import las_library
        if self._handle is None:
            # zero chunks written: emit a valid empty cloud
            self._open({})
        h, self._handle = self._handle, None
        rc = las_library().las_writer_close(h)
        if rc != 0:
            raise IOError(f"LAS writer close failed ({rc}): {self._path}")

    def abort(self):
        from ..native import las_library
        if self._handle is not None:
            h, self._handle = self._handle, None
            las_library().las_writer_abort(h)

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is None:
            self.close()
        else:
            self.abort()
        return False


def write_las_v2(path: str, xyz: np.ndarray, attributes: dict | None = None,
                 point_format: int | None = None,
                 vlrs: list | None = None,
                 extra_descriptors: list | None = None,
                 scale=None) -> bool:
    """Write any point format 0-10.  Attributes not in the standard set
    are packed as extra bytes with an auto-generated LASF_Spec record-4
    descriptor VLR, so arbitrary per-point attributes round-trip.
    One open -> append -> close cycle of `LasChunkWriter`."""
    xyz = np.ascontiguousarray(xyz, np.float64)
    w = LasChunkWriter(path, point_format=point_format, vlrs=vlrs,
                       extra_descriptors=extra_descriptors, scale=scale,
                       force_v14=len(xyz) > 0xFFFFFFFF)
    try:
        w.write_chunk(xyz, attributes)
    except Exception:
        w.abort()
        raise
    w.close()
    return True
