"""Minimal OpenEXR scanline reader/writer in numpy (no external
dependency), a copy of `libstevi_tpu/io/exr_io.py`.

Reference parity: `io/read_exr.h` — `isExrFile` (:24, magic sniff) and
`readExrChannel` (:31: open, find the channel in the header's channel list,
read the data window, return one (H, W) float plane).  The reference links
against OpenEXR; here the container is parsed directly: header attributes,
the channel list, the scanline offset table and per-block chunks, with
NONE / ZIPS / ZIP compression (zlib + OpenEXR's delta predictor and
two-half byte interleave) and UINT / HALF / FLOAT pixel types.  Tiled,
deep, and PIZ/RLE/B44 files raise IOError.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"

_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
_PIXEL_CODES = {np.dtype(np.uint32): 0, np.dtype(np.float16): 1,
                np.dtype(np.float32): 2}


def is_exr_file(path: str) -> bool:
    """Magic sniff (`read_exr.h:24-29`)."""
    try:
        with open(path, "rb") as f:
            return f.read(4) == _MAGIC
    except OSError:
        return False


def _read_cstr(f) -> bytes:
    out = bytearray()
    while True:
        c = f.read(1)
        if not c or c == b"\0":
            return bytes(out)
        out += c


def _parse_header(f):
    attrs = {}
    while True:
        name = _read_cstr(f)
        if name == b"":
            break
        typ = _read_cstr(f)
        size = struct.unpack("<i", f.read(4))[0]
        attrs[name.decode()] = (typ.decode(), f.read(size))
    return attrs


def _parse_chlist(data: bytes):
    """[(name, pixel_type, x_sampling, y_sampling)] in file (alphabetical)
    order — the order of planes inside each scanline block."""
    chans = []
    pos = 0
    while pos < len(data) and data[pos] != 0:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pt, _plin, xs, ys = struct.unpack_from("<iB3xii", data, end + 1)
        chans.append((name, pt, xs, ys))
        pos = end + 1 + 16
    return chans


def _unpredict_deinterleave(d: bytes) -> bytes:
    # delta decode t[i] = t[i-1] + d[i] - 128, then merge the two halves
    # back into even/odd byte positions (OpenEXR ZIP post-processing)
    b = np.frombuffer(d, np.uint8).astype(np.int64)
    b[1:] -= 128
    b = np.cumsum(b).astype(np.uint8)
    out = np.empty(len(d), np.uint8)
    half = (len(d) + 1) // 2
    out[0::2] = b[:half]
    out[1::2] = b[half:]
    return out.tobytes()


def _interleave_predict(d: bytes) -> bytes:
    a = np.frombuffer(d, np.uint8)
    half = (len(d) + 1) // 2
    split = np.concatenate([a[0::2], a[1::2]])
    s = split.astype(np.int64)
    delta = np.empty(len(d), np.int64)
    delta[0] = s[0]
    delta[1:] = s[1:] - s[:-1] + 128
    return delta.astype(np.uint8).tobytes()


def read_exr_header(path: str) -> dict:
    with open(path, "rb") as f:
        if f.read(4) != _MAGIC:
            raise IOError(f"not an EXR file: {path}")
        version = struct.unpack("<i", f.read(4))[0]
        if version & 0x200:
            raise IOError("tiled EXR files are not supported")
        if version & 0x800:
            raise IOError("deep EXR files are not supported")
        if version & 0x1000:
            raise IOError("multipart EXR files are not supported")
        attrs = _parse_header(f)
        data_start = f.tell()
    for req in ("channels", "dataWindow", "compression"):
        if req not in attrs:
            raise IOError(f"malformed EXR header (missing {req}): {path}")
    xmin, ymin, xmax, ymax = struct.unpack("<4i", attrs["dataWindow"][1])
    comp = attrs["compression"][1][0]
    return {"channels": _parse_chlist(attrs["channels"][1]),
            "window": (xmin, ymin, xmax, ymax),
            "compression": comp,
            "data_start": data_start,
            "attrs": attrs}


def exr_channels(path: str) -> list:
    """Channel names present in the file."""
    return [c[0] for c in read_exr_header(path)["channels"]]


def read_exr(path: str) -> dict:
    """All channels as (H, W) float32 planes (`readExrChannel`,
    `read_exr.h:31-130`, generalized to every channel in one pass)."""
    hdr = read_exr_header(path)
    xmin, ymin, xmax, ymax = hdr["window"]
    W = xmax - xmin + 1
    H = ymax - ymin + 1
    comp = hdr["compression"]
    if comp == 0:
        lines_per_block = 1
    elif comp == 2:        # ZIPS
        lines_per_block = 1
    elif comp == 3:        # ZIP
        lines_per_block = 16
    else:
        raise IOError(f"unsupported EXR compression {comp} "
                      "(NONE/ZIPS/ZIP only)")

    chans = hdr["channels"]
    for (name, _, xs, ys) in chans:
        if xs != 1 or ys != 1:
            raise IOError(f"subsampled EXR channel {name!r} "
                          f"(sampling {xs}x{ys}) is not supported")
    dts = [np.dtype(_PIXEL_DTYPES[pt]) for (_, pt, _, _) in chans]
    line_bytes = sum(dt.itemsize * W for dt in dts)
    n_blocks = -(-H // lines_per_block)

    planes = {name: np.empty((H, W), np.float32) for (name, _, _, _) in chans}
    with open(path, "rb") as f:
        f.seek(hdr["data_start"])
        offsets = np.frombuffer(f.read(8 * n_blocks), np.uint64)
        for off in offsets:
            f.seek(int(off))
            y, size = struct.unpack("<ii", f.read(8))
            data = f.read(size)
            y0 = y - ymin
            rows = min(lines_per_block, H - y0)
            want = line_bytes * rows
            if comp in (2, 3) and size != want:
                data = _unpredict_deinterleave(zlib.decompress(data))
            for r in range(rows):
                pos = r * line_bytes
                for (name, _, _, _), dt in zip(chans, dts):
                    nb = dt.itemsize * W
                    row = np.frombuffer(data[pos:pos + nb], dt)
                    planes[name][y0 + r] = row.astype(np.float32)
                    pos += nb
    return planes


def read_exr_channel(path: str, channel: str) -> np.ndarray:
    """One channel as an (H, W) float32 plane (`readExrChannel`,
    `read_exr.h:31`)."""
    planes = read_exr(path)
    if channel not in planes:
        raise KeyError(f"channel {channel!r} not in {sorted(planes)}")
    return planes[channel]


def write_exr(path: str, channels: dict, compression: str = "zip") -> bool:
    """Scanline EXR writer (float32 planes; 'none'|'zips'|'zip')."""
    comp = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_block = 16 if comp == 3 else 1
    names = sorted(channels)
    for n in names:
        if len(n.encode()) > 31:
            # the 0x400 long-names bit is not emitted; conforming
            # readers enforce the 31-byte limit without it
            raise ValueError(f"EXR channel name {n!r} exceeds 31 bytes")
    planes = {n: np.asarray(channels[n], np.float32) for n in names}
    H, W = next(iter(planes.values())).shape
    for n in names:
        if planes[n].shape != (H, W):
            raise ValueError("all channels must share one shape")

    chl = b""
    for n in names:
        chl += n.encode() + b"\0" + struct.pack("<i4xii", 2, 1, 1)
    chl += b"\0"

    def attr(name, typ, data):
        return (name.encode() + b"\0" + typ.encode() + b"\0"
                + struct.pack("<i", len(data)) + data)

    box = struct.pack("<4i", 0, 0, W - 1, H - 1)
    header = (attr("channels", "chlist", chl)
              + attr("compression", "compression", bytes([comp]))
              + attr("dataWindow", "box2i", box)
              + attr("displayWindow", "box2i", box)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")

    n_blocks = -(-H // lines_per_block)
    chunks = []
    for b in range(n_blocks):
        y0 = b * lines_per_block
        rows = min(lines_per_block, H - y0)
        # per row, each channel's row in (alphabetical) order
        raw = b"".join(
            b"".join(planes[n][y0 + r].tobytes() for n in names)
            for r in range(rows))
        if comp:
            packed = zlib.compress(_interleave_predict(raw))
            if len(packed) >= len(raw):
                packed = raw
        else:
            packed = raw
        chunks.append((y0, packed))

    with open(path, "wb") as f:
        f.write(_MAGIC + struct.pack("<i", 2))
        f.write(header)
        table_pos = f.tell()
        f.write(b"\0" * 8 * n_blocks)
        offsets = []
        for y0, packed in chunks:
            offsets.append(f.tell())
            f.write(struct.pack("<ii", y0, len(packed)))
            f.write(packed)
        f.seek(table_pos)
        f.write(np.asarray(offsets, np.uint64).tobytes())
    return True
