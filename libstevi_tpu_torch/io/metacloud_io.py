"""MetaCloud multi-file point-cloud format, a copy of
`libstevi_tpu/io/metacloud_io.py`.

Reference parity: `io/metacloud_io.{h,cpp}:10-173` (header) and the reader
implementation (`metacloud_io.cpp:280-440`).  A `.metacloud` file is a text
descriptor with four tags:

    POINTS_FILES                 (mandatory; paths to point files in any
    "relative/path.las"           supported codec)
    EXTRA_ATTRIBUTES             (optional; binary sidecar files of packed
    "extra.bin" float32 temp u8 id    per-point records: path, then
                                  type/name pairs)
    INDEX_FILES                  (optional; path, index type, index name)
    "points.bsp" bsp main
    METACLOUD_ATTRIBUTES         (optional; name + value, typed by the
    sensor "riegl"                reference's regexes: unquoted integers ->
    count 42                      int64, unquoted floats -> float64, else
                                  string)

Reading concatenates the referenced point clouds, merges the extra
attribute records (packed little-endian, one record per point, in point
order — `MetaCloudExtraAttributeReader`), and exposes typed metacloud
attributes + index descriptors.  Writing emits the descriptor, one points
file, and packs any non-standard attributes as a native EXTRA_ATTRIBUTES
binary sidecar (NOT LAS extra-bytes).
"""

from __future__ import annotations

import os
import re

import numpy as np

from .pointcloud_io import PointCloud

# `MetaCloudSimpleType` (`metacloud_io.h:11-26`)
SIMPLE_TYPES = {
    "uint8": np.uint8, "uint16": np.uint16, "uint32": np.uint32,
    "uint64": np.uint64, "int8": np.int8, "int16": np.int16,
    "int32": np.int32, "int64": np.int64,
    "float32": np.float32, "float64": np.float64,
}
_TYPE_NAMES = {np.dtype(v): k for k, v in SIMPLE_TYPES.items()}

_TAGS = ("POINTS_FILES", "EXTRA_ATTRIBUTES", "INDEX_FILES",
         "METACLOUD_ATTRIBUTES")
_INT_RE = re.compile(r"^[+-]?[0-9]+$")
_FLOAT_RE = re.compile(
    r"^[+-]?([0-9]+([.][0-9]*)?([eE][+-]?[0-9]+)?|[.][0-9]+([eE][+-]?[0-9]+)?)$")


def _tokens(line: str):
    """Split a header line into tokens + was-quoted flags
    (`getUnquotedTokens`, `metacloud_io.cpp`)."""
    toks, quoted = [], []
    i, n = 0, len(line)
    while i < n:
        while i < n and line[i].isspace():
            i += 1
        if i >= n or line[i] == "#":
            break
        if line[i] == '"':
            j = line.find('"', i + 1)
            if j < 0:
                j = n
            toks.append(line[i + 1:j])
            quoted.append(True)
            i = j + 1
        else:
            j = i
            while j < n and not line[j].isspace():
                j += 1
            toks.append(line[i:j])
            quoted.append(False)
            i = j
    return toks, quoted


def read_metacloud(path: str) -> PointCloud:
    from .pointcloud_io import open_point_cloud
    d = os.path.dirname(os.path.abspath(path))
    section = None
    point_files = []
    extra_descs = []       # (path, [(name, dtype), ...])
    index_files = []       # (path, type, name)
    meta = {}
    with open(path) as f:
        for raw in f:
            toks, quoted = _tokens(raw)
            if not toks:
                continue
            if (len(toks) == 1 and not quoted[0] and toks[0] in _TAGS):
                section = toks[0]
                continue
            if section == "POINTS_FILES":
                point_files.extend(toks)
            elif section == "EXTRA_ATTRIBUTES":
                if len(toks) >= 3 and len(toks) % 2 == 1:
                    fields = []
                    for k in range((len(toks) - 1) // 2):
                        tname = toks[1 + 2 * k]
                        if tname not in SIMPLE_TYPES:
                            raise IOError(f"bad extra-attribute type "
                                          f"{tname!r} in {path}")
                        fields.append((toks[2 + 2 * k],
                                       SIMPLE_TYPES[tname]))
                    extra_descs.append((toks[0], fields))
                else:
                    raise IOError(f"malformed EXTRA_ATTRIBUTES in {path}")
            elif section == "INDEX_FILES":
                if len(toks) != 3:
                    raise IOError(f"malformed INDEX_FILES in {path}")
                index_files.append(tuple(toks))
            elif section == "METACLOUD_ATTRIBUTES":
                if len(toks) != 2:
                    raise IOError(f"malformed METACLOUD_ATTRIBUTES in "
                                  f"{path}")
                name, val = toks
                if not quoted[1] and _INT_RE.match(val):
                    meta[name] = int(val)               # int64
                elif not quoted[1] and _FLOAT_RE.match(val):
                    meta[name] = float(val)             # float64
                else:
                    meta[name] = val                    # string

    clouds = [open_point_cloud(os.path.normpath(os.path.join(d, p)))
              for p in point_files]
    if not clouds:
        raise IOError(f"metacloud references no point files: {path}")
    positions = np.concatenate([c.positions for c in clouds], 0)
    attrs = {}
    common = set(clouds[0].attributes)
    for c in clouds[1:]:
        common &= set(c.attributes)
    for k in common:
        attrs[k] = np.concatenate([np.asarray(c.attributes[k])
                                   for c in clouds], 0)
    n = len(positions)

    # extra attribute sidecars: packed records, one per point, point order
    for rel, fields in extra_descs:
        rec = np.dtype([(nm, dt) for nm, dt in fields])
        raw = np.fromfile(os.path.normpath(os.path.join(d, rel)), rec)
        if len(raw) != n:
            raise IOError(f"extra-attribute file {rel!r} holds {len(raw)} "
                          f"records for {n} points")
        for nm, _ in fields:
            attrs[nm] = np.array(raw[nm])

    cloud = PointCloud(positions, attrs)
    cloud.metacloud_attributes = meta
    cloud.metacloud_index_files = index_files
    return cloud


#: attributes the LAS points file stores natively (everything else goes to
#: an EXTRA_ATTRIBUTES sidecar)
_LAS_NATIVE = {"intensity", "return_number", "number_of_returns",
               "scan_direction", "edge_of_flight_line", "classification",
               "synthetic", "keypoint", "withheld", "overlap",
               "scanner_channel", "scan_angle", "user_data",
               "point_source_id", "gps_time", "rgb", "nir", "wave_packet",
               "extra_bytes"}   # raw undescribed payload: LAS stores it


def write_metacloud(path: str, cloud: PointCloud, meta: dict | None = None,
                    index_files=None) -> bool:
    """Native multi-file write: descriptor + points file + one packed
    EXTRA_ATTRIBUTES binary for the non-LAS attributes
    (`metacloud_io.h:31-35` descriptor semantics)."""
    from .las_stream import write_las_v2
    base = os.path.splitext(os.path.basename(path))[0]
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)

    las_attrs = {k: v for k, v in cloud.attributes.items()
                 if k in _LAS_NATIVE}
    extra = {k: np.asarray(v) for k, v in cloud.attributes.items()
             if k not in _LAS_NATIVE}

    points_file = f"{base}_points.las"
    write_las_v2(os.path.join(d, points_file),
                 np.ascontiguousarray(cloud.positions, np.float64),
                 las_attrs)

    lines = ["# metacloud descriptor", "", "POINTS_FILES",
             f'"{points_file}"']
    if extra:
        fields = []
        for k, v in extra.items():
            if v.dtype == bool:
                v = v.astype(np.uint8)
                extra[k] = v
            if v.ndim != 1 or np.dtype(v.dtype) not in _TYPE_NAMES:
                raise ValueError(f"cannot encode attribute {k!r} "
                                 f"({v.dtype}, ndim {v.ndim}) as a "
                                 f"metacloud extra attribute")
            fields.append((k, v.dtype))
        rec = np.dtype(fields)
        packed = np.empty(cloud.n_points, rec)
        for k, _ in fields:
            packed[k] = extra[k]
        extra_file = f"{base}_extra.bin"
        packed.tofile(os.path.join(d, extra_file))
        spec = " ".join(f'{_TYPE_NAMES[np.dtype(dt)]} "{nm}"'
                        for nm, dt in fields)
        lines += ["", "EXTRA_ATTRIBUTES", f'"{extra_file}" {spec}']
    if index_files is None:
        # read->write round trips preserve the source's index descriptors
        # (read_metacloud records them on the cloud, like meta below)
        index_files = getattr(cloud, "metacloud_index_files", None)
    if index_files:
        lines += ["", "INDEX_FILES"]
        for (p, t, nm) in index_files:
            lines.append(f'"{p}" {t} {nm}')
    meta = meta if meta is not None else getattr(
        cloud, "metacloud_attributes", None)
    if meta:
        lines += ["", "METACLOUD_ATTRIBUTES"]
        for k, v in meta.items():
            if isinstance(v, (int, np.integer)):
                lines.append(f"{k} {int(v)}")
            elif isinstance(v, (float, np.floating)):
                lines.append(f"{k} {float(v)!r}")
            else:
                lines.append(f'{k} "{v}"')
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return True
