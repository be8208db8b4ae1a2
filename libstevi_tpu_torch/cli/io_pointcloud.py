"""Point-cloud info / conversion CLI of the port (the counterpart of
`cli/io_pointcloud.py`): host work in numpy on the port's LAS and LZF
codecs, with the JAX tool's arguments and JSON reports.

Reference parity: `examples/{io_las,io_pcd,io_sdc,io_metacloud,
point_cloud_infos,io_remove_attributes}` — one tool covering them all:

  python -m libstevi_tpu_torch.cli.io_pointcloud info cloud.las
  python -m libstevi_tpu_torch.cli.io_pointcloud convert in.las out.pcd
      [--drop attr ...] [--rename old=new ...]
  python -m libstevi_tpu_torch.cli.io_pointcloud map in.las [out.las]
      --map x=y y=x z=newZ
      [--only-keep]    (examples/io_map/main.cpp — position components
      participate in the mapping; prints the first point before/after)
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_info = sub.add_parser("info", help="print header + attribute stats")
    p_info.add_argument("path")
    p_info.add_argument("--chunk", type=int, default=1 << 20)
    p_conv = sub.add_parser("convert", help="convert between codecs")
    p_conv.add_argument("src")
    p_conv.add_argument("dst")
    p_conv.add_argument("--drop", nargs="*", default=[],
                        help="attributes to remove (io_remove_attributes)")
    p_conv.add_argument("--rename", nargs="*", default=[],
                        help="old=new attribute renames (attributeMapper)")
    p_map = sub.add_parser("map", help="attribute mapper incl. geometry "
                           "components (examples/io_map)")
    p_map.add_argument("src")
    p_map.add_argument("dst", nargs="?", default=None)
    p_map.add_argument("--map", nargs="+", required=True, dest="mapping",
                       help="old=new pairs; x/y/z address the geometry")
    p_map.add_argument("--only-keep", action="store_true",
                       help="drop attributes not named in the map "
                            "(onlyKeepAttributesInMap)")
    args = ap.parse_args(argv)

    from ..io import open_point_cloud, save_point_cloud
    from ..io.pointcloud_io import open_point_cloud_stream

    if args.cmd == "info":
        r = open_point_cloud_stream(args.path)
        out = {"path": args.path, "n_points": r.n_points,
               "attributes": list(r.attributes)}
        if hasattr(r, "header"):                       # LAS
            h = r.header
            out.update({"format": f"LAS {h.version[0]}.{h.version[1]}",
                        "point_format": h.point_format,
                        "record_len": h.point_record_len,
                        "extra_bytes": h.extra_bytes,
                        "n_vlrs": len(h.vlrs),
                        "scale": h.scale.tolist(),
                        "offset": h.offset.tolist()})
        # streamed min/max of positions (bounded memory)
        mins = np.full(3, np.inf)
        maxs = np.full(3, -np.inf)
        for ch in r.chunks(args.chunk):
            if len(ch["xyz"]):
                mins = np.minimum(mins, ch["xyz"].min(0))
                maxs = np.maximum(maxs, ch["xyz"].max(0))
        out["mins"] = mins.tolist()
        out["maxs"] = maxs.tolist()
        print(json.dumps(out, indent=1))
        return 0

    if args.cmd == "map":
        from ..io.pointcloud_io import AttributeMapperStream
        mapping = dict(r.split("=", 1) for r in args.mapping)
        stream = open_point_cloud_stream(args.src)
        first = stream.read_chunk(0, 1)
        mapped = AttributeMapperStream(stream, mapping, args.only_keep)
        first_m = mapped.read_chunk(0, 1)

        def show(ch):
            d = {"geometry": np.asarray(ch["xyz"][0]).tolist()}
            d.update({k: np.asarray(v[0]).tolist() for k, v in ch.items()
                      if k != "xyz"})
            return d

        out = {"attributes": list(mapped.attributes),
               "first_point_before": show(first),
               "first_point_after": show(first_m)}
        if args.dst:
            # one bounded-memory pass: mapper stream -> chunked writer
            # (LAS streams end-to-end; other codecs materialize once)
            from ..io.pointcloud_io import write_point_cloud_stream
            write_point_cloud_stream(args.dst, mapped)
            out["written"] = args.dst
        print(json.dumps(out, indent=1))
        return 0

    cloud = open_point_cloud(args.src)
    if args.drop:
        cloud = cloud.drop_attributes(set(args.drop))
    if args.rename:
        mapping = dict(r.split("=", 1) for r in args.rename)
        cloud = cloud.rename_attributes(mapping)
    save_point_cloud(args.dst, cloud)
    print(json.dumps({"written": args.dst, "n_points": cloud.n_points,
                      "attributes": list(cloud.attributes)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
