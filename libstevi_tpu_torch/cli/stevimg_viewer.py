"""Image / disparity viewer-exporter of the port (the counterpart of
`cli/stevimg_viewer.py`, host numpy with the JAX tool's arguments and JSON
report).

Reference parity: `examples/{stevimg_viewer,data_img_viewer,
io_img_and_disp}` — the Qt viewers' role, headless: read any supported
image (.stevimg / .flo / png...), report stats, and export a display
rendering through the GUI adapters (multichannel black/white levels or
single-channel colormap).

  python -m libstevi_tpu_torch.cli.stevimg_viewer data.stevimg [-o view.png]
      [--colormap viridis|gray|jet] [--black B] [--white W]
      [--interactive]

``--interactive`` opens the pan/zoom/level-window viewer
(`libstevi_tpu_torch.gui.InteractiveViewer` — the Qt-free counterpart of
the reference's qImageDisplayWidget interaction: wheel zoom, left-drag
pan, right-drag level windowing, 'r' reset / 'c' colormap cycle).  The
``gray`` colormap needs numpy alone; the others, ``--interactive``, and a
PNG (or any imageio format) output raise ImportError where matplotlib or
imageio is missing, as the JAX tool does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("image")
    ap.add_argument("-o", "--output", default=None,
                    help="rendered RGB export (.png/.stevimg)")
    ap.add_argument("--colormap", default="viridis")
    ap.add_argument("--black", type=float, default=None)
    ap.add_argument("--white", type=float, default=None)
    ap.add_argument("--channel", type=int, default=None,
                    help="view one channel of a multichannel image")
    ap.add_argument("--interactive", action="store_true",
                    help="open the pan/zoom/level-window viewer")
    args = ap.parse_args(argv)

    from ..io import read_image, write_image
    from ..gui import ArrayDisplayAdapter, GrayscaleArrayDisplayAdapter

    img = np.asarray(read_image(args.image, np.float32))
    finite = img[np.isfinite(img)]
    report = {"path": args.image, "shape": list(img.shape),
              "dtype": "float32",
              "min": float(finite.min()) if finite.size else None,
              "max": float(finite.max()) if finite.size else None,
              "mean": float(finite.mean()) if finite.size else None,
              "n_nonfinite": int((~np.isfinite(img)).sum())}
    print(json.dumps(report))

    if args.output:
        view = img
        if args.channel is not None and view.ndim == 3:
            view = view[..., args.channel]
        if view.ndim == 2:
            adapter = GrayscaleArrayDisplayAdapter(
                view, black_level=args.black, white_level=args.white,
                colormap=args.colormap)
        else:
            adapter = ArrayDisplayAdapter(view, black_level=args.black,
                                          white_level=args.white)
        write_image(args.output, adapter.to_rgb())

    if args.interactive:
        from ..gui import view as gui_view
        v = img
        if args.channel is not None and v.ndim == 3:
            v = v[..., args.channel]
        gui_view(v, colormap=args.colormap, black_level=args.black,
                 white_level=args.white, title=args.image)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
