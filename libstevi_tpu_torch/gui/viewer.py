"""Interactive image / disparity viewer: pan, zoom, level-windowing
(counterpart of `libstevi_tpu/gui/viewer.py`).

Reference parity: `examples/data_img_viewer/` + the qImageDisplayWidget
submodule (`.gitmodules:1-3`, `gui/arraydisplayadapter.h:45,214`) — the
reference's Qt widget offers mouse pan/zoom and white/black level
interaction over the display adapters.  This is the Qt-free equivalent
on matplotlib (imported when a viewer is made): the SAME
display adapters render, and the interaction layer adds

  * scroll wheel       — zoom about the cursor,
  * left-button drag   — pan,
  * right-button drag  — level windowing (horizontal: window center,
                          vertical: window width — the radiology
                          convention),
  * keys               — ``r`` reset view+levels, ``c`` cycle colormap
                          (single-channel), ``g`` toggle grid,
  * status bar         — cursor position + underlying DATA value (not
                          the windowed rendering).

The widget is headless-testable: every handler is a plain method taking
a matplotlib event, and rendering works on the Agg backend; ``show()``
opens a window only when a display exists.
"""

from __future__ import annotations

import numpy as np

from .display import (ArrayDisplayAdapter, GrayscaleArrayDisplayAdapter,
                      as_numpy)

_CMAPS = ("viridis", "turbo", "gray", "jet")


class InteractiveViewer:
    """Pan/zoom/level-window viewer over a 2-D (grayscale/disparity) or
    (H, W, C) array or tensor (kept as a host copy)."""

    def __init__(self, array, colormap: str = "viridis",
                 black_level: float | None = None,
                 white_level: float | None = None, title: str | None = None):
        import matplotlib.pyplot as plt

        self.data = as_numpy(array)
        finite = self.data[np.isfinite(self.data)]
        lo = float(finite.min()) if finite.size else 0.0
        hi = float(finite.max()) if finite.size else 1.0
        self._full_range = (lo, hi)
        self.black = lo if black_level is None else float(black_level)
        self.white = hi if white_level is None else float(white_level)
        self._cmap_idx = _CMAPS.index(colormap) if colormap in _CMAPS else 0

        self.fig, self.ax = plt.subplots()
        if title:
            self.fig.canvas.manager.set_window_title(title) \
                if self.fig.canvas.manager else None
            self.ax.set_title(title)
        self._im = self.ax.imshow(self._render())
        self.ax.set_xlim(-0.5, self.data.shape[1] - 0.5)
        self.ax.set_ylim(self.data.shape[0] - 0.5, -0.5)
        self._home = (self.ax.get_xlim(), self.ax.get_ylim())
        self._drag = None          # (button, x, y, state at press)
        self.ax.format_coord = self._format_coord

        c = self.fig.canvas
        c.mpl_connect("scroll_event", self.on_scroll)
        c.mpl_connect("button_press_event", self.on_press)
        c.mpl_connect("button_release_event", self.on_release)
        c.mpl_connect("motion_notify_event", self.on_motion)
        c.mpl_connect("key_press_event", self.on_key)

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    def _render(self) -> np.ndarray:
        if self.data.ndim == 2:
            return GrayscaleArrayDisplayAdapter(
                self.data, black_level=self.black, white_level=self.white,
                colormap=_CMAPS[self._cmap_idx]).to_rgb()
        return ArrayDisplayAdapter(self.data, black_level=self.black,
                                   white_level=self.white).to_rgb()

    def _refresh(self):
        self._im.set_data(self._render())
        self.fig.canvas.draw_idle()

    def _format_coord(self, x, y):
        j, i = int(round(x)), int(round(y))
        H, W = self.data.shape[:2]
        if 0 <= i < H and 0 <= j < W:
            v = self.data[i, j]
            vs = f"{v:.4g}" if np.ndim(v) == 0 else \
                "(" + ", ".join(f"{c:.4g}" for c in np.atleast_1d(v)) + ")"
            return (f"x={j} y={i} value={vs} "
                    f"[window {self.black:.4g}..{self.white:.4g}]")
        return f"x={x:.1f} y={y:.1f}"

    # ------------------------------------------------------------------
    # interaction
    # ------------------------------------------------------------------

    def on_scroll(self, event):
        if event.xdata is None or event.ydata is None:
            return
        factor = 0.8 if event.button == "up" else 1.25
        x0, x1 = self.ax.get_xlim()
        y0, y1 = self.ax.get_ylim()
        x, y = event.xdata, event.ydata
        self.ax.set_xlim(x + (x0 - x) * factor, x + (x1 - x) * factor)
        self.ax.set_ylim(y + (y0 - y) * factor, y + (y1 - y) * factor)
        self.fig.canvas.draw_idle()

    def on_press(self, event):
        if event.xdata is None and event.button != 3:
            return
        if event.button == 1:
            self._drag = (1, event.xdata, event.ydata,
                          (self.ax.get_xlim(), self.ax.get_ylim()))
        elif event.button == 3:
            self._drag = (3, event.x, event.y, (self.black, self.white))

    def on_release(self, event):
        self._drag = None

    def on_motion(self, event):
        if self._drag is None:
            return
        btn, px, py, state = self._drag
        if btn == 1:
            if event.xdata is None:
                return
            (x0, x1), (y0, y1) = state
            dx = event.xdata - px
            dy = event.ydata - py
            self.ax.set_xlim(x0 - dx, x1 - dx)
            self.ax.set_ylim(y0 - dy, y1 - dy)
            self.fig.canvas.draw_idle()
        else:
            # level windowing: horizontal -> center, vertical -> width
            b0, w0 = state
            center = 0.5 * (b0 + w0)
            width = max(w0 - b0, 1e-12)
            lo, hi = self._full_range
            span = max(hi - lo, 1e-12)
            wpix = max(self.fig.canvas.get_width_height()[0], 1)
            center += (event.x - px) / wpix * span
            width *= float(np.exp((event.y - py) / 200.0))
            self.black = center - 0.5 * width
            self.white = center + 0.5 * width
            self._refresh()

    def on_key(self, event):
        if event.key == "r":
            self.ax.set_xlim(*self._home[0])
            self.ax.set_ylim(*self._home[1])
            self.black, self.white = self._full_range
            self._refresh()
        elif event.key == "c" and self.data.ndim == 2:
            self._cmap_idx = (self._cmap_idx + 1) % len(_CMAPS)
            self._refresh()
        elif event.key == "g":
            self.ax.grid(not any(gl.get_visible()
                                 for gl in self.ax.get_xgridlines()))
            self.fig.canvas.draw_idle()

    # ------------------------------------------------------------------

    def rgb(self) -> np.ndarray:
        """The current rendering (for tests / exports)."""
        return self._render()

    def show(self):
        import matplotlib.pyplot as plt
        plt.show()


def view(array, **kwargs) -> InteractiveViewer:
    """Open an interactive viewer on ``array`` (blocking when a display
    exists; on headless backends the viewer object is still fully
    functional for programmatic use)."""
    v = InteractiveViewer(array, **kwargs)
    v.show()
    return v
