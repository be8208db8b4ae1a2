"""Display adapters: arrays -> displayable RGB images (counterpart of
`libstevi_tpu/gui/display.py`).

Reference parity: `gui/arraydisplayadapter.h` — `ArrayDisplayAdapter` (:45:
multichannel arrays -> RGB with white/black level windowing) and
`GrayscaleArrayDisplayAdapter` (:214: single-channel with colormaps), which
feed the Qt viewer widget.  Here the adapters produce uint8 RGB numpy
arrays directly consumable by matplotlib / imageio / notebooks, with no
Qt dependency.  They take numpy arrays or tensors (a tensor on any device
is copied to the host).  The ``gray`` colormap is numpy alone; the others
come from matplotlib, imported where it is used: without matplotlib they
raise its ImportError, as the JAX package's do.
"""

from __future__ import annotations

import numpy as np


def as_numpy(array) -> np.ndarray:
    """A numpy view of ``array``: a tensor goes through ``.cpu().numpy()``
    (bfloat16 as float32, which numpy lacks)."""
    if hasattr(array, "detach"):                       # a torch tensor
        t = array.detach().cpu()
        if t.dtype.is_floating_point and t.element_size() < 4:
            t = t.float()
        return t.numpy()
    return np.asarray(array)


class ArrayDisplayAdapter:
    """Windowed multichannel display (`arraydisplayadapter.h:45`)."""

    def __init__(self, array, black_level: float | None = None,
                 white_level: float | None = None, channels=(0, 1, 2)):
        self.array = as_numpy(array)
        self.black = float(self.array.min()) if black_level is None \
            else black_level
        self.white = float(self.array.max()) if white_level is None \
            else white_level
        self.channels = channels

    def to_rgb(self) -> np.ndarray:
        a = self.array
        if a.ndim == 2:
            a = a[..., None]
        chans = [a[..., c if c < a.shape[-1] else a.shape[-1] - 1]
                 for c in self.channels]
        img = np.stack(chans, -1).astype(np.float64)
        scale = max(self.white - self.black, 1e-12)
        return np.clip((img - self.black) / scale * 255.0, 0,
                       255).astype(np.uint8)


_COLORMAPS = {
    "gray": lambda t: np.stack([t, t, t], -1),
    "viridis": None,   # resolved through matplotlib on demand
    "turbo": None,
    "jet": None,
}


class GrayscaleArrayDisplayAdapter(ArrayDisplayAdapter):
    """Single-channel display with a colormap
    (`arraydisplayadapter.h:214`)."""

    def __init__(self, array, black_level=None, white_level=None,
                 colormap: str = "gray"):
        super().__init__(array, black_level, white_level)
        self.colormap = colormap

    def to_rgb(self) -> np.ndarray:
        a = self.array.astype(np.float64)
        scale = max(self.white - self.black, 1e-12)
        t = np.clip((a - self.black) / scale, 0, 1)
        if self.colormap == "gray":
            return (np.stack([t, t, t], -1) * 255).astype(np.uint8)
        import matplotlib
        cmap = matplotlib.colormaps[self.colormap]
        return (cmap(t)[..., :3] * 255).astype(np.uint8)


def disparity_to_color(disp, invalid=None, colormap: str = "turbo"
                       ) -> np.ndarray:
    """Convenience disparity visualization (invalid pixels black)."""
    d = as_numpy(disp).astype(np.float64)
    mask = ~np.isfinite(d)
    if invalid is not None:
        mask |= d == invalid
    lo = np.nanmin(np.where(mask, np.nan, d)) if mask.any() else d.min()
    hi = np.nanmax(np.where(mask, np.nan, d)) if mask.any() else d.max()
    rgb = GrayscaleArrayDisplayAdapter(np.where(mask, lo, d), lo, hi,
                                       colormap).to_rgb()
    rgb[mask] = 0
    return rgb
