"""Average-pooling downsampling (counterpart of
`libstevi_tpu/interpolation/downsampling.py`).

Reference parity: `interpolation/downsampling.h:68-121` —
``averagePoolingDownsample``: output size = ceil(size / window), the window
grid is centered (initial offset = remainder/2 on each axis, shifting windows
*up-left* off the image), and border windows average only their in-image
samples (count-normalized).

The image is zero-padded to the aligned window grid and each window's
samples are added as strided slices in row-major order, beside a padded
ones mask for the counts: elementwise adds only, so the result has the
same bits on either device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _window_sums(x: torch.Tensor, v_window: int,
                 h_window: int) -> torch.Tensor:
    """(v_window * nh, h_window * nw, C) -> (nh, nw, C) window sums."""
    out = None
    for dv in range(v_window):
        for dh in range(h_window):
            s = x[dv::v_window, dh::h_window]
            out = s if out is None else out + s
    return out


def average_pooling_downsample(image: torch.Tensor, h_window: int,
                               v_window: int | None = None) -> torch.Tensor:
    """(H, W) or (H, W, C) -> ceil-divided shape, count-normalized means."""
    if v_window is None:
        v_window = h_window
    chan = image.ndim == 3
    x = image.float()
    if not chan:
        x = x[..., None]
    H, W, _ = x.shape

    new_h = -(-H // v_window)
    new_w = -(-W // h_window)
    # the reference's "hRem" is the ROW remainder and "vRem" the COLUMN
    # remainder, and it applies initialVOffset (= vRem/2) to rows and
    # initialHOffset (= hRem/2) to columns (`downsampling.h:81-87,96-101`)
    # — i.e. the offsets are cross-applied; replicated exactly.
    h_rem = new_h * v_window - H    # row remainder
    v_rem = new_w * h_window - W    # column remainder
    pad_top = v_rem // 2            # initial_v_offset, applied to rows
    pad_left = h_rem // 2           # initial_h_offset, applied to columns
    pad_bottom = new_h * v_window - H - pad_top
    pad_right = new_w * h_window - W - pad_left

    # when the cross-applied offsets exceed the own-axis remainder the
    # trailing rows/columns fall outside every window (the reference's
    # bounds-checked taps never read them, `downsampling.h:105`): crop them
    ones = torch.ones((H, W, 1), device=x.device)
    if pad_bottom < 0:
        x, ones = x[:pad_bottom], ones[:pad_bottom]
        pad_bottom = 0
    if pad_right < 0:
        x, ones = x[:, :pad_right], ones[:, :pad_right]
        pad_right = 0
    pads = (0, 0, pad_left, pad_right, pad_top, pad_bottom)
    sums = _window_sums(F.pad(x, pads), v_window, h_window)
    counts = _window_sums(F.pad(ones, pads), v_window, h_window)
    out = sums / counts
    return out if chan else out[..., 0]
