"""Sliding-window patch extraction (im2col) producing feature volumes
(counterpart of `libstevi_tpu/ops/unfold.py`).

Reference parity: `correlation/unfold.h:248-344` — `unfold(h_radius, v_radius,
image, padding, orientation)` returns an (outH, outW, F) feature volume with
F = (2*v_radius+1) * (2*h_radius+1) * C, out-of-image samples filled with 0,
auto padding = the window radii (output size == input size), and feature
channels ordered row-major over (dy, dx, input channel) for Rotate0
(`channelFromCord`, `unfold.h:171-191`).

The window loop is a static Python loop over (2r+1)^2 offsets, each a
shifted slice of one zero-padded image: plain copies, no `F.unfold` and no
convolution, so no TF32 path on a GPU.
"""

from __future__ import annotations

import enum

import numpy as np
import torch

from ..core.margins import PaddingMargins


class PatchOrientation(enum.Enum):
    """Patch rotation applied to the feature ordering.
    Reference: `UnfoldPatchOrientation`, `correlation/unfold.h:139-144`."""

    ROTATE_0 = 0
    ROTATE_90 = 1
    ROTATE_180 = 2
    ROTATE_270 = 3


def _channel_from_coord(k: int, l: int, c: int, h: int, v: int, channels: int,
                        orientation: PatchOrientation) -> int:
    """Feature-channel index of window sample (row k, col l, channel c) for a
    (v, h) window.  Reference: `channelFromCord`, `unfold.h:171-191`."""
    if orientation is PatchOrientation.ROTATE_0:
        return channels * h * k + channels * l + c
    if orientation is PatchOrientation.ROTATE_90:
        return channels * v * (h - l - 1) + channels * k + c
    if orientation is PatchOrientation.ROTATE_180:
        return channels * h * (v - k - 1) + channels * (h - l - 1) + c
    return channels * v * l + channels * (v - k - 1) + c  # ROTATE_270


def unfold_permutation(h_radius: int, v_radius: int, channels: int,
                       orientation: PatchOrientation) -> np.ndarray:
    """Static permutation mapping Rotate0 feature order to ``orientation``:
    ``out[..., perm[f]] = rot0[..., f]`` for each Rotate0 channel f."""
    h = 2 * h_radius + 1
    v = 2 * v_radius + 1
    perm = np.empty(h * v * channels, dtype=np.int64)
    for k in range(v):
        for l in range(h):
            for c in range(channels):
                src = _channel_from_coord(k, l, c, h, v, channels,
                                          PatchOrientation.ROTATE_0)
                dst = _channel_from_coord(k, l, c, h, v, channels, orientation)
                perm[dst] = src
    return perm


def unfold(h_radius: int, v_radius: int, image: torch.Tensor,
           padding: PaddingMargins = PaddingMargins(),
           orientation: PatchOrientation = PatchOrientation.ROTATE_0,
           dtype=None) -> torch.Tensor:
    """Extract (2*v_radius+1, 2*h_radius+1) patches around every pixel.

    ``image`` is (H, W) or (H, W, C); returns (outH, outW, F) with
    ``outH = H - (2*v_radius+1) + pad_top + pad_bottom + 1`` (== H for auto
    padding) and F = window_size * C.  Out-of-image samples are 0
    (`unfold.h:284` ``valueOrAlt(..., 0)``)."""
    if image.ndim == 2:
        image = image[:, :, None]
    if dtype is not None:
        image = image.to(dtype)

    H, W, C = image.shape
    pad = padding.resolve(h_radius, v_radius)
    h = 2 * h_radius + 1
    v = 2 * v_radius + 1

    out_h = H - v + pad.top + pad.bottom + 1
    out_w = W - h + pad.left + pad.right + 1

    # One zero-padded copy; output pixel (i, j) reads input
    # (i - pad_top + k, j - pad_left + l), i.e. padded[i + k, j + l].
    pad_bottom_extra = max(0, out_h + v - 1 - (H + pad.top))
    pad_right_extra = max(0, out_w + h - 1 - (W + pad.left))
    padded = image.new_zeros((pad.top + H + pad_bottom_extra,
                              pad.left + W + pad_right_extra, C))
    padded[pad.top:pad.top + H, pad.left:pad.left + W] = image

    slices = [padded[k:k + out_h, l:l + out_w, :]
              for k in range(v) for l in range(h)]
    fv = torch.cat(slices, dim=-1)  # Rotate0 (dy, dx, c) order

    if orientation is not PatchOrientation.ROTATE_0:
        perm = unfold_permutation(h_radius, v_radius, C, orientation)
        inv = torch.from_numpy(np.argsort(perm)).to(fv.device)
        fv = fv.index_select(-1, inv)
    return fv


def unfold_offsets(offsets, image: torch.Tensor, dtype=None) -> torch.Tensor:
    """Feature volume from an arbitrary list of (di, dj) or (di, dj, c)
    sample offsets (the on-demand feature-volume pixel windows of
    `correlation/on_demand_features_volume.h:35`), densely materialized.

    Out-of-image samples are 0.  Returns (H, W, len(offsets))."""
    if image.ndim == 2:
        image = image[:, :, None]
    if dtype is not None:
        image = image.to(dtype)
    H, W, C = image.shape

    offs = [tuple(o) if len(o) == 3 else (o[0], o[1], 0) for o in offsets]
    max_up = max(0, -min(o[0] for o in offs))
    max_down = max(0, max(o[0] for o in offs))
    max_left = max(0, -min(o[1] for o in offs))
    max_right = max(0, max(o[1] for o in offs))
    padded = image.new_zeros((max_up + H + max_down, max_left + W + max_right,
                              C))
    padded[max_up:max_up + H, max_left:max_left + W] = image

    slices = [padded[max_up + di:max_up + di + H,
                     max_left + dj:max_left + dj + W, c]
              for (di, dj, c) in offs]
    return torch.stack(slices, dim=-1)


def unfold_sliding_subwindow_idxs(h_radius: int, v_radius: int,
                                  sub_h_size: int, sub_v_size: int,
                                  channels: int = 1) -> np.ndarray:
    """Feature-row index sets of every (sub_v, sub_h) sub-window sliding
    inside the full (2v+1, 2h+1) unfold window
    (`getUnfoldFeatureSlidingSubwindowIdxs`, `unfold.h:203-246`).  Returns
    (n_subwindows, sub_h*sub_v*channels) int32."""
    h_orig = 2 * h_radius + 1
    v_orig = 2 * v_radius + 1
    n_h = h_orig - sub_h_size + 1
    n_v = v_orig - sub_v_size + 1
    if n_h < 1 or n_v < 1 or sub_h_size * sub_v_size * channels < 1:
        return np.zeros((0, 0), np.int32)
    out = np.empty((n_v * n_h, sub_h_size * sub_v_size * channels),
                   np.int32)
    for i in range(n_v):
        for j in range(n_h):
            col = i * n_h + j
            for k in range(sub_v_size):
                for l in range(sub_h_size):
                    for c in range(channels):
                        src = _channel_from_coord(
                            i + k, j + l, c, h_orig, v_orig, channels,
                            PatchOrientation.ROTATE_0)
                        dst = _channel_from_coord(
                            k, l, c, sub_h_size, sub_v_size, channels,
                            PatchOrientation.ROTATE_0)
                        out[col, dst] = src
    return out
