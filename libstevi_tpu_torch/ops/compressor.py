"""Superpixel ("compressor") unfold (counterpart of
`libstevi_tpu/ops/compressor.py`).

Reference parity: `correlation/unfold.h` — `UnFoldCompressor` (:36: a
superpixel mask where each positive label defines one feature channel whose
value is the weighted mean of its member pixels, weight = 1/count; feature
order = ascending label; offsets are relative to the mask center
(height/2, width/2)), the compressed `unfold` overload (:347), and the
`CompressorGenerators::GrPix17R3Filter` / `GrPix17R4Filter` masks
(:476,568) — 17-channel group-pixel patterns of radius 3 / 4.

The compressed unfold is a static loop of shifted image slices
accumulated with the group weights: torch ops on the image's device, no
gathers.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.margins import PaddingMargins, Margins


class UnFoldCompressor:
    def __init__(self, mask: np.ndarray):
        mask = np.asarray(mask, int)
        h_mask, w_mask = mask.shape
        v_off = h_mask // 2
        h_off = w_mask // 2
        labels = sorted(set(mask[mask > 0].ravel().tolist()))
        self.n_features = len(labels)
        self.entries = []  # (dv, dh, feature_index, weight)
        minH = minW = 0
        maxH = maxW = 0
        for f_idx, lab in enumerate(labels):
            ii, jj = np.nonzero(mask == lab)
            w = 1.0 / len(ii)
            for i, j in zip(ii, jj):
                dv, dh = i - v_off, j - h_off
                minH, maxH = min(minH, dv), max(maxH, dv)
                minW, maxW = min(minW, dh), max(maxW, dh)
                self.entries.append((dv, dh, f_idx, w))
        self.height = maxH - minH + 1
        self.width = maxW - minW + 1
        self.margins = Margins(-minW, -minH, maxW, maxH)


def unfold_compressed(compressor: UnFoldCompressor, image: torch.Tensor,
                      padding: PaddingMargins = PaddingMargins()
                      ) -> torch.Tensor:
    """Compressed unfold (`unfold.h:347-440`): (H, W) -> (H', W',
    n_features) with zero fill outside the image."""
    if image.ndim == 3:
        raise NotImplementedError("compressed unfold covers 2-D images")
    H, W = image.shape
    m = compressor.margins
    pad = padding.resolve(0, 0) if not padding.auto else m
    out_h = H - compressor.height + pad.top + pad.bottom + 1
    out_w = W - compressor.width + pad.left + pad.right + 1

    # Output pixel (i, j) samples input[(i - pad.top) + (dv + m.top),
    # (j - pad.left) + (dh + m.left)] (dense-unfold convention with window
    # coordinate k = dv - minH); padding the image by exactly the padding
    # margins makes every needed slice static and in range.
    padded = torch.nn.functional.pad(
        image.float(), (pad.left, pad.right, pad.top, pad.bottom))

    feats = [torch.zeros((out_h, out_w), dtype=torch.float32,
                         device=image.device)
             for _ in range(compressor.n_features)]
    for (dv, dh, f, w) in compressor.entries:
        i0 = dv + m.top
        j0 = dh + m.left
        feats[f] = feats[f] + w * padded[i0:i0 + out_h, j0:j0 + out_w]
    return torch.stack(feats, -1)


def grpix17r3_filter() -> np.ndarray:
    """`GrPix17R3Filter` (`unfold.h:476`)."""
    m = np.zeros((7, 7), int)
    m[3, 3] = 1
    m[3, 2] = m[3, 1] = 2
    m[3, 4] = m[3, 5] = 3
    m[2, 3] = m[1, 3] = 4
    m[4, 3] = m[5, 3] = 5
    m[1, 2] = m[2, 1] = m[2, 2] = 6
    m[1, 4] = m[2, 5] = m[2, 4] = 7
    m[4, 2] = m[4, 1] = m[5, 2] = 8
    m[4, 4] = m[4, 5] = m[5, 4] = 9
    m[0, 2] = m[0, 3] = m[0, 4] = 10
    m[2, 0] = m[3, 0] = m[4, 0] = 11
    m[6, 2] = m[6, 3] = m[6, 4] = 12
    m[2, 6] = m[3, 6] = m[4, 6] = 13
    m[0, 0] = m[0, 1] = m[1, 0] = m[1, 1] = 14
    m[5, 0] = m[5, 1] = m[6, 0] = m[6, 1] = 15
    m[0, 5] = m[0, 6] = m[1, 5] = m[1, 6] = 16
    m[5, 5] = m[5, 6] = m[6, 5] = m[6, 6] = 17
    return m


def grpix17r4_filter() -> np.ndarray:
    """`GrPix17R4Filter` (`unfold.h:568`)."""
    m = np.zeros((9, 9), int)
    m[4, 4] = 1
    m[4, 3] = m[4, 2] = 2
    m[4, 5] = m[4, 6] = 3
    m[3, 4] = m[2, 4] = 4
    m[5, 4] = m[6, 4] = 5
    m[2, 2] = m[2, 3] = m[3, 2] = m[3, 3] = 6
    m[2, 5] = m[2, 6] = m[3, 5] = m[3, 6] = 7
    m[5, 2] = m[5, 3] = m[6, 2] = m[6, 3] = 8
    m[5, 5] = m[5, 6] = m[6, 5] = m[6, 6] = 9
    m[0, 3:6] = m[1, 3:6] = 10
    m[3:6, 0] = m[3:6, 1] = 11
    m[7, 3:6] = m[8, 3:6] = 12
    m[3:6, 7] = m[3:6, 8] = 13
    m[0, 0:3] = m[1, 0:3] = 14
    m[2, 0] = m[2, 1] = 14
    m[7, 0:3] = m[8, 0:3] = 15
    m[6, 0] = m[6, 1] = 15
    m[0, 7] = m[0, 8] = m[1, 7] = m[1, 8] = 16
    m[0, 6] = m[1, 6] = m[2, 7] = m[2, 8] = 16
    m[7, 6:9] = m[8, 6:9] = 17
    m[6, 7] = m[6, 8] = 17
    return m
