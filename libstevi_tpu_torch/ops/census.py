"""Census transform: bit-pack per-patch comparisons into 32-bit words
(counterpart of `libstevi_tpu/ops/census.py`).

Reference parity: `correlation/census.h:70-131`.  For an (H, W, F) feature
volume the census features are ceil((F-1)/32) words per pixel; bit b of word
w is ``features[0] > features[1 + 32*w + b]``.  A trailing partial word is
flushed, as in the JAX package (the reference leaves it uninitialized,
`census.h:103-108`).

The words are the uint32 values of `census_data_t`
(`matching_costs.h:773`), held in int64 tensors: torch's uint32 takes few
operations, and bit 31 would make an int32 word negative.
"""

from __future__ import annotations

import torch

from ..core.margins import PaddingMargins
from .unfold import unfold

census_dtype = torch.int64
CENSUS_WORD_BITS = 32


def census_features(base_features: torch.Tensor) -> torch.Tensor:
    """Pack an (..., F) feature volume into (..., ceil((F-1)/32)) census
    words (uint32 values in int64)."""
    F = base_features.shape[-1]
    if F <= 1:
        raise ValueError("census requires more than one feature channel")

    n_words = (F - 2) // CENSUS_WORD_BITS + 1
    ref = base_features[..., 0:1]
    bits = (ref > base_features[..., 1:]).to(census_dtype)  # (..., F-1)

    pad = n_words * CENSUS_WORD_BITS - (F - 1)
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (n_words, CENSUS_WORD_BITS))
    weights = torch.ones((), dtype=census_dtype, device=bits.device) << \
        torch.arange(CENSUS_WORD_BITS, dtype=census_dtype, device=bits.device)
    return torch.sum(bits * weights, dim=-1)


def census_transform_2d(image: torch.Tensor, h_radius: int, v_radius: int,
                        padding: PaddingMargins = PaddingMargins()) -> torch.Tensor:
    """Census transform of a 2-D (grayscale) or 3-D (multichannel) image.
    Reference: `censusTransform2D`, `correlation/census.h:118-131`."""
    fv = unfold(h_radius, v_radius, image, padding)
    return census_features(fv)
