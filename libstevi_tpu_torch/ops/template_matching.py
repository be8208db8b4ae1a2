"""Template matching over feature volumes (counterpart of
`libstevi_tpu/ops/template_matching.py`).

Reference parity: `correlation/template_matching.h:35` — `matchPattern`:
compare one feature template against every pixel of a search feature volume,
returning a score/cost map for the chosen matching function.
"""

from __future__ import annotations

import torch

from ..core.types import MatchingFunction
from .cost_volume import normalize_feature_volume
from .matching import feature_comparison


def match_pattern(func: MatchingFunction, template_features: torch.Tensor,
                  search_fv: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """template_features: (F,); search_fv: (H, W, F) -> (H, W) scores."""
    if normalize:
        t = normalize_feature_volume(func, template_features[None, None, :])
        s = normalize_feature_volume(func, search_fv)
        t = t[0, 0]
    else:
        t, s = template_features, search_fv
    return feature_comparison(func, t.expand(s.shape), s)
