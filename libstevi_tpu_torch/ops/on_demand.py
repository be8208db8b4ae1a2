"""On-demand cost / feature volumes (counterpart of
`libstevi_tpu/ops/on_demand.py`).

Reference parity: `correlation/on_demand_cost_volume.h` —
`GenericOnDemandCostVolume` (:37: a lazily-filled dense volume with a
computed mask), `CachelessOnDemandCostVolume` (:347: recompute on every
access), the stereo/flow aliases (:330,335,615,620) and
`on_demand_features_volume.h` (:35,169: arbitrary-offset feature windows
with a zero-mean/normalized decorator).

Lazy per-(pixel, disparity) memoization does not suit a device that runs
whole tensors: the classes keep the reference's API shape (`cost_value`,
`truncated_cost_volume`) but their query granularity is an (H, W)
candidate field; scalar access evaluates a full field (cacheless
semantics), and the memoizing volume caches whole disparity planes.
"""

from __future__ import annotations

import torch

from ..core.types import MatchingFunction, MATCH_TRAITS, ExtractionStrategy
from ..core.search import SearchOffset1, SearchOffset2
from .cost_volume import normalize_feature_volume
from .matching import feature_comparison
from .unfold import unfold_offsets


def _bad(traits) -> float:
    """The cost of an invalid query: +inf for COST functions, -inf for
    SCORE ones."""
    return (float("inf") if traits.strategy is ExtractionStrategy.COST
            else float("-inf"))


class OnDemandFeaturesVolume:
    """Feature vectors from an arbitrary (di, dj[, c]) offset window
    (`on_demand_features_volume.h:35`), densely materialized."""

    def __init__(self, offsets, image, func: MatchingFunction | None = None):
        fv = unfold_offsets(offsets, image)
        if func is not None:
            fv = normalize_feature_volume(func, fv)
        self.features = fv

    def feature_vector(self, i: int, j: int):
        return self.features[i, j]


class CachelessOnDemandStereoCostVolume:
    """1-D (stereo) on-demand costs (`on_demand_cost_volume.h:615`)."""

    def __init__(self, func: MatchingFunction, source_fv, target_fv,
                 search: SearchOffset1):
        self.func = func
        self.source = source_fv
        self.target = target_fv
        self.search = search
        self.traits = MATCH_TRAITS[func]

    @property
    def shape(self):
        return tuple(self.source.shape[:2]) + (self.search.count,)

    def cost_field(self, disp: torch.Tensor) -> torch.Tensor:
        """Costs of an (H, W) disparity-candidate field (the batched
        query)."""
        H, W, F = self.target.shape
        tgt_j = torch.arange(W, device=disp.device)[None, :] + disp
        inb = ((tgt_j >= 0) & (tgt_j < W)
               & (disp >= self.search.lower) & (disp <= self.search.upper))
        tj = tgt_j.clamp(0, W - 1).long()[..., None].expand(H, W, F)
        c = feature_comparison(self.func, self.source,
                               torch.gather(self.target, 1, tj))
        return torch.where(inb, c, _bad(self.traits))

    def _in_range(self, pos, disp):
        """(i, j, d), or None outside the search range or image."""
        i, j = pos
        d = disp[0] if isinstance(disp, (tuple, list)) else int(disp)
        if not (self.search.lower <= d <= self.search.upper):
            return None
        if not (0 <= j + d < self.source.shape[1]):
            return None
        return i, j, d

    def cost_value(self, pos, disp):
        """Scalar access for API parity: None outside the search range or
        image (matching `costValue`'s empty optional; a +-inf sentinel
        would leak into reductions as a 'real' cost), else the evaluated
        candidate."""
        q = self._in_range(pos, disp)
        if q is None:
            return None
        i, j, d = q
        field = torch.full(tuple(self.source.shape[:2]), d,
                           dtype=torch.int32, device=self.source.device)
        return self.cost_field(field)[i, j]

    def truncated_cost_volume(self, disp: torch.Tensor, radius: int
                              ) -> torch.Tensor:
        """(H, W, 2r+1) window of costs around a disparity field
        (`on_demand_cost_volume.h:188`)."""
        return torch.stack([self.cost_field(disp + k)
                            for k in range(-radius, radius + 1)], -1)


class OnDemandStereoCostVolume(CachelessOnDemandStereoCostVolume):
    """Memoizing variant (`GenericOnDemandCostVolume`,
    `on_demand_cost_volume.h:37,105-181`): the reference lazily fills a
    dense volume one (pos, disp) scalar at a time behind a computed mask,
    so memory and compute grow with what was queried.  Here the memoization
    unit is a DISPARITY PLANE: the first access to a disparity d evaluates
    and caches its (H, W) cost plane; later accesses read the cache.
    Querying k distinct disparities costs k planes of memory and compute
    instead of the full (H, W, D) volume."""

    def __init__(self, func, source_fv, target_fv, search: SearchOffset1):
        super().__init__(func, source_fv, target_fv, search)
        self._planes: dict[int, torch.Tensor] = {}

    @property
    def n_computed_planes(self) -> int:
        return len(self._planes)

    def _plane(self, d: int) -> torch.Tensor:
        d = int(d)
        if d not in self._planes:
            field = torch.full(tuple(self.source.shape[:2]), d,
                               dtype=torch.int32, device=self.source.device)
            self._planes[d] = super().cost_field(field)
        return self._planes[d]

    def cost_value(self, pos, disp):
        """Scalar access (`costValue`, :105): None outside the search
        range or image, else the memoized cost."""
        q = self._in_range(pos, disp)
        if q is None:
            return None
        i, j, d = q
        return self._plane(d)[i, j]

    def cost_field(self, disp: torch.Tensor, memoize: bool = False
                   ) -> torch.Tensor:
        """(H, W) candidate-field query.  With ``memoize`` the distinct
        disparities in the field are evaluated as cached planes and the
        result read from them (touched planes stay warm for later
        queries); without it the field is evaluated directly."""
        if not memoize:
            return super().cost_field(disp)
        out = torch.full(disp.shape, _bad(self.traits), dtype=torch.float32,
                         device=disp.device)
        for d in torch.unique(disp).tolist():
            out = torch.where(disp == d, self._plane(d), out)
        return out

    def full_volume(self) -> torch.Tensor:
        from .cost_volume import aggregate_cost
        return aggregate_cost(self.func, self.target, self.source,
                              self.search)


class CachelessOnDemandImageFlowVolume:
    """2-D (flow) on-demand costs (`on_demand_cost_volume.h:620`)."""

    def __init__(self, func: MatchingFunction, source_fv, target_fv,
                 search: SearchOffset2):
        self.func = func
        self.source = source_fv
        self.target = target_fv
        self.search = search
        self.traits = MATCH_TRAITS[func]

    def cost_field(self, flow: torch.Tensor) -> torch.Tensor:
        """flow: (H, W, 2) of (di, dj) candidates."""
        H, W, _ = self.target.shape
        ii = torch.arange(H, device=flow.device)[:, None]
        jj = torch.arange(W, device=flow.device)[None, :]
        ti = ii + flow[..., 0]
        tj = jj + flow[..., 1]
        s = self.search
        inb = ((ti >= 0) & (ti < H) & (tj >= 0) & (tj < W)
               & (flow[..., 0] >= s.lower0) & (flow[..., 0] <= s.upper0)
               & (flow[..., 1] >= s.lower1) & (flow[..., 1] <= s.upper1))
        tgt = self.target[ti.clamp(0, H - 1).long(),
                          tj.clamp(0, W - 1).long()]
        c = feature_comparison(self.func, self.source, tgt)
        return torch.where(inb, c, _bad(self.traits))
