"""Histograms and automatic thresholds (counterpart of
`libstevi_tpu/imageproc/histogram.py`).

Reference parity: `imageProcessing/histogram.h:31` (`Histogram<T>`),
`foregroundSegmentation.h:51` (`computeOtsuThreshold`) and the
balanced-histogram threshold.  Counts are an integer `bincount` (exact);
the bin edges are `jnp.linspace`'s formula, start (1 - t) + stop t.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Histogram:
    counts: torch.Tensor
    edges: torch.Tensor

    @classmethod
    def compute(cls, data: torch.Tensor, n_bins: int = 256,
                vmin: float | None = None, vmax: float | None = None):
        x = data.float().ravel()
        lo = x.min() if vmin is None else torch.tensor(float(vmin),
                                                       device=x.device)
        hi = x.max() if vmax is None else torch.tensor(float(vmax),
                                                       device=x.device)
        t = torch.arange(n_bins, dtype=torch.float32, device=x.device) \
            / torch.tensor(float(n_bins), device=x.device)
        edges = torch.cat([lo * (1 - t) + hi * t, hi[None]])
        idx = torch.clip(((x - lo) / torch.clamp(hi - lo, min=1e-12)
                          * n_bins).to(torch.int32), 0, n_bins - 1)
        counts = torch.bincount(idx, minlength=n_bins).to(torch.int32)
        return cls(counts, edges)

    @property
    def centers(self) -> torch.Tensor:
        return (self.edges[:-1] + self.edges[1:]) / 2.0

    def entropy(self) -> torch.Tensor:
        """Shannon entropy of the bin distribution in nats.  The
        reference's `Histogram::entropy` (`histogram.h:321-330`) returns
        the sum of SQUARED bin counts — a collision count, not an
        entropy; this computes the documented intent."""
        c = self.counts.float()
        p = c / torch.clamp(c.sum(), min=1.0)
        return -torch.where(p > 0, p * torch.log(p), 0.0).sum()


def otsu_threshold(data: torch.Tensor, n_bins: int = 256) -> torch.Tensor:
    """Threshold maximizing between-class variance (`computeOtsuThreshold`,
    `foregroundSegmentation.h:51`)."""
    h = Histogram.compute(data, n_bins)
    counts = h.counts.float()
    centers = h.centers
    total = counts.sum()
    w0 = torch.cumsum(counts, 0)
    w1 = total - w0
    m0 = torch.cumsum(counts * centers, 0) / torch.clamp(w0, min=1e-12)
    m_total = (counts * centers).sum() / total
    m1 = (m_total * total - torch.cumsum(counts * centers, 0)) \
        / torch.clamp(w1, min=1e-12)
    between = w0 * w1 * (m0 - m1) ** 2
    between = torch.where((w0 > 0) & (w1 > 0), between, -float("inf"))
    return centers[torch.argmax(between)]


def balanced_histogram_threshold(data: torch.Tensor, n_bins: int = 256
                                 ) -> torch.Tensor:
    """Balanced histogram thresholding: the bin where the cumulative mass
    reaches half the total."""
    h = Histogram.compute(data, n_bins)
    cum = torch.cumsum(h.counts.float(), 0)
    idx = torch.argmax((cum >= cum[-1] / 2.0).to(torch.uint8))
    return h.centers[idx]
