"""The comparison that decides ``correct``: the program's refined
disparities against the plain reference's, answer by answer.

Two numbers are compared, over every pixel of every answer checked:

- ``mismatch_share``: the share of pixels where the two disagree, that is
  where one is NaN and the other is not, or both are numbers more than half
  a pixel apart (a different winner);
- ``subpixel_gap_px``: the mean absolute gap, in pixels, between the two
  where both are numbers within half a pixel of each other (the same
  winner refined by the parabola).

Each has its limit in the configuration file (``check.limits``); a run is
correct where neither exceeds its limit.
"""

from __future__ import annotations

import math

import torch

NAMES = ("mismatch_share", "subpixel_gap_px")


def compare(program, reference) -> dict:
    """The two numbers over pairs of (H, W) float32 disparity maps."""
    pixels = bad = close = 0
    gap = 0.0
    for p, r in zip(program, reference, strict=True):
        p, r = p.float().cpu(), r.float().cpu()
        nan_p, nan_r = p.isnan(), r.isnan()
        both = ~nan_p & ~nan_r
        diff = torch.where(both, (p - r).abs(), 0.0)
        near = both & (diff <= 0.5)
        pixels += p.numel()
        bad += int(((nan_p != nan_r) | (both & (diff > 0.5))).sum())
        close += int(near.sum())
        gap += float(diff[near].double().sum())
    return {"mismatch_share": bad / max(pixels, 1),
            "subpixel_gap_px": gap / close if close else math.inf}


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every number
    is at most its limit."""
    checks = {n: {"value": numbers[n], "limit": limits[n]} for n in NAMES}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
