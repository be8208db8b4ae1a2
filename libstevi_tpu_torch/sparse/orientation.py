"""Keypoint orientation by intensity centroid (counterpart of
`libstevi_tpu/sparse/orientation.py`).

Reference parity: `sparseMatching/pointsOrientation.h:58-146` —
`intensityOrientedCoordinates`: the main direction of a keypoint is the
normalized intensity-weighted centroid of the (2r+1)^2 window offsets
(out-of-image samples weigh 0; multichannel images sum over channels).

Batched over keypoints: one gather of every window from the zero-padded
image.  The window's start is taken as `lax.dynamic_slice` takes it in the JAX
package: a negative start counts from the end of the padded axis, and the
start is clamped so that the window fits, so a keypoint near or past the
border reads a window inside the padded image.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def intensity_oriented_coordinates(coords: torch.Tensor, img: torch.Tensor,
                                   search_radius: int = 3) -> torch.Tensor:
    """coords: (N, 2) int (row, col).  Returns (N, 2) unit direction vectors
    (d_row, d_col)."""
    r = search_radius
    x = img.float()
    if x.ndim == 3:
        x = x.sum(-1)
    H, W = x.shape
    pad = F.pad(x, (r, r, r, r))  # zero pad == out-of-image weight 0
    c = coords.to(x.device).long()
    # `lax.dynamic_slice`'s start: a negative one counts from the end of
    # the padded axis, then it is clamped so the window fits
    c = torch.where(c < 0, c + torch.tensor([H + 2 * r, W + 2 * r],
                                            device=x.device), c)
    offs = torch.arange(0, 2 * r + 1, device=x.device)
    i = c[:, 0].clamp(0, H - 1)[:, None, None] + offs[None, :, None]
    j = c[:, 1].clamp(0, W - 1)[:, None, None] + offs[None, None, :]
    win = pad[i, j]                                   # (N, n, n)
    w = (offs - r).float()
    v = torch.stack([(win * w[:, None]).sum((1, 2)),
                     (win * w[None, :]).sum((1, 2))], -1)
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.where(n > 0, n, 1.0)
