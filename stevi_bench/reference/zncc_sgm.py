"""Plain dense stereo: ZNCC over (2v+1) x (2h+1) windows, SGM along 4 or 8
scanline directions, tie-last winner-takes-all, the 3-slot band around the
winner and the parabola subpixel step, in float32 PyTorch.

It is written from the definitions, not from the program, and imports
nothing of it:

- Cost.  The source is the right image, the target the left one, shifted by
  d in [0, D): pixel (i, j) of the right view is matched with (i, j + d) of
  the left view.  Each pixel's feature is its window with zeros outside the
  image; the cost is minus the zero-mean normalized cross-correlation of the
  source window at j and the target window at j + d, 0 where either window
  has no variance and where j + d >= W.  The volume is stored in the
  configuration's dtype (``volume_dtype``) and read back as float32.
- SGM.  Along each direction r, L(p, d) = C(p, d) + min(L(p-r, d),
  L(p-r, d+-1) + P1, min_k L(p-r, k) + P2) + Pout[j + d >= W] -
  min_k L(p-r, k), with L = 0 before a line's first pixel.  The sum is
  S = C + sum_r (L_r - C).  LibStevi enumerates a diagonal direction's lines
  from both image edges that it starts on, so the line through the corner
  it starts from is walked twice and its L - C counts twice.
- Winner.  idx = the last d with S(p, d) = min_k S(p, k).  The refined
  disparity is idx + (c_-1 - c_1) / (2 (c_1 - 2 c_0 + c_-1)) over the band
  c_k = S(p, idx + k), and NaN where a band slot falls outside [0, D) or its
  source or target window leaves the image.

Shapes carry a batch axis: images (B, H, W), volumes (B, H, W, D).  The
volume is built a block of disparities at a time and the winner a block of
rows at a time, so a 1988 x 2632 x 640 pair needs two float32 volumes
(26.8 GB) and little more.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}

# (di, dj) a step: the four principal directions, then the four diagonals
DIRECTIONS = {4: [(1, 0), (-1, 0), (0, 1), (0, -1)]}
DIRECTIONS[8] = DIRECTIONS[4] + [(1, 1), (-1, -1), (1, -1), (-1, 1)]


def window_mean(x: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """Mean over the (2v+1) x (2h+1) window of each pixel of (N, H, W),
    zeros outside the image counted."""
    return F.avg_pool2d(x[:, None], (2 * v + 1, 2 * h + 1), stride=1,
                        padding=(v, h), count_include_pad=True)[:, 0]


def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[..., j + d] along the last axis, 0 where j + d >= W."""
    return F.pad(x[..., d:], (0, d)) if d else x


def cost_volume(left: torch.Tensor, right: torch.Tensor, D: int, h: int,
                v: int, volume_dtype=torch.float32,
                block: int = 16) -> torch.Tensor:
    """(B, H, W, D) float32 minus-ZNCC volume, rounded once to
    ``volume_dtype``."""
    s, t = right.float(), left.float()
    B, H, W = s.shape
    mean_s, mean_t = window_mean(s, h, v), window_mean(t, h, v)
    sd_s = torch.sqrt(torch.clamp(window_mean(s * s, h, v) - mean_s ** 2,
                                  min=0.0))
    sd_t = torch.sqrt(torch.clamp(window_mean(t * t, h, v) - mean_t ** 2,
                                  min=0.0))
    vol = torch.empty((B, H, W, D), dtype=torch.float32, device=s.device)
    cols = torch.arange(W, device=s.device)
    for d0 in range(0, D, block):
        ds = range(d0, min(D, d0 + block))
        t_d = torch.stack([_shift(t, d) for d in ds], 1)       # (B, n, H, W)
        cross = window_mean((s[:, None] * t_d).flatten(0, 1), h, v)
        cross = cross.view(B, len(ds), H, W)
        mt_d = torch.stack([_shift(mean_t, d) for d in ds], 1)
        sdt_d = torch.stack([_shift(sd_t, d) for d in ds], 1)
        den = sd_s[:, None] * sdt_d
        zncc = torch.where(den > 0, (cross - mean_s[:, None] * mt_d)
                           / torch.where(den > 0, den, 1.0), 0.0)
        inside = (cols + torch.tensor(list(ds), device=s.device)[:, None, None]
                  < W)                                         # (n, 1, W)
        cost = torch.where(inside, -zncc, 0.0)
        vol[..., d0:d0 + len(ds)] = (cost.to(volume_dtype).float()
                                     .permute(0, 2, 3, 1))
    return vol


def _step(prev, cost, pout, P1, P2):
    """One step along a line: (L, L - C) at the next pixel from the
    previous pixel's L ``prev`` (..., D)."""
    m = prev.amin(-1, keepdim=True)
    agg = torch.minimum(prev, m + P2)
    agg[..., 1:] = torch.minimum(agg[..., 1:], prev[..., :-1] + P1)
    agg[..., :-1] = torch.minimum(agg[..., :-1], prev[..., 1:] + P1)
    adj = agg + pout - m
    return cost + adj, adj


def _add_direction(C, S, di, dj, P1, P2, Pout):
    """S += L_r - C for the direction (di, dj) over (B, H, W, D) volumes."""
    B, H, W, D = C.shape
    out = (torch.arange(W, device=C.device)[:, None]
           + torch.arange(D, device=C.device) >= W)            # (W, D)
    pout = torch.where(out, Pout, 0.0)
    if di == 0:                                                # along rows
        prev = C.new_zeros((B, H, D))
        for j in (range(W) if dj > 0 else range(W - 1, -1, -1)):
            prev, adj = _step(prev, C[:, :, j], pout[j], P1, P2)
            S[:, :, j] += adj
        return
    prev = C.new_zeros((B, W, D))
    zero = C.new_zeros((B, 1, D))
    for k, i in enumerate(range(H) if di > 0 else range(H - 1, -1, -1)):
        if dj > 0:        # (i, j) follows (i - di, j - 1); column 0 starts
            prev = torch.cat([zero, prev[:, :-1]], 1)
        elif dj < 0:      # (i, j) follows (i - di, j + 1); column W-1 starts
            prev = torch.cat([prev[:, 1:], zero], 1)
        prev, adj = _step(prev, C[:, i], pout, P1, P2)
        S[:, i] += adj
        if dj:            # the corner line, walked from both start edges
            c = (0 if dj > 0 else W - 1) + dj * k
            if 0 <= c < W:
                S[:, i, c] += adj[:, c]


def sgm_sum(C: torch.Tensor, P1: float, P2: float, Pout: float,
            n_directions: int = 8) -> torch.Tensor:
    """S = C + sum over the directions of (L_r - C)."""
    S = C.clone()
    for di, dj in DIRECTIONS[n_directions]:
        _add_direction(C, S, di, dj, float(P1), float(P2), float(Pout))
    return S


def subpixel_winner(S: torch.Tensor, h: int, v: int,
                    rows: int = 32) -> torch.Tensor:
    """(B, H, W) float32 refined disparity of a summed volume, NaN where
    the band leaves the volume or the image."""
    B, H, W, D = S.shape
    out = torch.empty((B, H, W), dtype=torch.float32, device=S.device)
    ar = torch.arange(D, device=S.device)
    jj = torch.arange(W, device=S.device)
    for i0 in range(0, H, rows):
        blk = S[:, i0:i0 + rows]
        best = blk.amin(-1, keepdim=True)
        idx = torch.where(blk == best, ar, -1).amax(-1)        # tie: last
        c0 = best[..., 0]
        cm1 = torch.gather(blk, -1, (idx - 1).clamp(min=0)[..., None])[..., 0]
        c1 = torch.gather(blk, -1, (idx + 1).clamp(max=D - 1)[..., None])[..., 0]
        ii = torch.arange(i0, i0 + blk.shape[1], device=S.device)[:, None]
        ok = ((idx >= 1) & (idx + 1 < D) & (jj >= h) & (jj + idx + 1 + h < W)
              & (ii >= v) & (ii + v < H))
        disp = idx.float() + (cm1 - c1) / (2 * (c1 - 2 * c0 + cm1))
        out[:, i0:i0 + blk.shape[1]] = torch.where(ok, disp, float("nan"))
    return out


def disparity(left: torch.Tensor, right: torch.Tensor, config: dict,
              volume_dtype: str | None = None) -> torch.Tensor:
    """Refined disparities (B, H, W) float32 of gray pairs (B, H, W) under
    ``config`` (a configuration file's fields), the volume stored in
    ``volume_dtype`` (default: the configuration's)."""
    if config["matching"] != "zncc" or config["refine"] != "parabola" \
            or config["wta"] != "tie-last" or config["cost_vol_radius"] != 1:
        raise ValueError("zncc_sgm: ZNCC, tie-last WTA, a 3-slot band and "
                         "the parabola only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, v = config["h_radius"], config["v_radius"]
    dtype = DTYPES[volume_dtype or config["volume_dtype"]]
    C = cost_volume(left, right, config["disp_width"], h, v, dtype)
    S = sgm_sum(C, config["P1"], config["P2"], config["Pout"],
                config["n_directions"])
    del C
    return subpixel_winner(S, h, v)
