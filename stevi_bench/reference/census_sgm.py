"""Plain dense stereo with the census cost: census over (2v+1) x (2h+1)
windows, the Hamming distance, SGM along 4 or 8 scanline directions,
tie-last winner-takes-all, the 3-slot band around the winner and the
parabola subpixel step, in float32 PyTorch.

It is written from the definitions, not from the program, and imports
nothing of it (the SGM sum and the winner are those of `zncc_sgm`, which
the cost does not enter):

- Census.  A pixel's window is its (2v+1) x (2h+1) samples in row-major
  order over (dy, dx), with zeros outside the image.  Its census bits are
  b_k = [sample 0 > sample k] for k = 1 .. F - 1, where sample 0 is the
  window's first sample (its top-left corner), not its centre (LibStevi
  `correlation/census.h:70-131`).  Packed 32 to a word, a trailing partial
  word's unused bits are 0 in every pixel, so they never differ.
- Cost.  The source is the right image, the target the left one, shifted
  by d in [0, D): C(i, j, d) = the number of k where the source bit of
  (i, j) and the target bit of (i, j + d) differ, the target bits all 0
  where j + d >= W (the zero words of an out-of-range target).  The costs
  are integers in [0, F - 1]; the volume is stored in the configuration's
  dtype (``volume_dtype``) and read back as float32.
- SGM, winner and refinement as in `zncc_sgm`.

Shapes carry a batch axis: images (B, H, W), volumes (B, H, W, D).  The
volume is built a block of disparities at a time from the census bits held
as float32 0 / 1 planes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .zncc_sgm import sgm_sum, subpixel_winner

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}


def _shift(x: torch.Tensor, d: int) -> torch.Tensor:
    """x[..., j + d] along the last axis, 0 where j + d >= W."""
    return F.pad(x[..., d:], (0, d)) if d else x


def census_bits(x: torch.Tensor, h: int, v: int) -> torch.Tensor:
    """(B, F - 1, H, W) float32 census bits of (B, H, W) images."""
    B, H, W = x.shape
    p = F.pad(x.float(), (h, h, v, v))
    samples = [p[:, a:a + H, b:b + W] for a in range(2 * v + 1)
               for b in range(2 * h + 1)]
    if len(samples) < 2:
        raise ValueError("census: the window needs more than one sample")
    return torch.stack([(samples[0] > s).float() for s in samples[1:]], 1)


def cost_volume(left: torch.Tensor, right: torch.Tensor, D: int, h: int,
                v: int, volume_dtype=torch.float32,
                block: int = 16) -> torch.Tensor:
    """(B, H, W, D) float32 census (Hamming) volume, rounded once to
    ``volume_dtype``."""
    src, tgt = census_bits(right, h, v), census_bits(left, h, v)
    B, n_bits, H, W = src.shape
    vol = torch.empty((B, H, W, D), dtype=torch.float32, device=src.device)
    for d0 in range(0, D, block):
        ds = range(d0, min(D, d0 + block))
        cost = src.new_zeros((B, len(ds), H, W))
        for k in range(n_bits):
            t_d = torch.stack([_shift(tgt[:, k], d) for d in ds], 1)
            cost += (src[:, k, None] != t_d).float()
        vol[..., d0:d0 + len(ds)] = (cost.to(volume_dtype).float()
                                     .permute(0, 2, 3, 1))
    return vol


def disparity(left: torch.Tensor, right: torch.Tensor, config: dict,
              volume_dtype: str | None = None) -> torch.Tensor:
    """Refined disparities (B, H, W) float32 of gray pairs (B, H, W) under
    ``config`` (a configuration file's fields), the volume stored in
    ``volume_dtype`` (default: the configuration's)."""
    if config["matching"] != "census" or config["refine"] != "parabola" \
            or config["wta"] != "tie-last" or config["cost_vol_radius"] != 1:
        raise ValueError("census_sgm: census, tie-last WTA, a 3-slot band "
                         "and the parabola only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    h, v = config["h_radius"], config["v_radius"]
    dtype = DTYPES[volume_dtype or config["volume_dtype"]]
    C = cost_volume(left, right, config["disp_width"], h, v, dtype)
    S = sgm_sum(C, config["P1"], config["P2"], config["Pout"],
                config["n_directions"])
    del C
    return subpixel_winner(S, h, v)
