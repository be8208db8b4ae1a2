"""Keypoint descriptors: BRIEF, whitened pixels, oriented variants
(counterpart of `libstevi_tpu/sparse/descriptors.py`).

Reference parity: `sparseMatching/pointsDescriptors.h` — sampling-pattern
generators (:76-208: random uniform pairs, dense windows, radial patterns),
`BriefDescriptor` (:244: comparison pairs rotated by the keypoint's main
direction, bit-packed into uint32 words), `WhitenedPixelsDescriptor` (:323:
window pixels standardized per keypoint) and the oriented variant (:401).

The pattern generators are the JAX package's numpy code (the same seeds
draw the same patterns).  Each descriptor is a batch of bilinear samples
of the image at keypoint + (rotated) offsets; the 2x2 rotation is written
out elementwise (no matmul, so no TF32 on a GPU).  BRIEF words are uint32
values held in int64, as the port's census words.  The standard
deviations are the population's, as `jnp.std`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..interpolation.interpolation import bilinear_sample


def random_sampling_pattern(n_pairs: int, radius: int,
                            seed: int = 0) -> np.ndarray:
    """(n_pairs, 2, 2) of (row, col) offsets, uniform in the window
    (`generateRandomComparisonPairs`, `pointsDescriptors.h:76`)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-radius, radius, (n_pairs, 2, 2)).astype(np.float32)


def dense_sampling_pattern(radius: int) -> np.ndarray:
    """All (2r+1)^2 window offsets, row-major (`pointsDescriptors.h:124`)."""
    d = np.arange(-radius, radius + 1)
    ii, jj = np.meshgrid(d, d, indexing="ij")
    return np.stack([ii.ravel(), jj.ravel()], -1).astype(np.float32)


def radial_sampling_pattern(n_rings: int, n_per_ring: int,
                            radius: float) -> np.ndarray:
    """Rings of samples at equal angular spacing (`pointsDescriptors.h:170`)."""
    offs = []
    for k in range(1, n_rings + 1):
        rad = radius * k / n_rings
        for a in range(n_per_ring):
            th = 2 * np.pi * a / n_per_ring
            offs.append((rad * np.sin(th), rad * np.cos(th)))
    return np.asarray(offs, np.float32)


def _rot(dirs: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [[c, s], [-s, c]] aligning the sampling frame with
    the keypoint direction; theta = atan2(d_row, d_col)
    (`pointsDescriptors.h:272`)."""
    theta = torch.atan2(dirs[:, 0], dirs[:, 1])
    c = torch.cos(theta)
    s = torch.sin(theta)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                       -2)


def _sample(img: torch.Tensor, coords: torch.Tensor, offsets: torch.Tensor,
            rot: torch.Tensor | None):
    """Bilinear samples at keypoint + (optionally rotated) offsets.
    coords (N, 2) float (row, col); offsets (M, 2); returns (N, M)."""
    x = img.float()
    if x.ndim == 3:
        x = x.mean(-1)
    offsets = torch.as_tensor(offsets, device=x.device)
    coords = coords.to(x.device).float()
    if rot is not None:
        offs = (rot[:, None, :, 0] * offsets[None, :, None, 0]
                + rot[:, None, :, 1] * offsets[None, :, None, 1])
    else:
        offs = offsets[None].expand((coords.shape[0],) + offsets.shape)
    return bilinear_sample(x, coords[:, None, :] + offs)


def _mean_std(s: torch.Tensor):
    """The mean and the population standard deviation (`jnp.std`: sqrt
    of the mean squared deviation; not `torch.std`'s default N - 1) over
    the last axis."""
    mean = s.mean(-1, keepdim=True)
    return mean, torch.sqrt(((s - mean) ** 2).mean(-1, keepdim=True))


def brief_descriptor(coords: torch.Tensor, img: torch.Tensor,
                     pairs: np.ndarray,
                     directions: torch.Tensor | None = None) -> torch.Tensor:
    """BRIEF bits: bit k = sample(pair_k[0]) < sample(pair_k[1]), packed into
    uint32 words (`BriefDescriptor`, `pointsDescriptors.h:244-321`).
    coords (N, 2) float (row, col); pairs (P, 2, 2).  Returns (N, ceil(P/32))
    uint32 values in int64."""
    pairs = torch.as_tensor(pairs, device=img.device)
    rot = _rot(directions) if directions is not None else None
    s0 = _sample(img, coords, pairs[:, 0, :], rot)
    s1 = _sample(img, coords, pairs[:, 1, :], rot)
    bits = (s0 < s1).long()                              # (N, P)
    N, P = bits.shape
    n_words = -(-P // 32)
    padded = torch.nn.functional.pad(bits, (0, n_words * 32 - P))
    weights = 2 ** torch.arange(32, device=bits.device)
    return (padded.view(N, n_words, 32) * weights).sum(-1)


def whitened_pixels_descriptor(coords: torch.Tensor, img: torch.Tensor,
                               radius: int = 3,
                               directions: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """Window pixels standardized per keypoint (zero mean, unit variance)
    (`WhitenedPixelsDescriptor`, `pointsDescriptors.h:323-399`)."""
    offsets = torch.from_numpy(dense_sampling_pattern(radius))
    rot = _rot(directions) if directions is not None else None
    s = _sample(img, coords, offsets, rot)
    mean, std = _mean_std(s)
    return (s - mean) / torch.where(std > 0, std, 1.0)


def oriented_whitened_pixels_descriptor(coords: torch.Tensor,
                                        img: torch.Tensor,
                                        directions: torch.Tensor,
                                        radius: int = 3) -> torch.Tensor:
    """(`OrientedWhitenedPixelsDescriptor`, `pointsDescriptors.h:401+`)."""
    return whitened_pixels_descriptor(coords, img, radius, directions)


def circular_fft_descriptor(coords: torch.Tensor, img: torch.Tensor,
                            n_rings: int = 4, n_per_ring: int = 16,
                            radius: float = 6.0) -> torch.Tensor:
    """Rotation-invariant circular-FFT amplitude descriptor
    (`pointsDescriptors.h:525`): sample each ring at uniform angles and keep
    the FFT magnitude per ring (rotation = circular shift = phase only), with
    per-ring mean/contrast normalization."""
    offsets = torch.from_numpy(radial_sampling_pattern(n_rings, n_per_ring,
                                                       radius))
    s = _sample(img, coords, offsets, None)       # (N, n_rings*n_per_ring)
    s = s.reshape(s.shape[0], n_rings, n_per_ring)
    mean, std = _mean_std(s)
    s = (s - mean) / torch.where(std > 1e-6, std, 1.0)
    amp = torch.fft.rfft(s, dim=-1).abs()         # (N, rings, n//2+1)
    return amp.reshape(amp.shape[0], -1)
