"""L0-regularized approximation (counterpart of `libstevi_tpu/optim/l0.py`).

Reference parity: `optimization/l0optimization.h` (305 LoC) — L0-gradient
approximation used by the intrinsic-image decomposition
(`intrinsicImageDecomposition.h:60`).

Documented deviation, kept from the JAX package: the reference uses a
sequential region-fusion scheme; here the same objective
``min_S ||S - I||^2 + lam * ||grad S||_0`` is solved with the half-quadratic
splitting of Xu et al. (alternating hard-threshold gradient step + FFT
Poisson solve).  The JAX package's `while_loop` over beta becomes a Python
loop over a beta schedule computed on the host in float32 (2 lam, times
kappa, while below beta_max: the same count and values), so no iteration
syncs with the device.
"""

from __future__ import annotations

import numpy as np
import torch


def beta_schedule(lam: float, kappa: float, beta_max: float) -> list:
    """The float32 betas of the JAX package's loop, in order."""
    beta, k = np.float32(2.0 * lam), np.float32(kappa)
    top = np.float32(beta_max)
    out = []
    while beta < top:
        out.append(beta)
        beta = np.float32(beta * k)
    return out


def l0_smoothing(image: torch.Tensor, lam: float = 0.02,
                 kappa: float = 2.0, beta_max: float = 1e5) -> torch.Tensor:
    """L0 gradient minimization of a (H, W) or (H, W, C) image."""
    x = image.float()
    chan = x.ndim == 3
    if not chan:
        x = x[..., None]
    H, W, C = x.shape

    # optical-transfer functions of the forward-difference operators
    fx = torch.zeros((H, W), dtype=torch.complex64, device=x.device)
    fy = torch.zeros((H, W), dtype=torch.complex64, device=x.device)
    fx[0, 0], fx[0, W - 1] = -1, 1
    fy[0, 0], fy[H - 1, 0] = -1, 1
    otf_x = torch.fft.fft2(fx)
    otf_y = torch.fft.fft2(fy)
    denom_grad = (torch.abs(otf_x) ** 2 + torch.abs(otf_y) ** 2)[..., None]
    F_I = torch.fft.fft2(x, dim=(0, 1))
    cx, cy = torch.conj(otf_x)[..., None], torch.conj(otf_y)[..., None]

    S = x
    for beta in beta_schedule(lam, kappa, beta_max):
        gx = torch.roll(S, -1, 1) - S
        gy = torch.roll(S, -1, 0) - S
        # Xu et al. threshold the CHANNEL-SUMMED gradient magnitude
        # jointly (per-channel decisions erase color edges whose channels
        # are individually weak)
        mag = (gx * gx + gy * gy).sum(-1, keepdim=True)
        keep = mag >= float(np.float32(lam) / beta)
        hx = torch.where(keep, gx, 0.0)
        hy = torch.where(keep, gy, 0.0)
        # S = F^-1[ (F(I) + beta (F(dx)* F(h) + ...)) / (1 + beta |F(d)|^2) ]
        F_h = (cx * torch.fft.fft2(hx, dim=(0, 1))
               + cy * torch.fft.fft2(hy, dim=(0, 1)))
        b = float(beta)
        F_S = (F_I + b * F_h) / (1.0 + b * denom_grad)
        S = torch.real(torch.fft.ifft2(F_S, dim=(0, 1)))
    return S if chan else S[..., 0]


def l0_approximation(image: torch.Tensor, lam: float = 0.02) -> torch.Tensor:
    """Reference-named entry (`l0optimization.h`)."""
    return l0_smoothing(image, lam)
