"""Color space conversions (counterpart of
`libstevi_tpu/imageproc/color.py`).

Reference parity: `imageProcessing/colorConversions.h:36-496` — linear<->log,
RGB<->HSV/HSI, YUV->RGB, BGR<->RGB, grayscale, channel normalization and
the packed 4:2:2 decoders.  All functions operate on (..., C) float tensors
in [0, 1] unless noted; elementwise torch ops.
"""

from __future__ import annotations

import math

import torch


def linear_to_log(img: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.log(img.float() + eps)


def log_to_linear(img: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.exp(img.float()) - eps


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    x = img.float()
    return x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114


def bgr_to_rgb(img: torch.Tensor) -> torch.Tensor:
    return img.flip(-1)


def rgb_to_hsv(img: torch.Tensor) -> torch.Tensor:
    x = img.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = x.amax(-1)
    mn = x.amin(-1)
    d = mx - mn
    safe_d = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, ((g - b) / safe_d) % 6.0,
                    torch.where(mx == g, (b - r) / safe_d + 2.0,
                                (r - g) / safe_d + 4.0))
    h = torch.where(d > 0, h * 60.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return torch.stack([h, s, mx], -1)


def _select(conds, choices, default):
    """`jnp.select`: the first true condition's choice, else ``default``."""
    out = default
    for c, v in zip(reversed(conds), reversed(choices)):
        out = torch.where(c, v, out)
    return out


def hsv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    h, s, v = img[..., 0], img[..., 1], img[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(hp % 2.0 - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    sect = torch.floor(hp).to(torch.int32) % 6
    conds = [sect == k for k in range(5)]
    r = _select(conds, [c, x, z, z, x], c)
    g = _select(conds, [x, c, c, x, z], z)
    b = _select(conds, [z, z, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], -1)


def rgb_to_hsi(img: torch.Tensor) -> torch.Tensor:
    """Hue / saturation / intensity (`colorConversions.h` HSI variant)."""
    x = img.float()
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    i = (r + g + b) / 3.0
    mn = x.amin(-1)
    s = torch.where(i > 0, 1.0 - mn / torch.where(i > 0, i, 1.0), 0.0)
    num = 0.5 * ((r - g) + (r - b))
    den = torch.sqrt((r - g) ** 2 + (r - b) * (g - b))
    theta = torch.arccos(torch.clip(num / torch.where(den > 0, den, 1.0),
                                    -1, 1))
    h = torch.where(b <= g, theta, 2 * math.pi - theta)
    h = torch.rad2deg(torch.where(den > 0, h, 0.0))
    return torch.stack([h, s, i], -1)


def yuv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """BT.601 full-range YUV -> RGB (`colorConversions.h` YUV paths)."""
    y, u, v = img[..., 0], img[..., 1] - 0.5, img[..., 2] - 0.5
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return torch.stack([r, g, b], -1)


def normalize_channels(img: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Per-pixel channel normalization x / sum(x)
    (`colorConversions.h` channel normalization)."""
    s = img.float().sum(-1, keepdim=True)
    return img / torch.where(torch.abs(s) > eps, s, 1.0)


def _packed_422_to_rgb(img: torch.Tensor, u_even: bool) -> torch.Tensor:
    """Shared YUYV/YVYU 4:2:2 decode (`colorConversions.h:334-457`): the
    chroma channel alternates per column; each pixel uses the most recent
    sample of each chroma (the reference's running U/V update), with the
    row-start V (resp. U) seeded from column 1.  Float path with the
    reference's +-1000 clamps; data is 0-255 scaled like the reference."""
    x = img.float()
    H, W, C = x.shape
    if C != 2 or W < 2:
        raise ValueError("packed 4:2:2 image must be (H, W, 2) with W >= 2")
    y = x[..., 0]
    ch = x[..., 1]
    jj = torch.arange(W, device=x.device)
    even_idx = jj - jj % 2                       # latest even column <= j
    odd_idx = torch.where(jj == 0, 1, jj - (1 - jj % 2))  # latest odd <= j
    u = ch[:, even_idx if u_even else odd_idx]
    v = ch[:, odd_idx if u_even else even_idx]
    r = y + 1.370705 * (v - 128.0)
    g = y - 0.698001 * (v - 128.0) - 0.337633 * (u - 128.0)
    b = y + 1.732446 * (u - 128.0)
    return torch.clip(torch.stack([r, g, b], -1), -1000.0, 1000.0)


def yuyv_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 2) YUYV-packed 4:2:2 -> (H, W, 3) RGB
    (`yuyv2rgb`, `colorConversions.h:334`)."""
    return _packed_422_to_rgb(img, u_even=True)


def yvyu_to_rgb(img: torch.Tensor) -> torch.Tensor:
    """(H, W, 2) YVYU-packed 4:2:2 -> (H, W, 3) RGB
    (`yvyu2rgb`, `colorConversions.h:396`)."""
    return _packed_422_to_rgb(img, u_even=False)
