"""Fourier transforms (counterpart of `libstevi_tpu/imageproc/fourier.py`).

Reference parity: `imageProcessing/fourierTransform.h:33` —
`FourierTransformCalculator`, an FFTW wrapper with forward/backward 2-D
transforms.  Here `torch.fft` (complex64 for float32 images) replaces
FFTW, as `jnp.fft` does in the JAX package.
"""

from __future__ import annotations

import torch


class FourierTransformCalculator:
    """API-parity wrapper over torch.fft for 2-D images."""

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        return torch.fft.fft2(img.to(torch.complex64))

    def backward(self, freq: torch.Tensor) -> torch.Tensor:
        return torch.fft.ifft2(freq)

    def forward_real(self, img: torch.Tensor) -> torch.Tensor:
        return torch.fft.rfft2(img.float())

    def backward_real(self, freq: torch.Tensor, shape=None) -> torch.Tensor:
        return torch.fft.irfft2(freq, s=shape)

    @staticmethod
    def amplitude(freq: torch.Tensor) -> torch.Tensor:
        return torch.abs(freq)

    @staticmethod
    def phase(freq: torch.Tensor) -> torch.Tensor:
        return torch.angle(freq)
