"""Reconstruction losses; counterpart of tempo_tpu/ops/losses.py (the VAE's
``multiscale_mse``)."""

from __future__ import annotations

import torch


def multiscale_mse(x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
    """x, recon: [B, H, W, C] -> error map [B, H, W, C] in k-space:
    |FFT(x) - FFT(recon)|^2 / (1 + |k|), orthonormal 2-D FFT over H, W."""
    fx = torch.fft.fft2(x.float(), dim=(1, 2), norm="ortho")
    fr = torch.fft.fft2(recon.float(), dim=(1, 2), norm="ortho")
    h, w = x.shape[1], x.shape[2]
    ky = torch.fft.fftfreq(h, device=x.device)[:, None] * h
    kx = torch.fft.fftfreq(w, device=x.device)[None, :] * w
    weight = 1.0 / (1.0 + torch.sqrt(ky ** 2 + kx ** 2))
    return (fx - fr).abs().square() * weight[None, :, :, None]
