"""Diagonal Gaussian posterior for the KL-VAE latent.

Counterpart of tempo_tpu/nn/distributions.py: parameters [B, H, W, 2*Z]
split into mean / logvar on the channel axis, both fp32, logvar clamped to
[-30, 20]; KL is the standard-normal KL summed over latent dims per sample.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor    # [B, H, W, Z] fp32
    logvar: torch.Tensor  # [B, H, W, Z] fp32, already clamped

    @classmethod
    def from_params(cls, parameters: torch.Tensor) -> "DiagonalGaussian":
        mean, logvar = torch.chunk(parameters, 2, dim=-1)
        logvar = torch.clamp(logvar.float(), -30.0, 20.0)
        return cls(mean=mean.float(), logvar=logvar)

    @property
    def std(self) -> torch.Tensor:
        return torch.exp(0.5 * self.logvar)

    @property
    def var(self) -> torch.Tensor:
        return torch.exp(self.logvar)

    def sample(self, generator: Optional[torch.Generator] = None
               ) -> torch.Tensor:
        noise = torch.randn(self.mean.shape, generator=generator,
                            dtype=self.mean.dtype, device=self.mean.device)
        return self.mean + self.std * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        """KL(q || N(0, I)) summed over latent dims -> [B]."""
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(
            self.mean.square() + self.var - 1.0 - self.logvar, dim=dims)

    def nll(self, sample: torch.Tensor) -> torch.Tensor:
        """Negative log likelihood of ``sample`` -> [B]."""
        dims = tuple(range(1, self.mean.ndim))
        return 0.5 * torch.sum(
            math.log(2.0 * math.pi) + self.logvar
            + (sample - self.mean).square() / self.var, dim=dims)
