"""Isotropic power spectra and spectrum matching on tensors; counterpart of
tempo_tpu/analysis/spectrum.py, with its math:

- radial binning |k| -> floor(|k| + 0.5) over the fftfreq grid;
- the binning operator a dense (pk_len, N^dim) matrix applied as one matmul
  (at analysis sizes it is tiny);
- ``get_pk``: the mean squared Fourier amplitude per radial bin;
- ``pk_rescale``: each Fourier mode times sqrt(target_pk / pk) of its bin
  (a half-spectrum rfft scatter, then irfft).

The operator is built once in numpy and put on ``device`` (None: CUDA).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device


class PkOp(NamedTuple):
    """Radial-binning operator for an N^dim grid.

    ks:     [pk_len] mean |k| of each radial bin (fp32).
    weight: [pk_len, N^dim] row-normalized membership (1/count_i where mode
            j falls in bin i): ``get_pk``'s averaging.
    member: [pk_len, N^dim] 0/1 membership: ``pk_rescale``'s scatter back.
    """

    ks: torch.Tensor
    weight: torch.Tensor
    member: torch.Tensor
    n: int
    dim: int


def pk_op(n: int, dim: int, device=None) -> PkOp:
    """The radial binning operator of an N^dim grid, on ``device``."""
    if dim not in (2, 3):
        raise ValueError("dim must be 2 or 3")
    if n % 2 != 0:
        raise ValueError("N must be even")
    dev = resolve_device(device)
    k_arr = np.fft.fftfreq(n, 1.0 / n)
    grids = np.meshgrid(*([k_arr] * dim), indexing="ij")
    k_abs = np.sqrt(sum(g ** 2 for g in grids))
    pk_len = int(k_abs.max() + 0.5) + 1
    pkind = np.floor(k_abs + 0.5).reshape(-1).astype(np.int64)

    member = np.zeros((pk_len, n ** dim), np.float32)
    member[pkind, np.arange(n ** dim)] = 1.0
    counts = member.sum(axis=1)
    weight = member / counts[:, None]
    k_flat = k_abs.reshape(-1)
    ks = np.array([k_flat[pkind == i].mean() for i in range(pk_len)])
    return PkOp(torch.as_tensor(ks, dtype=torch.float32, device=dev),
                torch.as_tensor(weight, device=dev),
                torch.as_tensor(member, device=dev), n, dim)


def get_pk(images: torch.Tensor, op: PkOp) -> torch.Tensor:
    """Mean |FFT|^2 per radial bin. images: [B, H, W(, D), C] channel-last;
    returns [B, C, pk_len] fp32."""
    spatial = tuple(range(1, 1 + op.dim))
    images_k = torch.fft.fftn(images, dim=spatial)
    power = (images_k.real ** 2 + images_k.imag ** 2).float()
    b, c = images.shape[0], images.shape[-1]
    flat = torch.movedim(power, -1, 1).reshape(b * c, -1)
    return (flat @ op.weight.T).reshape(b, c, -1)


def pk_rescale(images: torch.Tensor, pks: torch.Tensor,
               target_pks: torch.Tensor, op: PkOp) -> torch.Tensor:
    """Rescale each Fourier mode so the radial spectrum matches target_pks;
    2D only. images: [B, H, W, C]; pks/target_pks: [B, C, pk_len].
    Zero-power bins are zeroed rather than amplified, and the factor grid's
    channel 0, row 0 is zeroed, as the JAX package does (the reference's
    DC-suppression line, kept for parity)."""
    if op.dim != 2:
        raise NotImplementedError("3D not implemented (as in the reference)")
    n = op.n
    b, c = images.shape[0], images.shape[-1]
    fac = torch.where(pks > 0, torch.sqrt(target_pks / pks),
                      torch.zeros_like(pks))
    rescaler = (fac.reshape(b * c, -1) @ op.member).reshape(b, c, n, n)
    rescaler[:, 0, 0] = 0.0
    rescaler = rescaler[..., : n // 2 + 1]

    x = torch.movedim(images, -1, 1)
    x_k = torch.fft.rfftn(x, dim=(2, 3))
    x_r = torch.fft.irfftn(x_k * rescaler, dim=(2, 3), s=(n, n))
    return torch.movedim(x_r, 1, -1).to(images.dtype)
