"""Reconstruction and language-model losses; counterpart of
tempo_tpu/ops/losses.py (the VAE's ``multiscale_mse`` and the LM's
``lm_cross_entropy``)."""

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


class _LMCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, targets):
        lse = torch.logsumexp(logits.float(), dim=-1)
        label = logits.gather(-1, targets[..., None])[..., 0].float()
        ctx.save_for_backward(logits, targets, lse)
        return (lse - label).mean()

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        p.scatter_add_(-1, targets[..., None],
                       torch.full_like(lse[..., None], -1.0))
        return (p * (g / targets.numel())).to(logits.dtype), None


def lm_cross_entropy(logits: torch.Tensor,
                     targets: torch.Tensor) -> torch.Tensor:
    """Mean next-token NLL over [..., T, V] logits and [..., T] int targets,
    as logsumexp(logits) - logits[target] with the reductions in fp32.
    The backward is tempo_tpu's custom VJP: it saves the compute-dtype
    logits and the fp32 logsumexp (never an fp32 [B, T, V] tensor) and
    returns (softmax - onehot) * g / N in the logits' type."""
    return _LMCrossEntropy.apply(logits, targets.long())
