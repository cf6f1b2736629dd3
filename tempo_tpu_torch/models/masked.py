"""Masked-autoencoder training wrapper; counterpart of
tempo_tpu/models/masked.py with the same semantics.

``x`` is [B, T, C] token-major. A (B, T) mask zeroes whole tokens; with
``mask_channels`` only the flagged channels are zeroed; with
``input_mask`` the token mask is appended as an extra input channel and
stripped from the prediction. The masked MSE is computed densely, as
sum(mask * (x - x_pred)^2) / sum(mask), which equals the MSE over the
masked elements.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch


def random_token_masks(generator: torch.Generator, batch_size: int,
                       seq_len: int, mask_frac: float) -> torch.Tensor:
    """iid Bernoulli(mask_frac) token masks, [B, T] bool, drawn from
    ``generator`` on its device."""
    return torch.rand((batch_size, seq_len), generator=generator,
                      device=generator.device) < mask_frac


class MaskedEncoder:
    """Wraps any ``net(x) -> x_pred`` with masked-reconstruction
    training."""

    def __init__(self, net: Callable[[torch.Tensor], torch.Tensor],
                 mask_channels: Optional[Sequence[bool]] = None,
                 input_mask: bool = False):
        self.net = net
        self.mask_channels = (None if mask_channels is None
                              else torch.as_tensor(mask_channels,
                                                   dtype=torch.bool))
        self.input_mask = input_mask

    def _expand(self, masks: torch.Tensor) -> torch.Tensor:
        """(B, T) token mask -> the element mask (B, T, C) or (B, T, 1)."""
        if self.mask_channels is not None:
            channels = self.mask_channels.to(masks.device)
            return masks[:, :, None] & channels[None, None, :]
        return masks[:, :, None]

    def get_masked_x(self, x: torch.Tensor, masks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zero the masked elements; with ``input_mask`` append the token
        mask as an input channel. Returns (x_masked, element mask)."""
        el = self._expand(masks)
        x_masked = torch.where(el, torch.zeros((), dtype=x.dtype,
                                               device=x.device), x)
        if self.input_mask:
            x_masked = torch.cat([x_masked, masks[:, :, None].to(x.dtype)],
                                 dim=-1)
        return x_masked, el

    def get_loss(self, x: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """MSE over the masked elements only, computed densely."""
        x_masked, el = self.get_masked_x(x, masks)
        x_pred = self.net(x_masked)
        if self.input_mask:
            x_pred = x_pred[..., : x.shape[-1]]
        el_f = torch.broadcast_to(el, x.shape).float()
        sq = (x_pred.float() - x.float()).square()
        return torch.sum(sq * el_f) / torch.clamp(torch.sum(el_f), min=1.0)
