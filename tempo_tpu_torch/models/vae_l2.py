"""VAE with multi-task L2 atmospheric-product supervision; counterpart of
tempo_tpu/models/vae_l2.py.

- L2PredictionHead: a 1x1-conv MLP latent -> 512 -> 512 -> 4, each hidden
  layer a bias-free dense, then GroupNorm(8, eps 1e-5) + GELU through K1
  (ops/norms.py ``group_norm_act``), and a biased output dense.
- Loss: the base VAE loss from one posterior sample, plus the NaN-masked
  MSE of each product between the head's predictions from a SECOND,
  independent posterior sample (the reference's quirk, kept: the head does
  not see the decoded z) and the 4x average-pooled targets. NaN propagates
  through the pooling (torch AvgPool2d semantics): a 4x4 block with any NaN
  gives a NaN target, which the mask drops before the square, so no NaN
  reaches a gradient.

Modules carry the reference VAEWithL2Supervision's names (``vae.*``,
``l2_head.mlp.{0,1,3,4,6}``), so its state_dicts load as they are and
tempo_tpu/interop/torch_ckpt.py ``l2_params_from_torch_state_dict`` reads
the port's. The head computes in the model's compute type; its output goes
to fp32 before the losses.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig, vae_loss
from tempo_tpu_torch.nn.blocks import Dense, GroupNorm, init_weights
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.ops.norms import group_norm_act

L2_PRODUCTS: Tuple[str, ...] = ("NO2", "O3TOT", "HCHO", "CLDO4")
DEFAULT_L2_WEIGHTS: Dict[str, float] = {p: 0.1 for p in L2_PRODUCTS}
HEAD_GROUPS, HEAD_EPS = 8, 1e-5


class L2PredictionHead(nn.Module):
    """[B, Hl, Wl, latent] -> [B, Hl, Wl, n_outputs]; ``mlp`` is the
    reference's Sequential of (dense, GroupNorm, GELU) per hidden width and
    the output dense."""

    def __init__(self, latent_channels: int,
                 hidden_dims: Sequence[int] = (512, 512),
                 n_outputs: int = len(L2_PRODUCTS),
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        layers, cin = [], latent_channels
        for hidden in hidden_dims:
            layers += [Dense(cin, hidden, compute_dtype, bias=False),
                       GroupNorm(HEAD_GROUPS, hidden, HEAD_EPS), nn.GELU()]
            cin = hidden
        layers.append(Dense(cin, n_outputs, compute_dtype))
        self.mlp = nn.Sequential(*layers)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = z.to(self.compute_dtype)
        for i in range(0, len(self.mlp) - 1, 3):
            norm = self.mlp[i + 1]
            h = group_norm_act(self.mlp[i](h), norm.num_groups, norm.weight,
                               norm.bias, norm.eps, act_name="gelu")
        return self.mlp[-1](h)


class VAEWithL2Head(nn.Module):
    """The base VAE and one 4-product prediction head on the sampled
    latent, built on ``device`` (None means CUDA); the VAE's weights from a
    generator seeded with ``seed``, the head's with ``seed + 1``."""

    def __init__(self, config: VAEConfig,
                 mlp_hidden: Sequence[int] = (512, 512), device=None,
                 seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        self.config = config
        self.mlp_hidden = tuple(mlp_hidden)
        self.vae = AutoencoderKL(config, device=dev, seed=seed)
        with torch.device("meta"):
            self.l2_head = L2PredictionHead(config.embed_dim, self.mlp_hidden,
                                            len(L2_PRODUCTS), config.dtype)
        self.l2_head.to_empty(device=dev)
        init_weights(self.l2_head,
                     torch.Generator(device=dev).manual_seed(seed + 1))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Dict[str, Any]:
        posterior = self.vae.encode(x)
        z = posterior.sample(generator)
        l2_all = self.l2_head(z)
        return {"reconstruction": self.vae.decode(z), "posterior": posterior,
                "z": z,
                "l2_predictions": {p: l2_all[..., i]
                                   for i, p in enumerate(L2_PRODUCTS)}}

    def encode(self, x: torch.Tensor) -> DiagonalGaussian:
        return self.vae.encode(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.vae.decode(z)

    def compute_loss(self, batch: Dict[str, torch.Tensor],
                     generator: torch.Generator,
                     l2_weights: Optional[Dict[str, float]] = None,
                     group: Optional[dist.ProcessGroup] = None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """batch: {'spectral': [B,H,W,C], '<PRODUCT>': [B,H,W]} (NaN =
        invalid). The decoded sample and the head's sample are two draws
        from ``generator``, in that order. ``group``: the data-parallel
        ranks this batch is a slice of (see ``masked_mse``)."""
        if l2_weights is None:
            l2_weights = DEFAULT_L2_WEIGHTS
        x = batch["spectral"]
        posterior = self.vae.encode(x)
        recon = self.vae.decode(posterior.sample(generator))
        loss, metrics = vae_loss(x, recon, posterior, self.vae.logvar,
                                 self.config)
        l2_all = self.l2_head(posterior.sample(generator)).float()
        total_l2 = torch.zeros((), device=l2_all.device)
        for i, product in enumerate(L2_PRODUCTS):
            if product not in batch:
                continue
            target = avg_pool_4x_nan(batch[product].float())
            l2_mse = masked_mse(l2_all[..., i], target, group)
            metrics[f"{product}_loss"] = l2_mse
            total_l2 = total_l2 + l2_weights[product] * l2_mse
        total = loss + total_l2
        metrics["loss"] = total
        return total, metrics


def avg_pool_4x_nan(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/4, W/4], the mean of each 4x4 block; NaN
    propagates (torch AvgPool2d semantics on NaN inputs)."""
    b, h, w = x.shape
    return x.reshape(b, h // 4, 4, w // 4, 4).mean(dim=(2, 4))


def masked_mse(pred: torch.Tensor, target: torch.Tensor,
               group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """MSE over the positions where the target is not NaN; 0 when none
    is. The mask acts before the square, so masked positions give a
    gradient of exactly 0.

    ``group``: the W ranks whose slices make up the batch (data
    parallelism; the train step passes it). The count is then the global
    one, as JAX's mesh step divides by the valid positions of the whole
    batch: the counts are summed over the group (an all-reduce, so every
    rank of it must call this in step), and each rank returns W * its
    squared sum / the global count.
    The mean over the ranks of that (the metrics' all-reduce and DDP's
    gradient average) is the global ratio; a mean of the ranks' own
    ratios is not, once their NaN counts differ."""
    mask = ~torch.isnan(target)
    safe_target = torch.where(mask, target, torch.zeros_like(target))
    sq = torch.where(mask, (pred - safe_target).square(),
                     torch.zeros_like(pred))
    total, count = sq.sum(), mask.sum()
    if group is not None:
        count = count.to(total.dtype)
        dist.all_reduce(count, group=group)
        total = total * dist.get_world_size(group)
    return torch.where(count > 0, total / count.clamp(min=1),
                       torch.zeros_like(total))


def build_vae_l2(model_config: Optional[Dict[str, Any]] = None,
                 mlp_hidden: Sequence[int] = (512, 512),
                 compute_dtype: Optional[str] = None, device=None,
                 seed: int = 0) -> Tuple[VAEWithL2Head, VAEConfig]:
    """Build the L2-supervised VAE from a training-config 'model' section
    and the 'l2' section's ``mlp_hidden``."""
    cfg = VAEConfig.from_dict(model_config or {})
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return VAEWithL2Head(cfg, mlp_hidden, device=device, seed=seed), cfg
