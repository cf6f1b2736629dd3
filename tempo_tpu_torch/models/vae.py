"""KL-autoencoder for TEMPO hyperspectral patches; counterpart of
tempo_tpu/models/vae.py.

- encode: encoder -> 1x1 quant conv -> DiagonalGaussian over 2*embed_dim.
- decode: 1x1 post-quant conv -> decoder.
- loss: per-element L1 (or L2, or k-space MSE) reconstruction scaled by a
  learned scalar logvar (init 6.0), SUM reduction divided by the batch,
  plus kl_weight * sum(KL) / B. ``get_loss`` is the training loss: the
  posterior sample, deterministic=True (dropout never acts in VAE
  training, as in the JAX package), then the loss in fp32.
- remat: the encoder and the decoder run under torch.utils.checkpoint
  when a graph is being built, so their activations are recomputed in the
  backward (the JAX package's nn.remat).
- the vestigial in-model NO2 probe (``no2_mlp_hidden`` set and
  ``no2_weight`` > 0): a 1x1-conv ReLU MLP on the latent mean,
  ``predict_no2``; no loss reads it, as in the JAX package.

Flagship instantiation: 27,289,893 parameters, input (64, 64, 1028). Public
tensors are NHWC [B, H, W, C]. Parameters stay fp32; activations run in
``compute_dtype`` (bf16 by default), cast where the JAX modules cast.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.nn.blocks import Dense, init_weights
from tempo_tpu_torch.nn.decoder import Decoder
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.nn.encoder import Encoder
from tempo_tpu_torch.ops.losses import multiscale_mse


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The fields of tempo_tpu's VAEConfig. ``pad_boundary`` is accepted
    and ignored: the TPU lane padding does not change the numbers.
    ``remat`` recomputes the encoder's and the decoder's activations in the
    backward instead of keeping them (the same loss and gradients, less
    memory, one more forward)."""

    shape: Tuple[int, int, int] = (1028, 64, 64)  # (C, H, W)
    chs: Tuple[int, ...] = (512, 256, 128)
    attn_sizes: Tuple[int, ...] = ()
    mid_attn: bool = True
    num_res_blocks: int = 1
    dropout_prob: float = 0.0
    z_channels: int = 32
    double_z: bool = True
    n_attention_heads: int = 4
    norm_groups: int = 8
    norm_eps: float = 1e-6
    norm_affine: bool = True
    act: str = "gelu"
    conv_kernel_size: int = 3
    embed_dim: int = 32
    kl_weight: float = 1e-6
    nll_loss_type: str = "l1"
    logvar_init: float = 6.0
    no2_weight: float = 0.0
    no2_mlp_hidden: Optional[Tuple[int, ...]] = None
    compute_dtype: str = "bfloat16"
    pad_boundary: bool = True
    remat: bool = False

    @property
    def in_channels(self) -> int:
        return self.shape[0]

    @property
    def input_size(self) -> int:
        return self.shape[1]

    @property
    def spatial_factor(self) -> int:
        """The encoder's downsampling: the latent grid is the input's over
        this factor."""
        return 2 ** (len(self.chs) - 1)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @classmethod
    def from_dict(cls, params: Dict[str, Any]) -> "VAEConfig":
        """Known keys override the defaults; unknown keys are ignored."""
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: tuple(v) if isinstance(v, list) else v
                      for k, v in params.items() if k in known})


class AutoencoderKL(nn.Module):
    """The VAE, built on ``device`` (None means CUDA) with PyTorch's default
    init drawn from a generator seeded with ``seed``."""

    def __init__(self, config: VAEConfig, device=None, seed: int = 0):
        super().__init__()
        cfg = config
        dev = resolve_device(device)
        self.config = cfg
        common = dict(
            input_size=cfg.input_size, chs=tuple(cfg.chs),
            attn_sizes=tuple(cfg.attn_sizes), mid_attn=cfg.mid_attn,
            num_res_blocks=cfg.num_res_blocks,
            dropout_prob=cfg.dropout_prob, z_channels=cfg.z_channels,
            n_attention_heads=cfg.n_attention_heads,
            norm_groups=cfg.norm_groups, norm_eps=cfg.norm_eps,
            norm_affine=cfg.norm_affine, act=cfg.act,
            conv_kernel_size=cfg.conv_kernel_size, compute_dtype=cfg.dtype)
        enc_out = 2 * cfg.z_channels if cfg.double_z else cfg.z_channels
        with torch.device("meta"):  # allocate once, on `dev`, below
            self.encoder = Encoder(in_channels=cfg.in_channels,
                                   double_z=cfg.double_z, **common)
            self.decoder = Decoder(out_channels=cfg.in_channels, **common)
            self.quant_conv = Dense(enc_out, 2 * cfg.embed_dim, cfg.dtype)
            self.post_quant_conv = Dense(cfg.embed_dim, cfg.z_channels,
                                         cfg.dtype)
            self.logvar = nn.Parameter(torch.empty(()))
            self.no2_probe = None
            if cfg.no2_mlp_hidden is not None and cfg.no2_weight > 0:
                widths = (cfg.embed_dim,) + tuple(cfg.no2_mlp_hidden) + (1,)
                self.no2_probe = nn.ModuleList(
                    Dense(a, b, cfg.dtype)
                    for a, b in zip(widths[:-1], widths[1:]))
        self.to_empty(device=dev)
        generator = torch.Generator(device=dev).manual_seed(seed)
        init_weights(self, generator)
        with torch.no_grad():
            self.logvar.fill_(cfg.logvar_init)

    def _run(self, net: nn.Module, x: torch.Tensor,
             deterministic: bool) -> torch.Tensor:
        """``net(x, deterministic)``, rematerialized when the config asks
        and a graph is being built."""
        if self.config.remat and torch.is_grad_enabled():
            return checkpoint(net, x, deterministic, use_reentrant=False)
        return net(x, deterministic)

    def encode(self, x: torch.Tensor, deterministic: bool = True
               ) -> DiagonalGaussian:
        moments = self.quant_conv(self._run(self.encoder, x, deterministic))
        return DiagonalGaussian.from_params(moments)

    def decode(self, z: torch.Tensor, deterministic: bool = True
               ) -> torch.Tensor:
        z = self.post_quant_conv(z.to(self.config.dtype))
        return self._run(self.decoder, z, deterministic)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                sample_posterior: bool = True, deterministic: bool = True
                ) -> Tuple[torch.Tensor, DiagonalGaussian]:
        posterior = self.encode(x, deterministic)
        if sample_posterior:
            if generator is None:
                raise ValueError("a generator is required to sample the "
                                 "posterior")
            z = posterior.sample(generator)
        else:
            z = posterior.mode()
        return self.decode(z, deterministic), posterior

    def reconstruct(self, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    sample_posterior: bool = True) -> torch.Tensor:
        recon, _ = self(x, generator=generator,
                        sample_posterior=sample_posterior)
        return recon

    def predict_no2(self, x: torch.Tensor) -> torch.Tensor:
        """The latent mean -> [B, Hl, Wl, 1] NO2 map through the in-model
        probe: ReLU after each hidden dense (tempo_tpu/models/vae.py
        ``predict_no2``)."""
        if self.no2_probe is None:
            raise ValueError("NO2 probe not initialized")
        h = self.encode(x).mean.to(self.config.dtype)
        for layer in self.no2_probe[:-1]:
            h = torch.relu(layer(h))
        return self.no2_probe[-1](h)

    def get_loss(self, x: torch.Tensor, generator: torch.Generator
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a [B, H, W, C] batch: the posterior sample
        drawn from ``generator``, deterministic=True, then ``vae_loss``
        (tempo_tpu/models/vae.py ``get_loss``)."""
        recon, posterior = self(x, generator=generator,
                                sample_posterior=True, deterministic=True)
        return vae_loss(x, recon, posterior, self.logvar, self.config)


def vae_loss(x: torch.Tensor, recon: torch.Tensor,
             posterior: DiagonalGaussian, logvar: torch.Tensor,
             cfg: VAEConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """nll = sum(rec_err / exp(logvar) + logvar) / B;
    kl = kl_weight * sum(KL(posterior || N(0, I))) / B; all in fp32."""
    x32 = x.float()[..., :cfg.in_channels]
    r32 = recon.float()[..., :cfg.in_channels]
    if cfg.nll_loss_type == "l1":
        rec_err = (x32 - r32).abs()
    elif cfg.nll_loss_type == "l2":
        rec_err = (x32 - r32).square()
    elif cfg.nll_loss_type == "ms_mse":
        rec_err = multiscale_mse(x32, r32)
    else:
        raise ValueError("nll_loss_type must be l1, l2 or ms_mse")
    batch = x.shape[0]
    nll_loss = torch.sum(rec_err / torch.exp(logvar) + logvar) / batch
    pixel_mse = torch.mean((x32 - r32).square())
    kl_loss = cfg.kl_weight * torch.sum(posterior.kl()) / batch
    loss = nll_loss + kl_loss
    return loss, {"loss": loss, "nll_loss": nll_loss, "kl_loss": kl_loss,
                  "pixel_mse": pixel_mse}


def build_vae(model_config: Optional[Dict[str, Any]] = None,
              compute_dtype: Optional[str] = None, device=None,
              seed: int = 0) -> Tuple[AutoencoderKL, VAEConfig]:
    """Build the VAE from a training-config 'model' section."""
    cfg = VAEConfig.from_dict(model_config or {})
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    return AutoencoderKL(cfg, device=device, seed=seed), cfg
