"""Conditional UNet and conditional MLP (NHWC / NDHWC activations, PyTorch
parameter layouts); counterpart of tempo_tpu/nn/unet.py with the same math:

- the same skip topology: each level's activation before its downsample
  is concatenated after the matching upsample; the deepest level has no
  skip and the level-0 up keeps full resolution;
- conditioning: the timestep embedding through a 2-layer GELU MLP; vector
  conditionings through shared embed MLPs ("common_*" types, optional
  ``v_augment`` with its noise from an explicit generator) or raw; every
  conditional ResNet block adds one projection a conditioning (zero-init
  linear, linear or MLP) after its first conv, broadcast over the spatial
  axes;
- output: GN -> GELU -> zero-init conv, plus the input through a zero-init
  3x3 conv where the channel counts differ.

Every GroupNorm runs through K1 (ops/cuda_gn.py); a GroupNorm followed by
a 2-D 3x3 conv is one K2 call (nn/blocks.py ``norm_act_conv``), so in 2-D
only ``mid_attn``'s norm launches K1b. A 4-tuple shape (D, H, W, C)
selects the volumetric path: 3x3x3 convs and kernel-2 stride-2 resamples
over three axes in plain torch, every norm K1 then the conv, and
``mid_attn`` refused as in the JAX package. Dropout modules exist where
``dropout_prob`` > 0 (they move a block's second conv to ``net2.3``) but
drop only when a caller passes ``deterministic=False``; the diffusion
models never do, as in the JAX package.

Modules carry the reference toolkit's names (``conv_in``,
``embed_t_conditioning``, ``embeds_v_conditionings.{i}``,
``downs.{i}.resnet_blocks.{j}``, ``cond_projs.{k}``, ``mid1``,
``mid_attn1``, ``ups.{i}``, ``norm_out``, ``conv_out``,
``conv_residual_out``; CMLP ``layers.{i}``, ``embedders.{i}.{k}``), which
tempo_tpu/interop/unet_ckpt.py reads. Parameters are fp32 and start from
PyTorch's default init drawn from a generator seeded with ``seed``; the
JAX package's ``scale_params`` (the reference's post-init ``init_scale``)
is ``scale_params`` here. Both networks compute in fp32 (the JAX modules'
``compute_dtype`` default, which the diffusion CLIs keep).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.nn.blocks import (AttnBlock, Conv2d, Conv3d,
                                       Downsample2x, Downsample2x3d,
                                       GroupNorm, ResNetBlock, Upsample2x,
                                       Upsample2x3d, init_weights,
                                       norm_act_conv)
from tempo_tpu_torch.ops.norms import ACTIVATIONS

NORM_EPS = 1e-6  # every GroupNorm of the CUNet, as in the JAX package


def timestep_embedding(t: torch.Tensor, embedding_dim: int,
                       T: float = 1000.0, max_timescale: float = 10_000.0,
                       min_timescale: float = 1.0) -> torch.Tensor:
    """Sinusoidal embedding of diffusion time t in [0, 1]: t scaled by T,
    log-spaced timescales, the sin block then the cos block (fp32)."""
    if embedding_dim % 2:
        raise ValueError(f"embedding_dim must be even, got {embedding_dim}")
    t = torch.as_tensor(t, dtype=torch.float32) * T
    inv = torch.logspace(-math.log10(min_timescale),
                         -math.log10(max_timescale), embedding_dim // 2,
                         dtype=torch.float32, device=t.device)
    emb = t[..., None] * inv
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)


def scale_params(module: nn.Module, init_scale: float = 0.02) -> nn.Module:
    """Multiply every parameter by ``init_scale`` in place (the reference's
    global post-init scaling); returns the module."""
    with torch.no_grad():
        for p in module.parameters():
            p.mul_(init_scale)
    return module


def _linear(cin: int, cout: int, zero: bool = False) -> nn.Linear:
    layer = nn.Linear(cin, cout)
    layer.zero_init = zero
    return layer


class CondMLP(nn.Sequential):
    """Linear -> GELU -> Linear (-> GELU): the embed MLP of the t and
    common v conditionings and of the ``mlp`` conditioning projections
    (indices 0 and 2 hold the linears, as in the reference)."""

    def __init__(self, cin: int, features: int, final_act: bool = True,
                 zero_last: bool = False):
        layers = [_linear(cin, features), nn.GELU(),
                  _linear(features, features, zero=zero_last)]
        if final_act:
            layers.append(nn.GELU())
        super().__init__(*layers)


class CondResNetBlock(ResNetBlock):
    """ResNet block with additive per-conditioning projections after the
    first conv: GN -> GELU -> conv; + projections; GN -> GELU ->
    (dropout) -> zero-init conv; a channel-last matmul skip on a channel
    change. Conv2d, or Conv3d where ``dim`` is 3."""

    def __init__(self, cin: int, features: int,
                 conditioning_dims: Optional[Sequence[int]] = None,
                 cond_proj_type: str = "zerolinear", num_groups: int = 8,
                 dropout_prob: float = 0.0, dim: int = 2):
        super().__init__(cin, features, num_groups, NORM_EPS,
                         dropout_prob=dropout_prob,
                         conv=Conv2d if dim == 2 else Conv3d)
        self.dim = dim
        self.cond_projs = None
        if conditioning_dims:
            if cond_proj_type not in ("zerolinear", "linear", "mlp"):
                raise ValueError(
                    f"unknown cond_proj_type {cond_proj_type!r}")
            self.cond_projs = nn.ModuleList(
                CondMLP(d, features) if cond_proj_type == "mlp"
                else _linear(d, features, zero=cond_proj_type == "zerolinear")
                for d in conditioning_dims)

    def forward(self, x: torch.Tensor,
                conditionings: Optional[Sequence[torch.Tensor]] = None,
                deterministic: bool = True) -> torch.Tensor:
        adds = []
        if conditionings is not None:
            if self.cond_projs is None or len(conditionings) != len(
                    self.cond_projs):
                raise ValueError("conditionings do not match the block's "
                                 "conditioning_dims")
            for proj, cond in zip(self.cond_projs, conditionings):
                p = proj(cond)
                adds.append(p.reshape(p.shape[0], *((1,) * self.dim), -1))
        return super().forward(x, deterministic, adds)


class _Level(nn.Module):
    """One level of the down or up path: its ResNet blocks and its
    resample (``down`` / ``up``, absent on the last level)."""

    def __init__(self, blocks: Sequence[nn.Module],
                 resample: Optional[nn.Module], name: str):
        super().__init__()
        self.resnet_blocks = nn.ModuleList(blocks)
        if resample is not None:
            setattr(self, name, resample)


class CUNet(nn.Module):
    """Conditional UNet over NHWC (or NDHWC) tiles.

    forward(x, t=None, s_conditioning=None, v_conditionings=None,
    deterministic=True, generator=None): x [B, *spatial, C]; t a scalar or
    [B] diffusion time in [0, 1]; s_conditioning [B, *spatial, Cs]
    concatenated onto the input; v_conditionings a list of [B, dim_i];
    ``generator`` draws ``v_augment``'s noise. Built on ``device`` (None
    means CUDA) from a generator seeded with ``seed``."""

    def __init__(self, shape: Tuple[int, ...],
                 out_channels: Optional[int] = None,
                 chs: Sequence[int] = (48, 96, 192, 384),
                 s_conditioning_channels: int = 0,
                 v_conditioning_dims: Sequence[int] = (),
                 v_conditioning_type: str = "common_zerolinear",
                 v_embedding_dim: int = 64, v_augment: bool = False,
                 v_embed_no_s_gelu: bool = False,
                 t_conditioning: bool = False, t_embedding_dim: int = 64,
                 num_res_blocks: int = 1, norm_groups: int = 8,
                 mid_attn: bool = True, n_attention_heads: int = 4,
                 dropout_prob: float = 0.1, device=None, seed: int = 0):
        super().__init__()
        self.shape = tuple(shape)
        self.dim = len(self.shape) - 1
        if self.dim not in (2, 3):
            raise ValueError(f"shape must be (H, W, C) or (D, H, W, C), got "
                             f"{self.shape}")
        if mid_attn and self.dim == 3:
            raise ValueError("3D attention very highly discouraged.")
        common, cond_proj_type = v_conditioning_type.split("_")
        self.common = common == "common"
        if v_augment and not self.common:
            raise ValueError("v_augment requires a common_* conditioning "
                             "type")
        self.chs = tuple(chs)
        self.s_conditioning_channels = s_conditioning_channels
        self.v_conditioning_dims = tuple(v_conditioning_dims)
        self.v_augment = v_augment
        self.t_conditioning = t_conditioning
        self.t_embedding_dim = t_embedding_dim
        self.out_ch = (out_channels if out_channels is not None
                       else self.shape[-1])
        dev = resolve_device(device)

        cond_dims = ([4 * t_embedding_dim] if t_conditioning else []) + [
            v_embedding_dim if self.common else d
            for d in self.v_conditioning_dims]
        block = dict(conditioning_dims=cond_dims or None,
                     cond_proj_type=cond_proj_type, num_groups=norm_groups,
                     dropout_prob=dropout_prob, dim=self.dim)
        conv = Conv2d if self.dim == 2 else Conv3d
        down = Downsample2x if self.dim == 2 else Downsample2x3d
        up = Upsample2x if self.dim == 2 else Upsample2x3d
        n = len(self.chs)
        with torch.device("meta"):  # allocate once, on `dev`, below
            self.conv_in = conv(self.shape[-1] + s_conditioning_channels,
                                self.chs[0])
            if t_conditioning:
                self.embed_t_conditioning = CondMLP(t_embedding_dim,
                                                    4 * t_embedding_dim)
            if self.v_conditioning_dims and self.common:
                width = 2 * v_embedding_dim if v_augment else v_embedding_dim
                self.embeds_v_conditionings = nn.ModuleList(
                    CondMLP(d, width, final_act=not v_embed_no_s_gelu,
                            zero_last=v_augment)
                    for d in self.v_conditioning_dims)
            ch_in, skips, downs = self.chs[0], [], []
            for i, ch in enumerate(self.chs):
                blocks = []
                for _ in range(num_res_blocks):
                    blocks.append(CondResNetBlock(ch_in, ch, **block))
                    ch_in = ch
                last = i == n - 1
                if not last:
                    skips.append(ch)
                downs.append(_Level(blocks, None if last else down(ch),
                                    "down"))
            self.downs = nn.ModuleList(downs)
            self.mid1 = CondResNetBlock(ch_in, self.chs[-1], **block)
            if mid_attn:
                self.mid_attn1 = AttnBlock(self.chs[-1], n_attention_heads,
                                           norm_groups)
            self.mid2 = CondResNetBlock(self.chs[-1], self.chs[-1], **block)
            ch_in, ups = self.chs[-1], []
            for idx, i in enumerate(reversed(range(n))):
                blocks = []
                for _ in range(num_res_blocks):
                    blocks.append(CondResNetBlock(ch_in, self.chs[i],
                                                  **block))
                    ch_in = self.chs[i]
                resample = None
                if idx != n - 1:
                    ch_out = self.chs[0] if i == 0 else self.chs[i - 1]
                    resample = up(ch_in, ch_out)
                    ch_in = ch_out + skips.pop()
                ups.append(_Level(blocks, resample, "up"))
            self.ups = nn.ModuleList(ups)
            self.norm_out = GroupNorm(norm_groups, ch_in, NORM_EPS)
            self.conv_out = conv(ch_in, self.out_ch, zero_init=True)
            self.conv_residual_out = (
                conv(self.shape[-1], self.out_ch, zero_init=True)
                if self.shape[-1] != self.out_ch else None)
        self.to_empty(device=dev)
        init_weights(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, x: torch.Tensor, t=None,
                s_conditioning: Optional[torch.Tensor] = None,
                v_conditionings: Optional[Sequence[torch.Tensor]] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if s_conditioning is not None:
            if s_conditioning.shape[-1] != self.s_conditioning_channels:
                raise ValueError("s_conditioning's channels do not match "
                                 "s_conditioning_channels")
            h = torch.cat([x, s_conditioning.to(x.dtype)], dim=-1)
        elif self.s_conditioning_channels:
            raise ValueError("s_conditioning_channels > 0 needs "
                             "s_conditioning")
        else:
            h = x

        conds = []
        if t is not None:
            if not self.t_conditioning:
                raise ValueError("t given but t_conditioning is off")
            t = torch.as_tensor(t, dtype=torch.float32, device=x.device)
            t = torch.broadcast_to(t, (x.shape[0],))
            conds.append(self.embed_t_conditioning(
                timestep_embedding(t, self.t_embedding_dim)))
        elif self.t_conditioning:
            raise ValueError("t_conditioning needs t")
        if v_conditionings is not None:
            if len(v_conditionings) != len(self.v_conditioning_dims):
                raise ValueError("v_conditionings do not match "
                                 "v_conditioning_dims")
            for i, v in enumerate(v_conditionings):
                if self.common:
                    v = self.embeds_v_conditionings[i](v)
                    if self.v_augment:
                        if generator is None:
                            raise ValueError("v_augment needs a generator")
                        means, logs = v[:, ::2], v[:, 1::2]
                        noise = torch.randn(means.shape, generator=generator,
                                            device=means.device)
                        v = means + torch.exp(logs) * noise
                conds.append(v)
        conds = conds or None

        h = self.conv_in(h)
        skips = []
        for level in self.downs:
            for blk in level.resnet_blocks:
                h = blk(h, conds, deterministic)
            if hasattr(level, "down"):
                skips.append(h)
                h = level.down(h)
        h = self.mid1(h, conds, deterministic)
        if hasattr(self, "mid_attn1"):
            h = self.mid_attn1(h)
        h = self.mid2(h, conds, deterministic)
        for level in self.ups:
            for blk in level.resnet_blocks:
                h = blk(h, conds, deterministic)
            if hasattr(level, "up"):
                h = torch.cat([level.up(h), skips.pop().to(h.dtype)], dim=-1)
        h = norm_act_conv(self.norm_out, "gelu", self.conv_out, h)
        if self.conv_residual_out is not None:
            x = self.conv_residual_out(x)
        return h + x


class CMLP(nn.Module):
    """Conditional MLP for flat data: each hidden layer adds one embed MLP
    a conditioning (t through the sinusoidal embedding and an embed MLP
    without its final GELU, raw v vectors as they are), then the
    activation. Built on ``device`` (None means CUDA) from a generator
    seeded with ``seed``."""

    def __init__(self, in_dim: int, out_dim: Optional[int] = None,
                 h_dims: Sequence[int] = (64,),
                 v_conditioning_dims: Sequence[int] = (),
                 t_conditioning: bool = False, t_embedding_dim: int = 64,
                 act: str = "gelu", device=None, seed: int = 0):
        super().__init__()
        self.in_dim = in_dim
        self.shape = (in_dim,)
        self.act = act
        self.t_conditioning = t_conditioning
        self.t_embedding_dim = t_embedding_dim
        out_dim = out_dim if out_dim is not None else in_dim
        dims = (in_dim,) + tuple(h_dims) + (out_dim,)
        cond_dims = ([4 * t_embedding_dim] if t_conditioning else []) + list(
            v_conditioning_dims)
        dev = resolve_device(device)
        with torch.device("meta"):
            if t_conditioning:
                self.embed_t_conditioning = CondMLP(
                    t_embedding_dim, 4 * t_embedding_dim, final_act=False)
            self.layers = nn.ModuleList(
                _linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
            self.embedders = nn.ModuleList(
                nn.ModuleList(CondMLP(d, dims[i + 1]) for d in cond_dims)
                for i in range(len(dims) - 2))
        self.to_empty(device=dev)
        init_weights(self, torch.Generator(device=dev).manual_seed(seed))

    def forward(self, x: torch.Tensor, t=None,
                v_conditionings: Optional[Sequence[torch.Tensor]] = None
                ) -> torch.Tensor:
        conds = []
        if t is not None:
            if not self.t_conditioning:
                raise ValueError("t given but t_conditioning is off")
            t = torch.broadcast_to(torch.as_tensor(
                t, dtype=torch.float32, device=x.device), (x.shape[0],))
            conds.append(self.embed_t_conditioning(
                timestep_embedding(t, self.t_embedding_dim)))
        elif self.t_conditioning:
            raise ValueError("t_conditioning needs t")
        for v in v_conditionings or ():
            if v.shape[0] != x.shape[0]:
                raise ValueError("batch not matching")
            conds.append(v)
        h = x
        for i, layer in enumerate(self.layers):
            h = layer(h)
            if i < len(self.layers) - 1:
                for embed, cond in zip(self.embedders[i], conds):
                    h = h + embed(cond)
                h = ACTIVATIONS[self.act](h)
        return h
