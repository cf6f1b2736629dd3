"""Hierarchical conv decoder, mirror of the encoder; counterpart of
tempo_tpu/nn/decoder.py.

conv_in maps z_channels -> chs[-1] at the latent grid; mid blocks (+attn);
then the levels in reverse channel order, each ending in a kernel-2
stride-2 transposed-conv upsample, except the last processed level, which
skips it (its weights exist all the same, as in the reference). Final:
GroupNorm -> act -> zero-init conv back to the input channel count.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tempo_tpu_torch.nn.blocks import (
    AttnBlock,
    Conv2d,
    GroupNorm,
    ResNetBlock,
    Upsample2x,
    norm_act_conv,
)


class DecoderLevel(nn.Module):
    def __init__(self, features: int, up_features: int, num_res_blocks: int,
                 use_attn: bool, n_heads: int, num_groups: int,
                 norm_eps: float, norm_affine: bool, act: str,
                 kernel_size: int, dropout_prob: float, last: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.last = last
        self.resnet_blocks = nn.ModuleList(
            ResNetBlock(features, features, num_groups, norm_eps, norm_affine,
                        act, kernel_size, dropout_prob, compute_dtype)
            for _ in range(num_res_blocks))
        self.attention_blocks = nn.ModuleList(
            AttnBlock(features, n_heads, num_groups, norm_eps, norm_affine,
                      compute_dtype)
            for _ in range(num_res_blocks if use_attn else 0))
        self.up = Upsample2x(features, up_features, compute_dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        for j, block in enumerate(self.resnet_blocks):
            x = block(x, deterministic)
            if len(self.attention_blocks):
                x = self.attention_blocks[j](x)
        return x if self.last else self.up(x)


class Decoder(nn.Module):
    def __init__(self, out_channels: int = 1028, input_size: int = 64,
                 chs: Sequence[int] = (512, 256, 128),
                 attn_sizes: Sequence[int] = (), mid_attn: bool = True,
                 num_res_blocks: int = 1, dropout_prob: float = 0.0,
                 z_channels: int = 32, n_attention_heads: int = 4,
                 norm_groups: int = 8, norm_eps: float = 1e-6,
                 norm_affine: bool = True, act: str = "gelu",
                 conv_kernel_size: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_kernel_size % 2 != 1:
            raise ValueError("conv_kernel_size must be odd")
        self.act = act
        k = conv_kernel_size
        n_levels = len(chs)
        mid = chs[-1]
        self.conv_in = Conv2d(z_channels, mid, k, compute_dtype=compute_dtype)
        block = dict(num_groups=norm_groups, norm_eps=norm_eps,
                     norm_affine=norm_affine, act=act, kernel_size=k,
                     dropout_prob=dropout_prob, compute_dtype=compute_dtype)
        self.mid1 = ResNetBlock(mid, mid, **block)
        self.mid_attn1 = (AttnBlock(mid, n_attention_heads, norm_groups,
                                    norm_eps, norm_affine, compute_dtype)
                          if mid_attn else None)
        self.mid2 = ResNetBlock(mid, mid, **block)
        levels, size = [], input_size // (2 ** (n_levels - 1))
        for idx, i_level in enumerate(reversed(range(n_levels))):
            up_ch = chs[0] if i_level == 0 else chs[i_level - 1]
            levels.append(DecoderLevel(
                chs[i_level], up_ch, num_res_blocks, size in attn_sizes,
                n_attention_heads, norm_groups, norm_eps, norm_affine, act, k,
                dropout_prob, last=idx == n_levels - 1,
                compute_dtype=compute_dtype))
            size //= 2
        self.ups = nn.ModuleList(levels)
        self.norm_out = GroupNorm(norm_groups, chs[0], norm_eps, norm_affine)
        self.conv_out = Conv2d(chs[0], out_channels, k, zero_init=True,
                               compute_dtype=compute_dtype)

    def forward(self, z: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        h = self.conv_in(z)
        h = self.mid1(h, deterministic)
        if self.mid_attn1 is not None:
            h = self.mid_attn1(h)
        h = self.mid2(h, deterministic)
        for level in self.ups:
            h = level(h, deterministic)
        return norm_act_conv(self.norm_out, self.act, self.conv_out, h)
