"""Hierarchical conv encoder; counterpart of tempo_tpu/nn/encoder.py.

Flagship configuration: input [B,64,64,1028], chs=(512,256,128), one
ResNetBlock per level, mid attention (4 heads), GroupNorm(8, eps=1e-6),
GELU, zero-initialized final conv to 2*z_channels. The last level skips its
downsample, so 64 -> 32 -> 16. Its downsample weights exist all the same,
as in the reference, so the parameter count (27,289,893 for the whole VAE)
and checkpoint names match.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from tempo_tpu_torch.nn.blocks import (
    AttnBlock,
    Conv2d,
    Downsample2x,
    GroupNorm,
    ResNetBlock,
    norm_act_conv,
)


class EncoderLevel(nn.Module):
    def __init__(self, cin: int, features: int, num_res_blocks: int,
                 use_attn: bool, n_heads: int, num_groups: int,
                 norm_eps: float, norm_affine: bool, act: str,
                 kernel_size: int, dropout_prob: float, last: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.last = last
        self.resnet_blocks = nn.ModuleList(
            ResNetBlock(cin if j == 0 else features, features, num_groups,
                        norm_eps, norm_affine, act, kernel_size, dropout_prob,
                        compute_dtype)
            for j in range(num_res_blocks))
        self.attention_blocks = nn.ModuleList(
            AttnBlock(features, n_heads, num_groups, norm_eps, norm_affine,
                      compute_dtype)
            for _ in range(num_res_blocks if use_attn else 0))
        self.down = Downsample2x(features, compute_dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        for j, block in enumerate(self.resnet_blocks):
            x = block(x, deterministic)
            if len(self.attention_blocks):
                x = self.attention_blocks[j](x)
        return x if self.last else self.down(x)


class Encoder(nn.Module):
    def __init__(self, in_channels: int = 1028, input_size: int = 64,
                 chs: Sequence[int] = (512, 256, 128),
                 attn_sizes: Sequence[int] = (), mid_attn: bool = True,
                 num_res_blocks: int = 1, dropout_prob: float = 0.0,
                 z_channels: int = 32, double_z: bool = True,
                 n_attention_heads: int = 4, norm_groups: int = 8,
                 norm_eps: float = 1e-6, norm_affine: bool = True,
                 act: str = "gelu", conv_kernel_size: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if conv_kernel_size % 2 != 1:
            raise ValueError("conv_kernel_size must be odd")
        self.act = act
        k = conv_kernel_size
        self.conv_in = Conv2d(in_channels, chs[0], k,
                              compute_dtype=compute_dtype)
        levels, cin, size = [], chs[0], input_size
        for i, ch in enumerate(chs):
            levels.append(EncoderLevel(
                cin, ch, num_res_blocks, size in attn_sizes,
                n_attention_heads, norm_groups, norm_eps, norm_affine, act, k,
                dropout_prob, last=i == len(chs) - 1,
                compute_dtype=compute_dtype))
            cin, size = ch, size // 2
        self.downs = nn.ModuleList(levels)
        mid = chs[-1]
        block = dict(num_groups=norm_groups, norm_eps=norm_eps,
                     norm_affine=norm_affine, act=act, kernel_size=k,
                     dropout_prob=dropout_prob, compute_dtype=compute_dtype)
        self.mid1 = ResNetBlock(mid, mid, **block)
        self.mid_attn1 = (AttnBlock(mid, n_attention_heads, norm_groups,
                                    norm_eps, norm_affine, compute_dtype)
                          if mid_attn else None)
        self.mid2 = ResNetBlock(mid, mid, **block)
        self.norm_out = GroupNorm(norm_groups, mid, norm_eps, norm_affine)
        out_ch = 2 * z_channels if double_z else z_channels
        self.conv_out = Conv2d(mid, out_ch, k, zero_init=True,
                               compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor, deterministic: bool = True
                ) -> torch.Tensor:
        h = self.conv_in(x)
        for level in self.downs:
            h = level(h, deterministic)
        h = self.mid1(h, deterministic)
        if self.mid_attn1 is not None:
            h = self.mid_attn1(h)
        h = self.mid2(h, deterministic)
        return norm_act_conv(self.norm_out, self.act, self.conv_out, h)
