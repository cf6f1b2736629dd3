"""Core network blocks (NHWC activations, PyTorch parameter layouts).

Counterpart of tempo_tpu/nn/blocks.py with the same math:

- ResNetBlock: GN -> act -> conv3x3; GN -> act -> (dropout) -> zero-init
  conv3x3; 1x1 skip conv on a channel change. Without active dropout each
  GN -> act -> conv3x3 half is one K2 call (ops/cuda_gn_conv.py), whose
  backward recomputes the plain chain; with it, K1 then the conv.
- AttnBlock: GN (K1, its backward a plain recompute), 1x1 q/k/v, channel-major multi-head attention (the
  head index varies fastest on the channel axis), softmax over keys in
  fp32, 1x1 proj, residual.
- Downsample2x / Upsample2x: kernel-2 stride-2 (transposed) convs.
- Conv3d, Downsample2x3d, Upsample2x3d: their NDHWC counterparts for the
  volumetric (dim=3) CUNet, plain torch (the JAX package computes them
  outside any Pallas kernel); ``norm_act_conv`` runs K1, then a Conv3d.

Modules and parameters carry the reference PyTorch model's names
(``resnet_blocks.{j}.net1.0`` ...), so its state_dicts load as they are.
Parameters stay fp32; activations are cast to ``compute_dtype`` where the
JAX modules cast to their ``dtype``.
"""

from __future__ import annotations

import contextlib
import functools
import math
from typing import Callable, Iterator, Optional, Sequence

import torch
from torch import nn

from tempo_tpu_torch.ops import cuda_gn_conv
from tempo_tpu_torch.ops.convs import (conv2d_nhwc, conv3d_ndhwc,
                                       conv_transpose2x_ndhwc,
                                       conv_transpose2x_nhwc, dense)
from tempo_tpu_torch.ops.norms import group_norm_act

_ACT_MODULES = {"gelu": nn.GELU, "relu": nn.ReLU, "silu": nn.SiLU}


class Conv2d(nn.Conv2d):
    """kxk SAME conv over NHWC; weight OIHW. ``zero_init`` marks the
    zero-initialized output convs. Caches its weight in K2's layout; the
    ``export_packed`` buffer holds that layout only inside
    ``packed_for_export`` (None otherwise, and then not in the state
    dict)."""

    cache_packed = True  # False under FSDP2 (see packed_weight)

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 zero_init: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, kernel_size, padding=kernel_size // 2)
        self.zero_init = zero_init
        self.compute_dtype = compute_dtype
        self._packed: Optional[tuple] = None
        self.register_buffer("export_packed", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x.to(self.compute_dtype), self.weight, self.bias,
                           padding=self.padding[0])

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """The weight as K2's [9, C, F] in ``dtype``, cached until the
        weight changes (in place, or moved) or another type is asked for.
        A weight made under torch.inference_mode() keeps no version count,
        so an in-place change could not be seen: it is packed anew on every
        call and never cached. So is the weight of a conv under FSDP2
        (``cache_packed`` False, set by parallel/fsdp.py): the gathered
        weight a forward sees keeps version 0 while its values change, and
        the allocator may hand it the same address every step."""
        w = self.weight
        if w.is_inference() or not self.cache_packed:
            self._packed = None
            return cuda_gn_conv.pack_conv3x3_weight(w, dtype)
        key = (w.device, w.data_ptr(), w._version, dtype)
        if self._packed is None or self._packed[0] != key:
            self._packed = (key, cuda_gn_conv.pack_conv3x3_weight(w, dtype))
        return self._packed[1]


class Dense(nn.Conv2d):
    """1x1 conv over NHWC (a channel-last matmul); weight [out, in, 1, 1]."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.float32,
                 bias: bool = True):
        super().__init__(cin, cout, 1, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x.to(self.compute_dtype), self.weight, self.bias)


class Downsample2x(nn.Conv2d):
    """Kernel-2 stride-2 conv over NHWC."""

    def __init__(self, channels: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, 2, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_nhwc(x.to(self.compute_dtype), self.weight, self.bias,
                           stride=2)


class Upsample2x(nn.ConvTranspose2d):
    """Kernel-2 stride-2 transposed conv over NHWC; weight [in, out, 2, 2]."""

    def __init__(self, cin: int, cout: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, 2, stride=2)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2x_nhwc(x.to(self.compute_dtype), self.weight,
                                     self.bias)


class Conv3d(nn.Conv3d):
    """3x3x3 SAME conv over NDHWC in fp32; weight [F, C, 3, 3, 3]. The
    volumetric CUNet's only conv; ``norm_act_conv`` reads
    ``compute_dtype`` as it does Conv2d's."""

    compute_dtype = torch.float32

    def __init__(self, cin: int, cout: int, zero_init: bool = False):
        super().__init__(cin, cout, 3, padding=1)
        self.zero_init = zero_init

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_ndhwc(x.to(self.compute_dtype), self.weight, self.bias,
                            padding=1)


class Downsample2x3d(nn.Conv3d):
    """Kernel-2 stride-2 conv over NDHWC, in x's type."""

    def __init__(self, channels: int):
        super().__init__(channels, channels, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d_ndhwc(x, self.weight, self.bias, stride=2)


class Upsample2x3d(nn.ConvTranspose3d):
    """Kernel-2 stride-2 transposed conv over NDHWC, in x's type; weight
    [in, out, 2, 2, 2]."""

    def __init__(self, cin: int, cout: int):
        super().__init__(cin, cout, 2, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_transpose2x_ndhwc(x, self.weight, self.bias)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over NHWC through K1. Where an activation follows, the
    caller passes this module's parameters to ``norm_act_conv``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_act(x, self.num_groups, self.weight, self.bias,
                              self.eps)


def _convs_after_norm(model: nn.Module) -> Iterator[Conv2d]:
    """The 3x3 convs that ``norm_act_conv`` reaches: the last module of
    each Sequential led by a GroupNorm (a ResNetBlock's two halves) and
    each ``conv_out`` behind a ``norm_out`` (the encoder's and decoder's)."""
    for m in model.modules():
        if isinstance(m, nn.Sequential) and isinstance(m[0], GroupNorm):
            conv = m[-1]
        elif isinstance(getattr(m, "norm_out", None), GroupNorm):
            conv = m.conv_out
        else:
            continue
        if isinstance(conv, Conv2d) and conv.kernel_size == (3, 3):
            yield conv


@contextlib.contextmanager
def packed_for_export(model: nn.Module) -> Iterator[nn.Module]:
    """Inside the block, every 3x3 ``Conv2d`` of ``model`` that a K2 call
    reads holds its weight in K2's layout (in its compute type) in its
    ``export_packed`` buffer, so a program traced there (torch.export)
    keeps the packed weights as buffers, packed once, instead of packing
    at every call."""
    convs = list(_convs_after_norm(model))
    for m in convs:
        m.export_packed = cuda_gn_conv.pack_conv3x3_weight(m.weight,
                                                           m.compute_dtype)
    try:
        yield model
    finally:
        for m in convs:
            m.export_packed = None


def norm_act_conv(norm: GroupNorm, act: str, conv: nn.Module,
                  x: torch.Tensor) -> torch.Tensor:
    """conv(act(norm(x))): one K2 call for a 2-D 3x3 conv, else (another
    kernel size, a Conv3d) K1 then conv.
    The packed weight is the ``export_packed`` buffer where it is set,
    else the module's cache for a CUDA tensor. A trace (torch.export,
    torch.compile) reads pointers and version counts only as they were at
    tracing, so it must run inside ``packed_for_export``."""
    x = x.to(conv.compute_dtype)
    if conv.kernel_size != (3, 3):
        return conv(group_norm_act(x, norm.num_groups, norm.weight,
                                   norm.bias, norm.eps, act_name=act))
    packed = conv.export_packed
    if packed is None and torch.compiler.is_compiling():
        raise RuntimeError("trace the model inside nn.blocks."
                           "packed_for_export, which packs K2's weights once")
    if packed is None and x.is_cuda:
        packed = conv.packed_weight(x.dtype)
    return cuda_gn_conv.gn_act_conv3x3(
        x, norm.weight, norm.bias, conv.weight, conv.bias, norm.num_groups,
        norm.eps, act, packed=packed)


class ResNetBlock(nn.Module):
    """``conv``, where given, builds both convs as ``conv(cin, cout,
    zero_init=...)`` in place of a kernel_size Conv2d in compute_dtype
    (the volumetric CUNet passes Conv3d)."""

    def __init__(self, cin: int, features: int, num_groups: int = 8,
                 norm_eps: float = 1e-6, norm_affine: bool = True,
                 act: str = "gelu", kernel_size: int = 3,
                 dropout_prob: float = 0.0,
                 compute_dtype: torch.dtype = torch.float32,
                 conv: Optional[Callable[..., nn.Module]] = None):
        super().__init__()
        if conv is None:
            conv = functools.partial(Conv2d, kernel_size=kernel_size,
                                     compute_dtype=compute_dtype)
        self.act = act
        self.dropout_prob = dropout_prob
        self.net1 = nn.Sequential(
            GroupNorm(num_groups, cin, norm_eps, norm_affine),
            _ACT_MODULES[act](), conv(cin, features))
        net2 = [GroupNorm(num_groups, features, norm_eps, norm_affine),
                _ACT_MODULES[act]()]
        if dropout_prob > 0.0:
            net2.append(nn.Dropout(dropout_prob))
        net2.append(conv(features, features, zero_init=True))
        self.net2 = nn.Sequential(*net2)
        self.skip_conv = (Dense(cin, features, compute_dtype)
                          if cin != features else None)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                adds: Sequence[torch.Tensor] = ()) -> torch.Tensor:
        """``adds`` are added in turn after the first conv (the CUNet's
        conditioning projections)."""
        h = norm_act_conv(self.net1[0], self.act, self.net1[-1], x)
        for a in adds:
            h = h + a
        norm2, conv2 = self.net2[0], self.net2[-1]
        if deterministic or self.dropout_prob == 0.0:
            h = norm_act_conv(norm2, self.act, conv2, h)
        else:
            h = group_norm_act(h, norm2.num_groups, norm2.weight, norm2.bias,
                               norm2.eps, act_name=self.act)
            h = conv2(nn.functional.dropout(h, self.dropout_prob,
                                            training=True))
        if self.skip_conv is not None:
            x = self.skip_conv(x)
        return x + h


class AttnBlock(nn.Module):
    """Channel-major multi-head self-attention over the spatial grid: the
    channel index is c_idx * n_heads + head (tempo_tpu/nn/blocks.py
    AttnBlock), computed in fp32 with matmuls and softmax."""

    def __init__(self, channels: int, n_heads: int = 4, num_groups: int = 8,
                 norm_eps: float = 1e-6, norm_affine: bool = True,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if channels % n_heads:
            raise ValueError("channels must be divisible by n_heads")
        self.n_heads = n_heads
        self.compute_dtype = compute_dtype
        self.norm = GroupNorm(num_groups, channels, norm_eps, norm_affine)
        self.q = Dense(channels, channels, compute_dtype)
        self.k = Dense(channels, channels, compute_dtype)
        self.v = Dense(channels, channels, compute_dtype)
        self.proj_out = Dense(channels, channels, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n = self.n_heads
        ch = c // n
        h = self.norm(x)

        def heads(t: torch.Tensor) -> torch.Tensor:
            # [B, HW, c_per_head, n_heads] -> [B, n_heads, HW, c_per_head]
            return t.reshape(b, hh * ww, ch, n).float().permute(0, 3, 1, 2)

        q, k, v = heads(self.q(h)), heads(self.k(h)), heads(self.v(h))
        scores = torch.matmul(q, k.transpose(-1, -2)) * (float(ch) ** -0.5)
        out = torch.matmul(torch.softmax(scores, dim=-1), v)
        out = out.permute(0, 2, 3, 1).reshape(b, hh, ww, c)
        return x + self.proj_out(out.to(self.compute_dtype))


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """PyTorch's default init (uniform in +-1/sqrt(fan_in) for conv and
    linear weights and biases where they have one, fan_in from weight dim
    1 times the kernel, as torch computes it for the transposed convs too),
    from ``generator``; zeros for ``zero_init`` convs and linears;
    ones/zeros for GroupNorm."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Conv3d,
                          nn.ConvTranspose3d, nn.Linear)):
            if getattr(m, "zero_init", False):
                nn.init.zeros_(m.weight)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)
                continue
            fan_in = m.weight.shape[1] * math.prod(m.weight.shape[2:])
            bound = 1.0 / math.sqrt(fan_in)
            with torch.no_grad():
                m.weight.uniform_(-bound, bound, generator=generator)
                if m.bias is not None:
                    m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.GroupNorm) and m.affine:
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
