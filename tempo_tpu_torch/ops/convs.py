"""Conv primitives over NHWC activations.

Counterpart of tempo_tpu/ops/convs.py. Activations stay NHWC [B, H, W, C]
as in the JAX package; weights keep PyTorch's layouts (Conv2d OIHW,
ConvTranspose2d [in, out, kh, kw]) so reference checkpoints load as they
are. A convolution runs as F.conv2d on the channels_last NCHW view of the
NHWC tensor, which is a view, not a copy.

The kernel-2 stride-2 down/up resamples, which the JAX package computes as
space-to-depth + matmul and matmul + depth-to-space, are here the strided
Conv2d and ConvTranspose2d they are algebraically equal to. The volumetric
counterparts over NDHWC (the dim=3 CUNet) are ``conv3d_ndhwc`` and
``conv_transpose2x_ndhwc`` (F.conv3d and F.conv_transpose3d). The TPU lane
tricks (the ragged channel split, boundary lane padding) are not ported:
they do not change the numbers.

Weights are cast to the activation type and the bias is added after the
conv in that type, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, stride: int = 1,
                padding: int = 0) -> torch.Tensor:
    """x [B, H, W, C], weight [F, C, kh, kw] -> [B, H', W', F] in x's type,
    zero padding."""
    out = F.conv2d(_nchw(x), weight.to(x.dtype), stride=stride,
                   padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return _nhwc(out)


def conv_transpose2x_nhwc(x: torch.Tensor, weight: torch.Tensor,
                          bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Kernel-2 stride-2 transposed conv: x [B, H, W, C], weight
    [C, F, 2, 2] -> [B, 2H, 2W, F] in x's type."""
    out = F.conv_transpose2d(_nchw(x), weight.to(x.dtype), stride=2)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None]
    return _nhwc(out)


def _ncdhw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 4, 1, 2, 3)


def _ndhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 4, 1).contiguous()


def conv3d_ndhwc(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None, stride: int = 1,
                 padding: int = 0) -> torch.Tensor:
    """x [B, D, H, W, C], weight [F, C, kd, kh, kw] -> [B, D', H', W', F]
    in x's type, zero padding."""
    out = F.conv3d(_ncdhw(x), weight.to(x.dtype), stride=stride,
                   padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None, None]
    return _ndhwc(out)


def conv_transpose2x_ndhwc(x: torch.Tensor, weight: torch.Tensor,
                           bias: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Kernel-2 stride-2 transposed 3-D conv: x [B, D, H, W, C], weight
    [C, F, 2, 2, 2] -> [B, 2D, 2H, 2W, F] in x's type."""
    out = F.conv_transpose3d(_ncdhw(x), weight.to(x.dtype), stride=2)
    if bias is not None:
        out = out + bias.to(out.dtype)[:, None, None, None]
    return _ndhwc(out)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Channel-last matmul (a 1x1 conv): weight [F, C] or [F, C, 1, 1]."""
    w = weight.reshape(weight.shape[0], weight.shape[1]).to(x.dtype)
    out = torch.matmul(x, w.t())
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out
