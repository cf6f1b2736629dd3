"""K2: GroupNorm + activation + 3x3 SAME conv in one kernel.

Counterpart of tempo_tpu/ops/pallas_gn_conv.py (``_gn_conv_kernel``); the
CUDA source is csrc/gn_conv.cu, whose header says what bounds the kernel on
the H100 and how it is laid out. The GroupNorm statistics come from K1a
(ops/cuda_gn.py ``gn_stats``): ``gn_act_conv3x3`` launches K1a, then K2
through ``conv3x3_from_stats``, which launches K2 alone.

Each wrapper takes its plain version beside it for a tensor on the CPU, and
for a CUDA tensor launches the kernel or raises. ``choose_config`` picks the
bf16 kernel's tile configuration per call (``CONFIGS``, the table of the
.cu source). It counts its launches in ``LAUNCHES``. ``conv3x3_from_stats``
alone has no backward (its CUDA path raises NotImplementedError when a
graph is being built); ``gn_act_conv3x3`` builds a graph through
``GnActConv3x3Fn``, whose forward is K1a then K2 and whose backward
recomputes the plain chain (GroupNorm + act in fp32, cast to x's type, the
3x3 conv on cuDNN) and takes its vector-Jacobian product, the gradient
going to the fp32 OIHW weight, never to the packed copy
(tempo_tpu/ops/pallas_gn_conv.py ``_fwd``/``_bwd``).
"""

from __future__ import annotations

from typing import Optional

import torch

from tempo_tpu_torch.ops import _build, cuda_gn
from tempo_tpu_torch.ops.convs import conv2d_nhwc
from tempo_tpu_torch.ops.norms import group_norm

# Launches of the kernel, counted by its wrapper where it launches it.
LAUNCHES = {"gn_act_conv3x3": 0}

# The bf16 kernel's tile configurations, as csrc/gn_conv.cu's
# TEMPO_GN_CONV_CONFIGS lists them: name -> (id, warpgroups, tile rows,
# tile columns, output channels). A warpgroup owns 64 output pixels.
CONFIGS = {"m128n128": (0, 2, 8, 16, 128), "m64n64": (1, 1, 4, 16, 64)}
CHUNK = 64   # input channels a k chunk; the packed weight pads C and F to it
TAPS = 9
SMS = 132    # streaming multiprocessors of an H100 SXM: one wave of blocks


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def config_blocks(name: str, b: int, h: int, w: int, f: int) -> int:
    """Blocks of configuration ``name`` over a [B, H, W] x F output."""
    _, _, th, tw, bn = CONFIGS[name]
    return b * _ceil(h, th) * _ceil(w, tw) * _ceil(f, bn)


def choose_config(b: int, h: int, w: int, c: int,
                  f: int) -> tuple[str, int]:
    """The bf16 kernel's tile configuration and split of its k iterations
    (9 x the 64-channel chunks of C) for one call: 8x16 pixels x 128
    channels where that takes at most a split in two to fill a wave of
    blocks, else 4x16 x 64; either split over the k iterations until one
    wave is launched. No split is empty: every one has ceil(nk / split)
    iterations but the last.
    """
    nk = TAPS * _ceil(c, CHUNK)

    def split_for(n: int) -> int:
        """The fewest splits that take ``n`` blocks to a wave."""
        if n >= SMS:
            return 1
        kper = _ceil(nk, min(nk, _ceil(SMS, n)))
        return _ceil(nk, kper)

    n = config_blocks("m128n128", b, h, w, f)
    if f > 64 and 2 * n >= SMS:
        return "m128n128", split_for(n)
    return "m64n64", split_for(config_blocks("m64n64", b, h, w, f))


def pack_conv3x3_weight(weight: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """Conv2d weight [F, C, 3, 3] -> the kernel's [9, Cp, Fp] in ``dtype``:
    tap 3*di + dj, input channel, output channel, with C and F zero-padded
    up to multiples of 64 (whole k chunks and 128-byte rows for the kernel's
    16-byte copies)."""
    f, c = weight.shape[0], weight.shape[1]
    packed = torch.zeros((9, _ceil(c, CHUNK) * CHUNK, _ceil(f, 64) * 64),
                         dtype=dtype, device=weight.device)
    packed[:, :c, :f] = weight.detach().permute(2, 3, 1, 0).reshape(9, c, f)
    return packed


def gn_act_conv3x3_plain(x: torch.Tensor, scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], weight: torch.Tensor,
                         conv_bias: Optional[torch.Tensor], num_groups: int,
                         eps: float = 1e-6,
                         act: Optional[str] = "gelu") -> torch.Tensor:
    """Plain chain: GroupNorm + act, cast to x's type, zero-padded 3x3 conv
    (as tempo_tpu/ops/pallas_gn_conv.py ``_reference_chain``)."""
    h = group_norm(x, num_groups, scale, bias, eps, act)
    return conv2d_nhwc(h.to(x.dtype), weight, conv_bias, padding=1)


def conv3x3_from_stats_plain(x: torch.Tensor, stats: torch.Tensor,
                            scale: Optional[torch.Tensor],
                            bias: Optional[torch.Tensor], weight: torch.Tensor,
                            conv_bias: Optional[torch.Tensor],
                            act: Optional[str] = "gelu") -> torch.Tensor:
    """Plain kernel step: GroupNorm apply + act from K1a's ``stats``, in x's
    type, then the zero-padded 3x3 conv."""
    h = cuda_gn.gn_apply_plain(x, stats, scale, bias, act)
    return conv2d_nhwc(h, weight, conv_bias, padding=1)


def _gn_act_conv3x3(x, scale, bias, weight, conv_bias, num_groups, eps, act,
                    packed):
    """The forward: the plain chain on the CPU, else K1a then K2."""
    if x.device.type == "cpu":
        return gn_act_conv3x3_plain(x, scale, bias, weight, conv_bias,
                                    num_groups, eps, act)
    cuda_gn.check_cuda_input(x, "x")
    return conv3x3_from_stats(x, cuda_gn.gn_stats(x, num_groups, eps), scale,
                              bias, weight, conv_bias, act, packed)


class GnActConv3x3Fn(torch.autograd.Function):
    """K1a then K2 forward (the packed weight is not differentiated); the
    backward recomputes ``gn_act_conv3x3_plain`` from the saved (x, scale,
    bias, weight, conv_bias) and returns its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, x, scale, bias, weight, conv_bias, packed, num_groups,
                eps, act):
        ctx.save_for_backward(x, scale, bias, weight, conv_bias)
        ctx.config = (num_groups, eps, act)
        return _gn_act_conv3x3(x, scale, bias, weight, conv_bias, num_groups,
                               eps, act, packed)

    @staticmethod
    def backward(ctx, grad_out):
        num_groups, eps, act = ctx.config

        def plain(x, scale, bias, weight, conv_bias):
            return gn_act_conv3x3_plain(x, scale, bias, weight, conv_bias,
                                        num_groups, eps, act)

        grads = cuda_gn.recompute_vjp(plain, ctx.saved_tensors,
                                      ctx.needs_input_grad[:5], grad_out)
        return (*grads, None, None, None, None)


def gn_act_conv3x3(x: torch.Tensor, scale: Optional[torch.Tensor],
                   bias: Optional[torch.Tensor], weight: torch.Tensor,
                   conv_bias: Optional[torch.Tensor], num_groups: int,
                   eps: float = 1e-6, act: Optional[str] = "gelu",
                   packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, H, W, C], weight [F, C, 3, 3] -> [B, H, W, F] in x's type:
    K1a's statistics, then the K2 kernel; through ``GnActConv3x3Fn`` when a
    graph is being built.

    ``packed`` is the weight in the kernel's layout
    (``pack_conv3x3_weight(weight, x.dtype)``), which a module caches; when
    it is None the wrapper lays the weight out for this call."""
    if cuda_gn.wants_grad(x, scale, bias, weight, conv_bias):
        return GnActConv3x3Fn.apply(x, scale, bias, weight, conv_bias,
                                    packed, num_groups, eps, act)
    return _gn_act_conv3x3(x, scale, bias, weight, conv_bias, num_groups, eps,
                           act, packed)


def conv3x3_from_stats(x: torch.Tensor, stats: torch.Tensor,
                       scale: Optional[torch.Tensor],
                       bias: Optional[torch.Tensor], weight: torch.Tensor,
                       conv_bias: Optional[torch.Tensor],
                       act: Optional[str] = "gelu",
                       packed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2 alone: GroupNorm apply + act from K1a's [B, 2, C] ``stats``, then
    the 3x3 conv, in one kernel launch."""
    if x.device.type == "cpu":
        return conv3x3_from_stats_plain(x, stats, scale, bias, weight,
                                        conv_bias, act)
    cuda_gn.check_cuda_input(x, "x")
    cuda_gn.refuse_grad(x, scale, bias, weight, conv_bias)
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    f = weight.shape[0]
    if weight.shape != (f, c, 3, 3):
        raise ValueError(f"weight must be [F, {c}, 3, 3], got "
                         f"{tuple(weight.shape)}")
    if act not in cuda_gn.ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if (stats.shape != (b, 2, c) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous fp32 [B, 2, C] tensor "
                         "on x's device")
    if packed is None:
        packed = pack_conv3x3_weight(weight, x.dtype)
    cp, fp = _ceil(c, CHUNK) * CHUNK, _ceil(f, 64) * 64
    if (packed.shape != (9, cp, fp) or packed.dtype != x.dtype
            or packed.device != x.device or not packed.is_contiguous()):
        raise ValueError(f"packed weight must be a contiguous [9, {cp}, "
                         f"{fp}] tensor of x's type on x's device")
    config, split = (choose_config(b, h, w, c, f)
                     if x.dtype == torch.bfloat16 else (None, 1))
    # The kernel reads x, the statistics and the affine vectors as 16-byte
    # vectors from their base addresses; a view may start off that grain.
    x, stats, scale32, bias32 = (
        t if t.data_ptr() % 16 == 0 else t.clone()
        for t in (x, stats, cuda_gn.f32_param(scale, c, 1.0, x),
                  cuda_gn.f32_param(bias, c, 0.0, x)))
    cbias32 = cuda_gn.f32_param(conv_bias, f, 0.0, x)
    out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    # A split sums into an fp32 workspace that the kernel's second pass
    # reduces.
    ws = (torch.empty((split, b * h * w, f), dtype=torch.float32,
                      device=x.device) if split > 1 else None)
    err = _build.library().tempo_gn_conv3x3(
        x.data_ptr(), stats.data_ptr(), scale32.data_ptr(), bias32.data_ptr(),
        packed.data_ptr(), cbias32.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), cuda_gn.DTYPE_CODES[x.dtype],
        b, h, w, c, f, cuda_gn.ACT_CODES[act],
        -1 if config is None else CONFIGS[config][0], split,
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "tempo_gn_conv3x3")
    LAUNCHES["gn_act_conv3x3"] += 1
    return out
