"""Weight-only int8 quantization for the GPT serving path, PyTorch.

Counterpart of tempo_tpu/nn/quant.py. Decode streams every weight once a
token, so the block matmul weights are stored int8 with an fp32 scale per
output channel and dequantized at the read, the matmul itself in the
compute type:

- ``QuantLinear`` (JAX's ``QuantDense``) holds ``kernel_q`` int8 [out, in]
  (the port's Linear layout: JAX's kernel transposed) and ``scale`` [out];
  y = x @ (kernel_q.to(dt) * scale.to(dt)).T + bias, JAX's order of
  rounding (cast, scale, then the matmul);
- ``QuantEmbedding`` holds the token table ``kernel_q`` int8 [V, d] with a
  per-row ``scale`` [V]: the embedding gathers rows, then dequantizes them;
  the tied head is (h @ kernel_q.T.to(dt)) * scale.to(dt), the scale after
  the matmul;
- the MoE expert kernels (nn/moe.py ``w1_q``/``w2_q``) are scaled per
  (expert, out-channel) after their einsums; the fp32 router, the position
  table and the LayerNorm / bias vectors stay float.

``quantize_lm_params`` turns a trained float state dict into the one a
``quantize='int8'`` model loads. Inference only: the int8 parameters hold
no gradient. ``jnp.round`` and ``torch.round`` both round half to even,
so the int8 values and scales are JAX's bit for bit.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from tempo_tpu_torch.nn.transformer import cast, cast_param

# block-level matmuls that dominate decode's weight traffic
QUANT_KERNELS = ("c_attn", "c_proj", "c_fc", "lm_head")


class QuantLinear(nn.Module):
    """Linear with an int8 kernel [out, in] and a per-output-channel fp32
    scale; forward in ``compute_dtype``."""

    def __init__(self, cin: int, cout: int, bias: bool,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.kernel_q = nn.Parameter(torch.zeros((cout, cin),
                                                 dtype=torch.int8),
                                     requires_grad=False)
        self.scale = nn.Parameter(torch.ones(cout), requires_grad=False)
        self.bias = (nn.Parameter(torch.zeros(cout), requires_grad=False)
                     if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.kernel_q.to(dt) * cast_param(self, self.scale, dt)[:, None]
        y = cast(x, dt) @ w.T
        if self.bias is not None:
            y = y + cast_param(self, self.bias, dt)
        return y


class QuantEmbedding(nn.Module):
    """The int8 token table [V, d] with a per-row fp32 scale [V]."""

    def __init__(self, vocab: int, dim: int):
        super().__init__()
        self.kernel_q = nn.Parameter(torch.zeros((vocab, dim),
                                                 dtype=torch.int8),
                                     requires_grad=False)
        self.scale = nn.Parameter(torch.ones(vocab), requires_grad=False)

    def embed(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """Gather the rows of ``x``'s ids, then dequantize them."""
        rows = F.embedding(x, self.kernel_q).to(dtype)
        return rows * F.embedding(x, self.scale[:, None]).to(dtype)

    def head(self, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """The tied head: the scale applied per logit after the matmul."""
        return ((h @ self.kernel_q.T.to(dtype))
                * cast_param(self, self.scale, dtype))


def _quantize(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over axis 1: scales absmax / 127 (1 where all are
    zero), then round half to even, clipped to [-127, 127]."""
    kernel = kernel.detach().float()
    absmax = kernel.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(kernel / scale), -127, 127)
    return q.to(torch.int8), scale.squeeze(1)


def quantize_kernel(kernel: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """A port Linear weight [out, in] -> (int8 [out, in], fp32 scale [out]):
    per-output-channel scales, JAX's ``quantize_kernel`` on the transposed
    kernel."""
    return _quantize(kernel)


def quantize_expert_kernel(kernel: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked MoE kernels [E, in, out] -> (int8 [E, in, out], fp32 scale
    [E, out]): per-(expert, output-channel) scales."""
    return _quantize(kernel)


def quantize_lm_params(state_dict: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """A float Transformer state dict -> the state dict of its
    ``quantize='int8'`` twin: every ``c_attn``/``c_proj``/``c_fc``/
    ``lm_head`` weight becomes ``kernel_q`` + ``scale`` (per output
    channel), the token table ``transformer.wte.weight`` becomes
    ``transformer.wte.kernel_q`` + ``scale`` (per row), the MoE ``w1``/``w2``
    become ``w1_q``/``w1_scale`` and ``w2_q``/``w2_scale``; every other
    entry (biases, LayerNorms, ``wpe``, the router) is kept."""
    out: Dict[str, torch.Tensor] = {}
    for name, value in state_dict.items():
        prefix, _, leaf = name.rpartition(".")
        module = prefix.rpartition(".")[2]
        if leaf == "weight" and (module in QUANT_KERNELS
                                 or name == "transformer.wte.weight"):
            out[f"{prefix}.kernel_q"], out[f"{prefix}.scale"] = \
                quantize_kernel(value)
        elif module == "moe" and leaf in ("w1", "w2"):
            out[f"{prefix}.{leaf}_q"], out[f"{prefix}.{leaf}_scale"] = \
                quantize_expert_kernel(value)
        else:
            out[name] = value
    return out
