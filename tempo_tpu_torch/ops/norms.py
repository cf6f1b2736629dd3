"""GroupNorm (+fused activation) for NHWC activations.

Counterpart of tempo_tpu/ops/norms.py. Semantics match
torch.nn.GroupNorm(num_groups, C, eps, affine): per sample and per group,
normalize over (spatial x group-channels), then the affine transform.
Statistics are fp32 whatever the input type; var = max(E[x^2] - E[x]^2, 0);
the output is cast back to the input type.

``group_norm`` is the plain PyTorch op. ``group_norm_act`` is what the model
calls: it goes through the K1 wrapper (ops/cuda_gn.py), which launches the
CUDA kernels for a CUDA tensor and takes the plain op for a CPU tensor.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, as torch.nn.GELU(approximate='none')."""
    return F.gelu(x)


ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "gelu": gelu_exact,
    "relu": F.relu,
    "silu": F.silu,
}


def group_norm(x: torch.Tensor, num_groups: int,
               scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
               eps: float = 1e-6, act: Optional[str] = None) -> torch.Tensor:
    """Plain GroupNorm + optional named activation; x: [B, ..., C]."""
    from tempo_tpu_torch.ops import cuda_gn

    stats = cuda_gn.gn_stats_plain(x, num_groups, eps)
    return cuda_gn.gn_apply_plain(x, stats, scale, bias, act)


def group_norm_act(x: torch.Tensor, num_groups: int,
                   scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                   eps: float = 1e-6,
                   act_name: Optional[str] = None) -> torch.Tensor:
    """GroupNorm + optional named activation through the K1 kernels."""
    from tempo_tpu_torch.ops import cuda_gn

    return cuda_gn.fused_group_norm_act(x, scale, bias, num_groups, eps,
                                        act_name)
