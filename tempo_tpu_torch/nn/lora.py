"""LoRA (low-rank adaptation) fine-tuning over a frozen model, PyTorch.

Counterpart of tempo_tpu/nn/lora.py on the port's named parameters: the
base stays frozen, and rank-r factor pairs (a, b) attached to its matmul
weights are the only trainable state. An adapter holds JAX's orientation,
``a`` [..., in, r] ~ N(0, stddev^2) and ``b`` [..., r, out] = 0 (so step 0
is exactly the base), and the delta scale * a @ b is computed in fp32 and
cast to the weight's type at the add. The targets are JAX's
(``DEFAULT_TARGETS``): the dense ``kernel``s, which are the port's Linear
``weight`` [out, in] (the delta is added transposed; the MoE router's
too), and the stacked MoE ``w1``/``w2`` [E, in, out] (batched factors
[E, in, r] / [E, r, out]). Embeddings, norms and biases are not adapted.

``LoRA`` is the trainable module: its parameters are the adapters only
(``adapters.<name with '/' for '.'>.{a,b}``), the base is held outside its
tree (it is neither saved in its checkpoints nor seen by its optimizer),
and its forward is the base's forward through ``torch.func.functional_call``
with the merged weights, so the base's kernels (K5 in training) run as
they are. The adapters take no weight decay: ``a``/``b`` are not among
JAX's decayed names (nn/transformer.py ``gpt_decay_mask``).
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

DEFAULT_TARGETS: Tuple[str, ...] = ("kernel", "w1", "w2")

Adapters = Dict[str, Dict[str, torch.Tensor]]


def _leaf_role(model: nn.Module, name: str) -> str:
    """The JAX leaf name of the port parameter ``name``: 'kernel' for a
    Linear's weight, the parameter's own name otherwise."""
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    if leaf == "weight" and isinstance(mod, nn.Linear):
        return "kernel"
    return leaf


def _transposed(name: str) -> bool:
    """A Linear weight is [out, in]: JAX's kernel transposed."""
    return name.endswith(".weight")


def init_lora(model: nn.Module, rank: int, seed: int = 0,
              targets: Sequence[str] = DEFAULT_TARGETS,
              stddev: float = 0.01) -> Adapters:
    """{parameter name: {'a': [..., in, r] ~ N(0, stddev^2), 'b': [..., r,
    out] = 0}} for every targeted parameter of ``model`` with ndim >= 2, in
    ``named_parameters`` order, the draws from a CPU generator seeded with
    ``seed`` and moved to the parameter's device (JAX's threefry stream is
    not reproduced: tests bridge JAX's adapters instead)."""
    if rank < 1:
        raise ValueError(f"FATAL: lora rank must be >= 1, got {rank}")
    gen = torch.Generator().manual_seed(seed)
    out: Adapters = {}
    for name, p in model.named_parameters():
        if _leaf_role(model, name) not in targets or p.ndim < 2:
            continue
        shape = tuple(p.shape)
        if _transposed(name):
            shape = shape[:-2] + (shape[-1], shape[-2])
        lead, n_in, n_out = shape[:-2], shape[-2], shape[-1]
        out[name] = {
            "a": (stddev * torch.randn(lead + (n_in, rank),
                                       generator=gen)).to(p.device),
            "b": torch.zeros(lead + (rank, n_out), device=p.device)}
    if not out:
        raise ValueError(f"FATAL: no parameters named {tuple(targets)} with "
                         f"ndim>=2 found — nothing to adapt")
    return out


def lora_delta(name: str, a: torch.Tensor, b: torch.Tensor,
               scale: float) -> torch.Tensor:
    """scale * a @ b in fp32 over the last two axes, in the port's layout
    of the parameter ``name``."""
    delta = scale * torch.matmul(a.float(), b.float())
    return delta.transpose(-1, -2) if _transposed(name) else delta


def apply_lora(params: Dict[str, torch.Tensor], lora: Adapters,
               scale: float = 1.0) -> Dict[str, torch.Tensor]:
    """``params`` with W := W + scale * a @ b on every adapted entry (the
    delta in fp32, cast to W's type at the add); the others as they are."""
    out = dict(params)
    for name, ab in lora.items():
        w = params[name]
        out[name] = w + lora_delta(name, ab["a"], ab["b"], scale).to(w.dtype)
    return out


# merging is the same computation: the name marks a one-time export (a
# plain checkpoint, quantization, a serving artifact)
merge_lora = apply_lora


def num_lora_params(lora: Adapters) -> int:
    return sum(t.numel() for ab in lora.values() for t in ab.values())


def adapted_call(base: nn.Module, lora: Adapters, scale: float, args,
                 kwargs):
    """``base(*args, **kwargs)`` with the adapted weights replaced by
    W + scale * a @ b (torch.func.functional_call: the base is not
    modified, and the gradient reaches the adapters)."""
    params = dict(base.named_parameters())
    adapted = apply_lora({n: params[n] for n in lora}, lora, scale)
    return torch.func.functional_call(base, adapted, args, kwargs)


class _Adapter(nn.Module):
    def __init__(self, a: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.a = nn.Parameter(a)
        self.b = nn.Parameter(b)


class LoRA(nn.Module):
    """Trainable adapters over a frozen ``base`` (the base's parameters are
    set to requires_grad False). forward(*args, **kwargs) is the base's
    forward with the merged weights; ``config`` is the base's, so the
    base's loss functions (train/step.py ``lm_loss_fn``) take a LoRA as
    they take the base."""

    def __init__(self, base: nn.Module, lora: Adapters, scale: float = 1.0):
        super().__init__()
        base.requires_grad_(False)
        self._base = (base,)  # outside the module tree: not saved
        self.scale = float(scale)
        self.adapters = nn.ModuleDict({
            name.replace(".", "/"): _Adapter(ab["a"], ab["b"])
            for name, ab in lora.items()})

    @property
    def base(self) -> nn.Module:
        return self._base[0]

    @property
    def config(self):
        return self.base.config

    @property
    def device(self) -> torch.device:
        return next(self.base.parameters()).device

    def lora(self) -> Adapters:
        """The adapters as {parameter name: {'a', 'b'}} (the live
        parameters)."""
        return {key.replace("/", "."): {"a": m.a, "b": m.b}
                for key, m in self.adapters.items()}

    def merged_state_dict(self) -> Dict[str, torch.Tensor]:
        """The base's state dict with the adapters merged in, detached:
        a plain checkpoint of the fine-tuned model."""
        with torch.no_grad():
            merged = merge_lora(self.base.state_dict(), self.lora(),
                                self.scale)
        return {k: v.detach() for k, v in merged.items()}

    def forward(self, *args, **kwargs):
        return adapted_call(self.base, self.lora(), self.scale, args, kwargs)


class _Adapted(nn.Module):
    """The base's forward over plain adapter tensors (``lora_loss_fn``)."""

    def __init__(self, base: nn.Module, lora: Adapters, scale: float):
        super().__init__()
        self._held = (base, lora, scale)

    @property
    def config(self):
        return self._held[0].config

    def forward(self, *args, **kwargs):
        base, lora, scale = self._held
        return adapted_call(base, lora, scale, args, kwargs)


def lora_loss_fn(loss_fn: Callable, base: nn.Module,
                 scale: float = 1.0) -> Callable:
    """Wrap a (model, *args) loss into a (lora, *args) loss over the frozen
    ``base`` (its parameters set to requires_grad False): ``lora`` is an
    Adapters dict, and the gradient reaches only its tensors."""
    base.requires_grad_(False)

    def wrapped(lora: Adapters, *args, **kwargs):
        return loss_fn(_Adapted(base, lora, scale), *args, **kwargs)

    return wrapped
