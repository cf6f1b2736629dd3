"""Train state and optimizer construction; counterpart of
tempo_tpu/train/state.py.

``Optimizer`` is the port's counterpart of an optax GradientTransformation:
a recipe that builds a torch optimizer over a model's parameters, with the
learning rate as a function of the update count and an optional
global-norm clip applied before the update. The VAE recipe
(``make_optimizer``): global-norm clipping at 1.0, then AdamW(lr 1e-4,
betas (0.9, 0.95), eps 1e-8, weight decay 0.05) over ALL parameters, as the
reference's single parameter group. torch's AdamW decays decoupled from
the gradient, as optax.adamw does, so the two give the same update.
``MuAdamW`` is AdamW with its first moment stored in bf16 (optax's
``mu_dtype``), which torch's AdamW cannot do: it keeps its state in the
parameter's type.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch
from torch import nn

Schedule = Callable[[int], float]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``learning_rate``: a float or a function of the update count (0 for
    the first update, as optax counts). ``param_groups(model)``: torch
    parameter groups, each with its ``weight_decay``. ``max_grad_norm``:
    clip the gradients' global L2 norm to it before the update (None: no
    clip). ``moments_dtype``: 'bfloat16' builds ``MuAdamW`` (the first
    moment in bf16), None torch's AdamW."""

    learning_rate: Union[float, Schedule]
    param_groups: Callable[[nn.Module], list]
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    max_grad_norm: Optional[float] = None
    moments_dtype: Optional[str] = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def build(self, model: nn.Module) -> torch.optim.Optimizer:
        if self.moments_dtype == "bfloat16":
            return MuAdamW(self.param_groups(model), lr=self.lr(0),
                           betas=self.betas, eps=self.eps)
        if self.moments_dtype is not None:
            raise ValueError(f"unknown moments_dtype "
                             f"{self.moments_dtype!r}")
        return torch.optim.AdamW(self.param_groups(model), lr=self.lr(0),
                                 betas=self.betas, eps=self.eps)


class MuAdamW(torch.optim.Optimizer):
    """AdamW with the first moment ``exp_avg`` stored in bf16 and the second
    ``exp_avg_sq`` in fp32: optax.adamw(mu_dtype=bfloat16) in its order of
    operations, with foreach ops over each parameter group. A step: the new
    first moment in fp32 from the stored bf16 one and the gradient,
    (1 - b1) g + b1 mu; the second (1 - b2) g^2 + b2 nu; the update from the
    fp32 first moment, m / (1 - b1^t) / (sqrt(v / (1 - b2^t)) + eps), plus
    weight_decay * p, times -lr, added to p; only then is the first moment
    rounded to bf16 and stored. The bias corrections are computed in fp32,
    as optax computes them."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        assert closure is None, "MuAdamW takes no closure"
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(
                        p, dtype=torch.bfloat16,
                        memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.preserve_format)
            states = [self.state[p] for p in params]
            for st in states:
                st["step"] += 1
            grads = [p.grad.float() for p in params]
            mus = [st["exp_avg"] for st in states]
            nus = [st["exp_avg_sq"] for st in states]
            mu32 = torch._foreach_mul([m.float() for m in mus], b1)
            torch._foreach_add_(mu32, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1.0 - b2))
            # the update count of the group, the same for all its params
            count = torch.tensor(float(states[0]["step"]),
                                 dtype=torch.float32)
            bc1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** count
            bc2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** count
            denom = torch._foreach_sqrt(torch._foreach_div(nus, bc2.item()))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mu32, bc1.item()),
                                     denom)
            if group["weight_decay"] != 0.0:
                torch._foreach_add_(upd, torch._foreach_mul(
                    params, group["weight_decay"]))
            torch._foreach_add_(params, torch._foreach_mul(
                upd, -group["lr"]))
            for m, m32 in zip(mus, mu32):
                m.copy_(m32)

    def load_state_dict(self, state_dict) -> None:
        """torch casts a loaded state to its parameter's type: the first
        moment goes back to bf16 (a lossless round trip)."""
        super().load_state_dict(state_dict)
        for st in self.state.values():
            if "exp_avg" in st:
                st["exp_avg"] = st["exp_avg"].to(torch.bfloat16)


@dataclasses.dataclass
class TrainState:
    """step counts the updates made; the model's parameters are fp32;
    ``generator`` draws the step's randomness (the VAE's posterior sample;
    the LM loss's dropout masks, where the model has dropout); ``ema``
    holds the EMA(0.99)-smoothed metrics as 0-d fp32 tensors on the model's
    device, updated without a host sync (None before the trainer attaches
    it). ``wrapper``: the DDP replica the step runs the loss through under
    data parallelism (parallel/mesh.py ``shard_state``), None otherwise;
    ``model`` stays the plain module. Under FSDP2 (parallel/fsdp.py) the
    model itself is sharded in place and the optimizer's moments are
    DTensor shards; MuAdamW's foreach ops run on them as on tensors. Under
tensor parallelism (parallel/tensor.py) the sharded parameters are the
rank's slices and the optimizer holds their moments: AdamW is elementwise,
so each rank steps its own slices. ``tx``: the recipe the optimizer was
built from (the sharded checkpoint reads optax's layout off it)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    ema: Optional[Dict[str, torch.Tensor]] = None
    wrapper: Optional[nn.Module] = None
    tx: Optional[Optimizer] = None


def make_optimizer(lr: Union[float, Schedule] = 1e-4, betas=(0.9, 0.95),
                   eps: float = 1e-8, weight_decay: float = 0.05,
                   max_grad_norm: Optional[float] = 1.0) -> Optimizer:
    """Global-norm clip (optional) + AdamW over all parameters."""
    def groups(model: nn.Module) -> list:
        return [{"params": list(model.parameters()),
                 "weight_decay": weight_decay}]

    return Optimizer(lr, groups, tuple(betas), eps, max_grad_norm)


def make_optimizer_from_config(optimizer_config: Dict[str, Any],
                               max_grad_norm: Optional[float] = 1.0,
                               n_steps: Optional[int] = None) -> Optimizer:
    """From a training config's ``optimizer`` section (reference schema);
    ``schedule: cosine|linear`` needs n_steps (or decay_steps) for its
    horizon, as in tempo_tpu."""
    from tempo_tpu_torch.train.schedules import lr_schedule

    cfg = optimizer_config or {}
    if (cfg.get("schedule", "constant") != "constant" and n_steps is None
            and "decay_steps" not in cfg):
        raise ValueError(
            "FATAL: optimizer.schedule needs n_steps (or an explicit "
            "optimizer.decay_steps) for the decay horizon")
    return make_optimizer(
        lr=lr_schedule(cfg, n_steps if n_steps is not None else 0),
        betas=tuple(cfg.get("betas", (0.9, 0.95))),
        eps=cfg.get("eps", 1e-8),
        weight_decay=cfg.get("weight_decay", 0.05),
        max_grad_norm=max_grad_norm)


def create_train_state(model: nn.Module, tx: Optimizer,
                       seed: int = 0) -> TrainState:
    """A fresh state: step 0, the optimizer built over ``model`` and a
    generator on the model's device seeded with ``seed``."""
    device = next(model.parameters()).device
    return TrainState(step=0, model=model, optimizer=tx.build(model),
                      generator=torch.Generator(device=device).manual_seed(
                          seed), tx=tx)
