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
    clip)."""

    learning_rate: Union[float, Schedule]
    param_groups: Callable[[nn.Module], list]
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    max_grad_norm: Optional[float] = None

    def lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def build(self, model: nn.Module) -> torch.optim.AdamW:
        return torch.optim.AdamW(self.param_groups(model), lr=self.lr(0),
                                 betas=self.betas, eps=self.eps)


@dataclasses.dataclass
class TrainState:
    """step counts the updates made; the model's parameters are fp32;
    ``generator`` draws the step's randomness (the VAE's posterior sample;
    the LM loss draws none); ``ema`` holds the EMA(0.99)-smoothed metrics as
    0-d fp32 tensors on the model's device, updated without a host sync
    (None before the trainer attaches it)."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    generator: torch.Generator
    ema: Optional[Dict[str, torch.Tensor]] = None


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
                          seed))
