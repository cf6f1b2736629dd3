"""Checkpoint-step and learning-rate schedules; counterpart of
tempo_tpu/train/schedules.py.

``lr_schedule`` returns the learning rate as a plain function of the update
count, the count optax passes its schedules: the first update is count 0,
so a warmup schedule's first update has lr 0. 'constant' (the reference's
default), 'cosine' (linear warmup, then cosine decay to min_lr: optax's
warmup_cosine_decay_schedule) and 'linear' (warmup, then linear decay:
optax's join of two linear schedules), with optax's formulas.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import numpy as np


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule: init -> end over ``steps`` counts, then end;
    constant init when steps <= 0."""
    if steps <= 0:
        return lambda count: init

    def schedule(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, decay_steps: int,
            alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""
    if not decay_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay_steps, got "
                         f"{decay_steps}")

    def schedule(count: int) -> float:
        decay = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                    / decay_steps))
        return init * ((1 - alpha) * decay + alpha)

    return schedule


def _join(first, second, boundary: int) -> Callable[[int], float]:
    """optax.join_schedules of two: ``second`` restarts its count at the
    boundary."""
    return lambda count: (first(count) if count < boundary
                          else second(count - boundary))


class Constant:
    """A constant learning rate as a schedule (a float where optax takes
    one: its optimizer state then holds no schedule count)."""

    def __init__(self, lr: float):
        self.lr = lr

    def __call__(self, count: int) -> float:
        return self.lr


def is_scheduled(learning_rate) -> bool:
    """Whether optax would count updates for this learning rate: a
    function of the count that is not ``Constant``."""
    return callable(learning_rate) and not isinstance(learning_rate,
                                                      Constant)


def lr_schedule(optimizer_cfg: Dict[str, Any],
                n_steps: int) -> Callable[[int], float]:
    cfg = optimizer_cfg or {}
    lr = float(cfg.get("lr", 1e-4))
    kind = str(cfg.get("schedule", "constant"))
    if kind == "constant":
        return Constant(lr)
    warmup = int(cfg.get("warmup_steps", 0))
    min_lr = float(cfg.get("min_lr", 0.0))
    decay_steps = int(cfg.get("decay_steps", n_steps))
    if not 0 <= warmup <= decay_steps:
        raise ValueError(
            f"FATAL: warmup_steps {warmup} outside [0, {decay_steps}]")
    start = 0.0 if warmup else lr
    if kind == "cosine":
        alpha = 0.0 if lr == 0.0 else min_lr / lr
        return _join(_linear(start, lr, warmup),
                     _cosine(lr, decay_steps - warmup, alpha), warmup)
    if kind == "linear":
        return _join(_linear(start, lr, max(warmup, 1)),
                     _linear(lr, min_lr, max(decay_steps - warmup, 1)),
                     warmup)
    raise ValueError(
        f"FATAL: optimizer.schedule must be 'constant', 'cosine' or "
        f"'linear', got {kind!r}")


def sqrt_save_steps(n_steps: int, n_saves: int = 100) -> List[int]:
    """The reference's sqrt checkpoint schedule: steps at
    sqrt(linspace(0, 1)) * n_steps, deduplicated, ending at n_steps."""
    sqrt_points = np.sqrt(np.linspace(0, 1, n_saves))
    save_steps = (sqrt_points * n_steps).astype(int)
    save_steps = sorted(set(save_steps.tolist()))
    if n_steps not in save_steps:
        save_steps.append(n_steps)
    return save_steps
