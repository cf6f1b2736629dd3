"""Stochastic flow matching and its SDE integrators; counterpart of
tempo_tpu/models/flow.py with the same math:

- the default schedule alpha_t = 1 - t, beta_t = t^2, sigma_t = 1 - t and
  their derivatives; the interpolant x_t = alpha_t x0 + beta_t x1 +
  sqrt(t) sigma_t eps and its drift target r_t;
- the loss: MSE between the velocity model's drift prediction and r_t,
  the source sample x0 fed as spatial conditioning;
- integration: Euler-Maruyama, or Leimkuhler-Matthews (dW over sqrt(2)),
  a Python loop over the steps with no noise on the last one.

Randomness is explicit: ``compute_loss`` takes ``t`` and ``epsilon`` or
draws them from a generator; ``sde_integrate`` and ``predict`` take each
step's draw (``noise``) or draw it from a generator.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

DriftFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
SigmaFn = Callable[[torch.Tensor], torch.Tensor]


def sde_integrate(drift_fn: DriftFn, sigma_fn: SigmaFn, x0: torch.Tensor,
                  n_steps: int, generator: Optional[torch.Generator] = None,
                  method: str = "euler",
                  noise: Optional[Sequence[torch.Tensor]] = None
                  ) -> torch.Tensor:
    """Integrate dx = b(t, x, x0) dt + sigma(t) dW from t = 0 to 1.

    method 'euler' (Euler-Maruyama) or 'lm' (Leimkuhler-Matthews: dW
    scaled by 1/sqrt(2)). Step i draws ``noise[i]`` when given, else a
    standard normal from ``generator`` (the last step too, whose noise is
    then dropped, as the JAX package draws it)."""
    if method not in ("euler", "lm"):
        raise ValueError(f"unknown SDE method {method!r}")
    dt = 1.0 / n_steps
    noise_scale = math.sqrt(dt) / (math.sqrt(2.0) if method == "lm" else 1.0)
    x = x0
    for i in range(n_steps):
        t = torch.tensor(i * dt, dtype=torch.float32, device=x0.device)
        draw = (noise[i] if noise is not None else torch.randn(
            x0.shape, generator=generator, device=x0.device))
        dw = (0.0 if i == n_steps - 1 else noise_scale) * draw
        x = x + drift_fn(t, x, x0) * dt + sigma_fn(t) * dw
    return x


class SFM(nn.Module):
    """Stochastic flow matching from x0-samples to x1-samples.
    ``velocity_model`` is called as (x_t, t=..., s_conditioning=x0,
    v_conditionings=h): a CUNet with s_conditioning_channels = x0's."""

    def __init__(self, velocity_model: nn.Module,
                 noise_schedule: str = "default"):
        super().__init__()
        if noise_schedule != "default":
            raise ValueError(f"unknown noise schedule {noise_schedule!r}")
        self.velocity_model = velocity_model
        self.noise_schedule = noise_schedule

    @property
    def device(self) -> torch.device:
        return next(self.velocity_model.parameters()).device

    @staticmethod
    def alpha_t(t):
        return 1.0 - t

    @staticmethod
    def beta_t(t):
        return t ** 2

    @staticmethod
    def sigma_t(t):
        return 1.0 - t

    @staticmethod
    def alpha_t_dot(t):
        return -torch.ones_like(t)

    @staticmethod
    def beta_t_dot(t):
        return 2.0 * t

    @staticmethod
    def sigma_t_dot(t):
        return -torch.ones_like(t)

    @staticmethod
    def _per_sample(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return t.reshape((t.shape[0],) + (1,) * (x.ndim - 1))

    def get_xt(self, x0, x1, t, epsilon):
        """x_t = alpha_t x0 + beta_t x1 + sqrt(t) sigma_t eps."""
        t = self._per_sample(t, x0)
        return (self.alpha_t(t) * x0 + self.beta_t(t) * x1
                + torch.sqrt(t) * self.sigma_t(t) * epsilon)

    def get_rt(self, x0, x1, t, epsilon):
        """The drift target d x_t / dt at fixed eps."""
        t = self._per_sample(t, x0)
        return (self.alpha_t_dot(t) * x0 + self.beta_t_dot(t) * x1
                + self.sigma_t_dot(t) * torch.sqrt(t) * epsilon)

    def forward(self, x0, x1, h=None, generator=None, t=None, epsilon=None):
        return self.compute_loss(x0, x1, h=h, generator=generator, t=t,
                                 epsilon=epsilon)

    def compute_loss(self, x0: torch.Tensor, x1: torch.Tensor,
                     h: Optional[Sequence[torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None,
                     t: Optional[torch.Tensor] = None,
                     epsilon: Optional[torch.Tensor] = None) -> torch.Tensor:
        """MSE between the predicted drift and r_t; t ~ U[0, 1) then
        eps ~ N(0, 1) from ``generator`` unless given."""
        if t is None:
            t = torch.rand((x0.shape[0],), generator=generator,
                           device=x0.device)
        if epsilon is None:
            epsilon = torch.randn(x0.shape, generator=generator,
                                  device=x0.device)
        xt = self.get_xt(x0, x1, t, epsilon)
        rt = self.get_rt(x0, x1, t, epsilon)
        b_pred = self.velocity_model(xt, t=t, s_conditioning=x0,
                                     v_conditionings=h)
        return torch.mean((b_pred.float() - rt).square())


def predict(model: SFM, x0: torch.Tensor,
            generator: Optional[torch.Generator] = None,
            h: Optional[Sequence[torch.Tensor]] = None,
            n_sampling_steps: int = 100, method: str = "euler",
            noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Push x0 through the learned flow by integrating the SDE, without
    gradients (each step's draw from ``noise`` or ``generator``)."""

    def drift_fn(t, xt, x0_):
        return model.velocity_model(
            xt, t=torch.broadcast_to(t, (x0.shape[0],)),
            s_conditioning=x0_, v_conditionings=h)

    with torch.no_grad():
        return sde_integrate(drift_fn, SFM.sigma_t, x0, n_sampling_steps,
                             generator, method=method, noise=noise)
