"""Variational diffusion (VDM) and its noise schedules; counterpart of
tempo_tpu/models/diffusion.py with the same math:

- the continuous-time ELBO in bits/dim: the diffusion loss
  0.5 ||eps_hat - eps||^2 dgamma/dt, the latent KL to N(0, 1) at t = 1 and
  the Gaussian reconstruction term at t = 0;
- dgamma/dt from ``torch.func.jvp`` of the schedule alone (the JAX
  package's ``jax.jvp``): forward-mode, so no double backward runs through
  the score model or the kernels, and a learned schedule's parameters get
  their gradient through the derivative by the one backward of the step;
- classifier-free guidance: conditioning dropout with probability
  ``p_cfg`` in training (masked v-conditionings set to -1) and the guided
  prediction eps_u + w_cfg (eps_c - eps_u) in sampling;
- ancestral (Eq. 34, with the DDNM decomposition) and DDIM steps, and
  ``sample``, a Python loop over the steps from t = 1 to t = 0.

Randomness is explicit: every stochastic entry takes a torch.Generator,
or the draws themselves (``times``, ``noise``, ``noise_0``; the samplers'
``z`` and each step's ``noise``), so a test can feed the JAX package's
draws. The score model is called deterministically (its dropout never
drops), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from tempo_tpu_torch.nn.blocks import init_weights


def kl_std_normal(mean_squared: torch.Tensor,
                  var: torch.Tensor) -> torch.Tensor:
    """KL(N(m, var) || N(0, 1)) per element."""
    return 0.5 * (var + mean_squared - torch.log(torch.clamp(var, min=1e-15))
                  - 1.0)


class FixedLinearSchedule(nn.Module):
    """gamma(t) = gamma_min + (gamma_max - gamma_min) t."""

    def __init__(self, gamma_min: float, gamma_max: float):
        super().__init__()
        self.gamma_min, self.gamma_max = gamma_min, gamma_max

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.gamma_min + (self.gamma_max - self.gamma_min) * t


class SigmoidSchedule(nn.Module):
    """The sigmoid-warped schedule -log(1 / (a t + b) - 1)."""

    def __init__(self, gamma_min: float, gamma_max: float):
        super().__init__()
        self.b = 1.0 / (math.exp(-gamma_min) + 1.0)
        self.a = 1.0 / (math.exp(-gamma_max) + 1.0) - self.b

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return -torch.log(1.0 / (self.a * t + self.b) - 1.0)


class LearnedLinearSchedule(nn.Module):
    """gamma(t) = b + |w| t with learned scalars (monotone)."""

    def __init__(self, gamma_min: float, gamma_max: float):
        super().__init__()
        self.b = nn.Parameter(torch.tensor(float(gamma_min)))
        self.w = nn.Parameter(torch.tensor(float(gamma_max - gamma_min)))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        return self.b + torch.abs(self.w) * t


class MonotonicLinear(nn.Linear):
    """Linear with |weight|: every output is non-decreasing in every input
    (tempo_tpu's MonotonicDense; weight [out, in] as the reference's)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.linear(x, torch.abs(self.weight), self.bias)


class NNSchedule(nn.Module):
    """A linear ramp plus a bounded monotone MLP correction; l1 starts at
    the plain gamma ramp, l2 and l3 at PyTorch's default init."""

    def __init__(self, gamma_min: float, gamma_max: float,
                 mid_dim: int = 1024):
        super().__init__()
        self.gamma_min, self.gamma_max = gamma_min, gamma_max
        self.mid_dim = mid_dim
        self.l1 = MonotonicLinear(1, 1)
        self.l2 = MonotonicLinear(1, mid_dim)
        self.l3 = MonotonicLinear(mid_dim, 1, bias=False)

    def reset_ramp(self) -> None:
        """l1 to the plain gamma ramp (after the default init)."""
        with torch.no_grad():
            self.l1.weight.fill_(self.gamma_max - self.gamma_min)
            self.l1.bias.fill_(self.gamma_min)

    def forward(self, t: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        shape = t.shape
        t = t.to(torch.float32).reshape(-1, 1)
        g = self.l1(t)
        h = torch.sigmoid(self.l2(2.0 * (t - 0.5)))
        g = g + self.l3(2.0 * (h - 0.5)) / self.mid_dim * scale
        return g.reshape(shape)


SCHEDULES = {
    "fixed_linear": FixedLinearSchedule,
    "sigmoid": SigmoidSchedule,
    "learned_linear": LearnedLinearSchedule,
    "learned_nn": NNSchedule,
}


class VDM(nn.Module):
    """Continuous-time variational diffusion model over ``score_model`` (a
    CUNet or CMLP called as (x, t=..., **conditioning) -> predicted
    noise). A learned schedule is built on the score model's device from a
    generator seeded with ``seed``."""

    def __init__(self, score_model: nn.Module,
                 noise_schedule: str = "fixed_linear",
                 gamma_min: float = -13.3, gamma_max: float = 5.0,
                 antithetic_time_sampling: bool = True,
                 data_noise: float = 1.0e-3, p_cfg: Optional[float] = None,
                 w_cfg: Optional[float] = None, seed: int = 0):
        super().__init__()
        if noise_schedule not in SCHEDULES:
            raise ValueError(f"Unknown noise schedule {noise_schedule}")
        self.score_model = score_model
        self.noise_schedule = noise_schedule
        self.gamma_min, self.gamma_max = gamma_min, gamma_max
        self.antithetic_time_sampling = antithetic_time_sampling
        self.data_noise = data_noise
        self.p_cfg, self.w_cfg = p_cfg, w_cfg
        dev = next(score_model.parameters()).device
        with torch.device(dev):
            self.gamma = SCHEDULES[noise_schedule](gamma_min, gamma_max)
        init_weights(self.gamma, torch.Generator(device=dev).manual_seed(seed))
        if isinstance(self.gamma, NNSchedule):
            self.gamma.reset_ramp()

    @property
    def device(self) -> torch.device:
        return next(self.score_model.parameters()).device

    # --- schedule-derived quantities

    @staticmethod
    def alpha(gamma_t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.sigmoid(-gamma_t))

    @staticmethod
    def sigma(gamma_t: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.sigmoid(gamma_t))

    def gamma_and_grad(self, times: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(gamma(t), dgamma/dt) by one forward-mode pass over the
        schedule alone."""
        return torch.func.jvp(self.gamma, (times,), (torch.ones_like(times),))

    def variance_preserving_map(self, x: torch.Tensor, times: torch.Tensor,
                                noise: torch.Tensor):
        """z_t = alpha(t) x + sigma(t) eps; returns (z_t, gamma_t) with
        gamma_t broadcast as [B, 1, ...]."""
        times = times.reshape((-1,) + (1,) * (x.ndim - 1))
        gamma_t = self.gamma(times)
        return self.alpha(gamma_t) * x + noise * self.sigma(gamma_t), gamma_t

    def sample_times(self, batch_size: int,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        """Antithetic (low-discrepancy) or iid U[0, 1) times."""
        dev = self.device
        if self.antithetic_time_sampling:
            t0 = torch.rand((), generator=generator, device=dev) / batch_size
            return t0 + torch.arange(batch_size, device=dev) / batch_size
        return torch.rand((batch_size,), generator=generator, device=dev)

    # --- prediction (with classifier-free guidance)

    def get_pred_noise(self, zt: torch.Tensor, gamma_t: torch.Tensor,
                       guided: bool = False, **kwargs) -> torch.Tensor:
        """The score model on normalized time; with ``guided`` and
        ``w_cfg``, the CFG combination of the unconditional (every v = -1)
        and the conditional prediction."""
        t_norm = (gamma_t - self.gamma_min) / (self.gamma_max
                                               - self.gamma_min)
        if not (guided and self.w_cfg is not None):
            return self.score_model(zt, t=t_norm, **kwargs)
        v_conds = kwargs.pop("v_conditionings")
        uncond = [torch.full_like(v, -1.0) for v in v_conds]
        eps_u = self.score_model(zt, t=t_norm, v_conditionings=uncond,
                                 **kwargs)
        eps_c = self.score_model(zt, t=t_norm, v_conditionings=v_conds,
                                 **kwargs)
        return eps_u + self.w_cfg * (eps_c - eps_u)

    # --- training loss

    def forward(self, x, generator=None, noise=None, times=None,
                noise_0=None, reduction: str = "mean", **kwargs):
        return self.get_loss(x, generator, noise=noise, times=times,
                             noise_0=noise_0, reduction=reduction, **kwargs)

    def get_loss(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None,
                 times: Optional[torch.Tensor] = None,
                 noise_0: Optional[torch.Tensor] = None,
                 reduction: str = "mean", **kwargs
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The per-sample ELBO in bits/dim and its three terms. What is not
        given is drawn from ``generator`` in the JAX package's order: the
        CFG mask, the times, the diffused noise, the reconstruction
        noise."""
        b, dev = x.shape[0], x.device
        if self.p_cfg is not None:
            if "v_conditionings" not in kwargs:
                raise ValueError("CFG needs v_conditionings")
            mask = torch.rand((b,), generator=generator,
                              device=dev) < self.p_cfg
            kwargs["v_conditionings"] = [
                torch.where(mask[:, None], torch.full_like(v, -1.0), v)
                for v in kwargs["v_conditionings"]]

        bpd_factor = 1.0 / (math.prod(x.shape[1:]) * math.log(2.0))
        if times is None:
            times = self.sample_times(b, generator)
        if noise is None:
            noise = torch.randn(x.shape, generator=generator, device=dev)
        x_t, gamma_t_full = self.variance_preserving_map(x, times, noise)
        pred_noise = self.get_pred_noise(x_t, gamma_t_full.reshape(b),
                                         **kwargs)

        _, gamma_grad = self.gamma_and_grad(times)
        pred_loss = torch.sum((pred_noise.float() - noise).square()
                              .reshape(b, -1), dim=-1)
        diffusion_loss = bpd_factor * 0.5 * pred_loss * gamma_grad

        gamma_1 = self.gamma(torch.tensor(1.0, device=dev))
        sigma_1_sq = torch.sigmoid(gamma_1)
        mean_sq = (1.0 - sigma_1_sq) * x.float().square()
        latent_loss = bpd_factor * torch.sum(
            kl_std_normal(mean_sq, sigma_1_sq).reshape(b, -1), dim=-1)

        if noise_0 is None:
            noise_0 = torch.randn(x.shape, generator=generator, device=dev)
        z_0, gamma_0 = self.variance_preserving_map(
            x, torch.zeros((b,), device=dev), noise_0)
        z_0_rescaled = z_0 / torch.sqrt(torch.sigmoid(-gamma_0))
        log_prob = (-0.5 * ((x - z_0_rescaled) / self.data_noise) ** 2
                    - math.log(self.data_noise)
                    - 0.5 * math.log(2.0 * math.pi))
        recons_loss = -bpd_factor * torch.sum(log_prob.reshape(b, -1), dim=-1)

        loss = diffusion_loss + latent_loss + recons_loss
        metrics = {"elbo": loss, "diffusion_loss": diffusion_loss,
                   "latent_loss": latent_loss,
                   "reconstruction_loss": recons_loss}
        if reduction == "mean":
            metrics = {k: v.mean() for k, v in metrics.items()}
            return loss.mean(), metrics
        return loss, metrics

    # --- reverse steps

    def sample_zs_given_zt(self, zt: torch.Tensor, t, s,
                           generator: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           return_ddnm: bool = False, **kwargs):
        """One ancestral step p(z_s | z_t) (Eq. 34); ``return_ddnm`` gives
        the (w_z, w_x0, x0_pred, scale) decomposition instead."""
        t, s = self._time(t), self._time(s)
        gamma_t, gamma_s = self.gamma(t), self.gamma(s)
        c = -torch.expm1(gamma_s - gamma_t)
        alpha_t, alpha_s = self.alpha(gamma_t), self.alpha(gamma_s)
        sigma_t, sigma_s = self.sigma(gamma_t), self.sigma(gamma_s)
        pred_noise = self.get_pred_noise(zt, gamma_t, guided=True, **kwargs)
        if not return_ddnm:
            mean = alpha_s / alpha_t * (zt - c * sigma_t * pred_noise)
            scale = sigma_s * torch.sqrt(c)
            if noise is None:
                noise = torch.randn(zt.shape, generator=generator,
                                    device=zt.device)
            return mean + scale * noise
        gamma_0 = self.gamma(self._time(0.0))
        alpha_0 = self.alpha(gamma_0)
        c0 = -torch.expm1(gamma_0 - gamma_t)
        x_0t = alpha_0 / alpha_t * (zt - c0 * sigma_t * pred_noise)
        alpha_ts = alpha_t / alpha_s
        sigma_ts_sq = sigma_t ** 2 - alpha_ts ** 2 * sigma_s ** 2
        w_z = alpha_ts * (sigma_s / sigma_t) ** 2
        w_x_0t = alpha_s * sigma_ts_sq / sigma_t ** 2
        scale = torch.sqrt(sigma_ts_sq * (sigma_s / sigma_t) ** 2)
        return w_z, w_x_0t, x_0t, scale

    def sample_zs_given_zt_ddim(self, zt: torch.Tensor, t, s,
                                eta: float = 0.0,
                                generator: Optional[torch.Generator] = None,
                                noise: Optional[torch.Tensor] = None,
                                **kwargs) -> torch.Tensor:
        """One DDIM step in the gamma parameterization:
        z_s = alpha_s x0_pred + sqrt(sigma_s^2 - var) eps_pred
        + sqrt(var) xi, var = eta^2 sigma_s^2 c; eta = 1 is the ancestral
        posterior, eta = 0 the deterministic corner (no draw)."""
        t, s = self._time(t), self._time(s)
        gamma_t, gamma_s = self.gamma(t), self.gamma(s)
        c = -torch.expm1(gamma_s - gamma_t)
        alpha_t, alpha_s = self.alpha(gamma_t), self.alpha(gamma_s)
        sigma_t, sigma_s = self.sigma(gamma_t), self.sigma(gamma_s)
        pred_noise = self.get_pred_noise(zt, gamma_t, guided=True, **kwargs)
        x0_pred = (zt - sigma_t * pred_noise) / alpha_t
        var = eta ** 2 * sigma_s ** 2 * c
        mean = alpha_s * x0_pred + torch.sqrt(
            torch.clamp(sigma_s ** 2 - var, min=0.0)) * pred_noise
        if eta == 0.0:
            return mean
        if noise is None:
            noise = torch.randn(zt.shape, generator=generator,
                                device=zt.device)
        return mean + torch.sqrt(var) * noise

    def _time(self, t) -> torch.Tensor:
        return torch.as_tensor(t, dtype=torch.float32, device=self.device)


def sample(model: VDM, generator: Optional[torch.Generator],
           batch_size: int, n_sampling_steps: int,
           sample_shape: Sequence[int], z: Optional[torch.Tensor] = None,
           noise: Optional[Sequence[torch.Tensor]] = None,
           return_all: bool = False, method: str = "ancestral",
           eta: float = 0.0, **kwargs) -> torch.Tensor:
    """Generate samples by stepping from t = 1 to t = 0 over
    ``n_sampling_steps`` equal steps, without gradients. ``z`` (the start,
    else drawn from ``generator``) and ``noise`` (each step's draw, else
    drawn from ``generator`` where the step draws) may be given.
    method 'ancestral' or 'ddim' (with ``eta``); ``return_all`` stacks
    every step's z."""
    if method not in ("ancestral", "ddim"):
        raise ValueError(f"unknown sampling method {method!r}")
    dev = model.device
    with torch.no_grad():
        if z is None:
            z = torch.randn((batch_size, *sample_shape), generator=generator,
                            device=dev)
        steps = torch.linspace(1.0, 0.0, n_sampling_steps + 1, device=dev)
        zs = []
        for i in range(n_sampling_steps):
            step_noise = None if noise is None else noise[i]
            if method == "ddim":
                z = model.sample_zs_given_zt_ddim(
                    z, steps[i], steps[i + 1], eta=eta, generator=generator,
                    noise=step_noise, **kwargs)
            else:
                z = model.sample_zs_given_zt(
                    z, steps[i], steps[i + 1], generator=generator,
                    noise=step_noise, **kwargs)
            if return_all:
                zs.append(z)
    return torch.stack(zs) if return_all else z
