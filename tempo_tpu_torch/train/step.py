"""Train and eval steps; counterpart of tempo_tpu/train/step.py.

A step is forward, loss, backward, the global gradient norm, the optional
global-norm clip, the optimizer update at the schedule's learning rate for
this update count, and the EMA of the metrics, all on the model's device
with no host sync: metrics come back as 0-d device tensors, and the EMA is
updated on the device (seeded with the raw metrics at step 0, as
tempo_tpu's ``jnp.where(is_first, ...)``). PyTorch runs eagerly, so there is
no compiled program; the parameters and optimizer moments are updated in
place (JAX returns a new state; the port returns the same one).

A batch is a tensor or a dict of tensors (the L2 variant's
{'spectral', '<PRODUCT>'}). With ``grad_accum`` = k the batch's leading
axis (each value's, for a dict) is split into k microbatches; gradients
are summed over them and scaled by 1/k, and so are the metrics, so for a
deterministic loss the update equals the one-shot step (tempo_tpu's
lax.scan of microbatch means).

Over a process group (parallel/mesh.py, parallel/fsdp.py) the step is the
same on every rank over its local batch: under DDP (``state.wrapper``) the
loss runs through the replica's forward and the gradients are averaged by
its all-reduce; under FSDP2 (the model's parameters are DTensors) by its
reduce-scatter, and the 0-d parameters FSDP2 leaves replicated are
averaged here. With ``grad_accum`` the ranks sync only on the last
microbatch. The gradient norm and the clip see the global norm, and the
metrics are averaged over the ranks before the EMA, so every rank logs
the global metrics JAX's mesh step computes. Under tensor parallelism
(parallel/tensor.py) the loss is computed whole on every rank of a data
row; the gradients and metrics are averaged over the data axis only, and
the gradient norm counts each shard's squares once over the model axis
and each whole parameter once. Under expert parallelism
(parallel/expert.py) the whole parameters' gradients are averaged over
the group and the owned experts' scaled by 1/n. Under pipeline
parallelism (parallel/pipeline.py) the loss's ``value_and_grad`` runs
the GPipe schedule, forward and backward, and the gradients are reduced
over the pipe and data axes after it (``pipeline_lm_loss_fn``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.ops.losses import lm_cross_entropy
from tempo_tpu_torch.parallel.fsdp import is_sharded, replicated_params
from tempo_tpu_torch.parallel import expert, pipeline, tensor
from tempo_tpu_torch.parallel.mesh import all_reduce_mean, process_count
from tempo_tpu_torch.train.state import Optimizer, TrainState

Metrics = Dict[str, torch.Tensor]
Batch = Union[torch.Tensor, Dict[str, torch.Tensor]]
LossFn = Callable[[nn.Module, Batch, torch.Generator],
                  Tuple[torch.Tensor, Metrics]]


def vae_loss_fn(model: nn.Module) -> LossFn:
    """(model, batch [B, H, W, C], generator) -> (loss, metrics): the VAE's
    ``get_loss``, its posterior sample drawn from the generator."""

    def loss_fn(model, batch, generator):
        return model.get_loss(batch, generator)

    return loss_fn


def vae_l2_loss_fn(model: nn.Module, l2_weights=None) -> LossFn:
    """(model, batch dict, generator) -> (loss, metrics): the
    L2-supervised VAE's ``compute_loss`` with ``l2_weights`` (None: 0.1
    for every product). Over a process group the ranks' valid-pixel
    counts are summed over it (models/vae_l2.py ``masked_mse``): the step
    runs on every rank in lock-step."""

    def loss_fn(model, batch, generator):
        return model.compute_loss(batch, generator, l2_weights,
                                  tensor.data_group(model))

    return loss_fn


def diffusion_loss_fn(model: nn.Module, encode_fn=None) -> LossFn:
    """(model, batch [B, H, W, C], generator) -> (loss, metrics): a VDM's
    ``get_loss`` (models/diffusion.py), the ELBO renamed 'loss'. With
    ``encode_fn(batch, generator) -> latents`` (a frozen VAE's posterior
    sample) the diffusion trains in latent space: the encode runs first,
    without gradients, drawing from the generator, then the VDM's own
    draws."""

    def loss_fn(model, batch, generator):
        if encode_fn is not None:
            with torch.no_grad():
                batch = encode_fn(batch, generator)
        loss, metrics = model.get_loss(batch, generator)
        metrics = dict(metrics)
        metrics["loss"] = metrics.pop("elbo")
        return loss, metrics

    return loss_fn


def flow_loss_fn(model: nn.Module, encode_fn=None) -> LossFn:
    """(model, batch, generator) -> (loss, {'loss'}): stochastic flow
    matching (models/flow.py SFM) from a fresh standard-normal source x0
    to the batch (encoded as in ``diffusion_loss_fn`` when ``encode_fn``
    is given); the draws: the encode's, x0, then the loss's t and eps."""

    def loss_fn(model, batch, generator):
        if encode_fn is not None:
            with torch.no_grad():
                batch = encode_fn(batch, generator)
        x0 = torch.randn(batch.shape, generator=generator,
                         device=batch.device)
        loss = model.compute_loss(x0, batch, generator=generator)
        return loss, {"loss": loss}

    return loss_fn


def batch_size(batch: Batch) -> int:
    """The leading dimension of a tensor batch or of a dict's values."""
    first = next(iter(batch.values())) if isinstance(batch, dict) else batch
    return first.shape[0]


def split_batch(batch: Batch, k: int) -> List[Batch]:
    """k microbatches along the leading axis (of each value, for a
    dict)."""
    if not isinstance(batch, dict):
        return list(batch.chunk(k))
    parts = {key: value.chunk(k) for key, value in batch.items()}
    return [{key: chunks[i] for key, chunks in parts.items()}
            for i in range(k)]


def lm_loss_fn(model: nn.Module, aux_weight: float = 0.01) -> LossFn:
    """(model, batch [B, T+1], generator) -> (loss, metrics): the mean
    next-token NLL (cli/train_gpt.py's _lm_loss_fn). With experts it is
    nn/moe.py ``moe_lm_loss_fn``: the NLL plus ``aux_weight`` times the
    mean Switch loss over the MoE blocks, with metrics 'loss', 'nll' and
    'moe_aux'. With ``dropout`` > 0 dropout is live and draws from the
    generator (the state's), and the attention takes the materialized
    path, never K5, as JAX's does."""
    cfg = model.config
    dropout = cfg.dropout > 0.0
    if cfg.n_experts > 0:
        from tempo_tpu_torch.nn.moe import moe_lm_loss_fn

        moe_loss = moe_lm_loss_fn(model, aux_weight)

        def loss_fn(model, batch, generator):
            loss, metrics = moe_loss(model, batch[:, :-1], batch[:, 1:],
                                     generator)
            return loss, dict(metrics, loss=loss)

        return loss_fn

    def loss_fn(model, batch, generator):
        tokens, targets = batch[:, :-1], batch[:, 1:]
        kwargs = ({"deterministic": False, "generator": generator}
                  if dropout else {})
        nll = lm_cross_entropy(model(tokens, **kwargs), targets)
        return nll, {"loss": nll, "nll": nll}

    return loss_fn


def pipeline_lm_loss_fn(pp_loss) -> LossFn:
    """(model, batch [B, T+1], generator) -> (loss, {'loss'}): the
    next-token cross-entropy through a pipeline (parallel/pipeline.py
    ``PipelineLoss``), JAX's pipelined LM loss; its ``value_and_grad``
    runs the backward schedule too (the train step's route)."""

    def loss_fn(model, batch, generator):
        loss = pp_loss(model, batch[:, :-1], batch[:, 1:])
        return loss, {"loss": loss}

    def value_and_grad(model, batch, generator):
        loss = pp_loss.value_and_grad(model, batch[:, :-1], batch[:, 1:])
        return loss, {"loss": loss}

    loss_fn.value_and_grad = value_and_grad
    return loss_fn


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's shard on this rank (in-place ops on it change the
    DTensor), a plain tensor as it is."""
    return t.to_local() if is_sharded(t) else t


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm of all tensors together (optax.global_norm), a plain
    fp32 tensor. Over DTensor shards on more than one rank (FSDP2's
    gradients) it is the global norm: the shards' squares summed over the
    ranks in one all-reduce, the replicated tensors counted once; on one
    rank the shards are the whole tensors and the sum is the
    single-device one."""
    tensors = list(tensors)
    sharded = [t for t in tensors if is_sharded(t)]
    if not sharded or sharded[0].device_mesh.size() == 1:
        norms = torch._foreach_norm([_local(t).float() for t in tensors])
        return torch.linalg.vector_norm(torch.stack(norms))
    shard_sq = torch.stack(torch._foreach_norm(
        [t.to_local().float() for t in sharded])).square().sum()
    dist.all_reduce(shard_sq, group=sharded[0].device_mesh.get_group())
    rest = [t.float() for t in tensors if not is_sharded(t)]
    if rest:
        shard_sq = shard_sq + torch.stack(
            torch._foreach_norm(rest)).square().sum()
    return shard_sq.sqrt()


def clip_by_global_norm(grads, norm: torch.Tensor, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g / norm * max_norm when the
    norm reaches max_norm, g untouched below it (no host sync). A DTensor
    gradient is scaled through its local shard."""
    grads = [_local(g) for g in grads]
    below = norm < max_norm
    one = torch.ones((), device=norm.device)
    torch._foreach_div_(grads, torch.where(below, one, norm))
    torch._foreach_mul_(grads, torch.where(below, one, one * max_norm))


def _average_replicated(params) -> None:
    """Average over the ranks the gradients of the parameters FSDP2 leaves
    replicated (one all-reduce of their concatenation)."""
    grads = [p.grad for p in replicated_params(params) if p.grad is not None]
    if not grads or process_count() == 1:
        return
    flat = all_reduce_mean(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _mean_over_ranks(metrics: Metrics) -> Metrics:
    """Each metric averaged over the ranks (one all-reduce)."""
    keys = list(metrics)
    values = all_reduce_mean(torch.stack([metrics[k] for k in keys]))
    return dict(zip(keys, values.unbind()))


def _detached(metrics: Metrics) -> Metrics:
    return {k: v.detach().float() for k, v in metrics.items()}


def make_train_step(loss_fn: LossFn, tx: Optimizer, ema_alpha: float = 0.99,
                    grad_accum: int = 1
                    ) -> Callable[[TrainState, Batch],
                                  Tuple[TrainState, Metrics]]:
    """Returns (state, batch) -> (state, metrics), the state updated in
    place. state.ema (when not None; {} to start) gets EMA(ema_alpha) of
    every metric, grad_norm included, seeded with the raw value where it
    holds none yet (at step 0 always)."""
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def train_step(state: TrainState, batch: Batch):
        model, opt, wrapper = state.model, state.optimizer, state.wrapper
        tp, ep, pp = tensor.of(model), expert.of(model), pipeline.of(model)
        params = [p for p in model.parameters() if p.requires_grad]
        for p in params:
            p.grad = None
        n = batch_size(batch)
        if n % grad_accum:
            raise ValueError(f"batch {n} not divisible by "
                             f"grad_accum {grad_accum}")
        sharded = any(is_sharded(p) for p in params)
        metrics = None
        for i, mb in enumerate(split_batch(batch, grad_accum)):
            last = i == grad_accum - 1
            if sharded and grad_accum > 1:
                model.set_requires_gradient_sync(last)
            if pp is not None:  # the schedule runs the backward itself
                loss, m = loss_fn.value_and_grad(model, mb, state.generator)
            else:
                with (wrapper.no_sync() if wrapper is not None and not last
                      else contextlib.nullcontext()):
                    loss, m = (loss_fn(model, mb, state.generator)
                               if wrapper is None
                               else wrapper(loss_fn, mb, state.generator))
                    loss.backward()
            m = _detached(m)
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in metrics}
        if sharded:
            _average_replicated(params)
        if pp is not None:
            pipeline.reduce_grads(model, pp)
        elif tp is not None:
            tensor.average_over_data(params, tp)
        elif ep is not None:
            expert.average_grads(params, ep)
        grads = [p.grad for p in params if p.grad is not None]
        if grad_accum > 1:
            inv = 1.0 / grad_accum
            torch._foreach_mul_([_local(g) for g in grads], inv)
            metrics = {k: v * inv for k, v in metrics.items()}
        if pp is not None or tp is not None:
            keys = list(metrics)
            stacked = torch.stack([metrics[k] for k in keys])
            metrics = dict(zip(keys, (
                pipeline.mean_over_data(stacked, pp) if pp is not None
                else tensor.mean_over_data(stacked, tp)).unbind()))
        elif wrapper is not None or sharded or ep is not None:
            metrics = _mean_over_ranks(metrics)
        metrics["grad_norm"] = (
            pipeline.global_norm(model, pp) if pp is not None
            else tensor.global_norm(params, tp) if tp is not None
            else expert.global_norm(params, ep) if ep is not None
            else global_norm(grads))
        if tx.max_grad_norm is not None:
            clip_by_global_norm(grads, metrics["grad_norm"], tx.max_grad_norm)
        lr = tx.lr(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        if state.ema is not None:
            ema = state.ema
            for k, v in metrics.items():
                if state.step == 0 or k not in ema:
                    ema[k] = v.clone()
                else:
                    ema[k] = ema_alpha * ema[k] + (1 - ema_alpha) * v
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(loss_fn: LossFn
                   ) -> Callable[[nn.Module, Batch, torch.Generator],
                                 Metrics]:
    """Returns (model, batch, generator) -> metrics, without gradients."""

    def eval_step(model, batch, generator) -> Metrics:
        with torch.no_grad():
            _, metrics = loss_fn(model, batch, generator)
        return _detached(metrics)

    return eval_step
