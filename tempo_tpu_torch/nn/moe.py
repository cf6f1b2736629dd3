"""Mixture-of-experts feed-forward for the GPT family, PyTorch.

Counterpart of tempo_tpu/nn/moe.py with the same math (GShard/Switch with
static shapes):

- routing in fp32: top-1 (Switch: the gate is the raw top probability) or
  top-2 (GShard: the two gates renormalized to sum to 1) by
  ``expert_top_k``, the lowest index first among ties as ``lax.top_k``
  (nn/transformer.py ``top_k``);
- capacity C = max(1, ceil(k * N / E * capacity_factor)) slots an expert
  for the call's N tokens; the position of each (token, rank) slot in its
  expert comes from a cumsum of one-hots in rank-major order (every rank-0
  choice before any rank-1 choice), and slots past C are dropped: that
  route's output is zero, and the token rides the residual;
- one-hot dispatch and combine (dispatch x gate) tensors [N, E, C] turn
  routing into three einsums over the stacked expert weights ``w1`` [E, d,
  f] / ``w2`` [E, f, d] (the JAX layout, [in, out] per expert);
- the Switch load-balancing loss E * sum_e (token fraction)_e * (mean
  prob)_e on the primary assignment, returned with the output (JAX sows it
  into a 'losses' collection); ``moe_lm_loss_fn`` adds ``aux_weight`` times
  its mean over the MoE blocks.

Capacity depends on the call's token count, so a row's output depends on
the batch it is routed in: JAX's semantics, not a fault.

Over several processes (``route_group``, set by ``route_globally``) the
block routes as JAX's one program does over the global batch, each rank
holding its slice of it: the capacity from the global token count, the
Switch loss from the global means of the primary assignment and of the
probabilities (one all-reduce whose backward sums the ranks' gradients,
so that the ranks' averaged gradients are the global ones), and each
slot's position from the global rank-major order, in which a rank's
routes to an expert follow, at each rank k of the top-k, those of the
ranks before it: the position of a rank-r route is the global count of
the routes of lower top-k ranks to that expert, plus the count of the
same top-k rank's routes on lower process ranks (from an all-gather of
the [k, E] counts), plus the local exclusive cumsum. A slot is then
filled by at most one token over all processes. Without a group the
block is as it was, bitwise.

Expert parallelism (parallel/expert.py, ``expert_parallel``): each rank
holds E/n of the stacked experts; the [E, C, d] expert inputs are
reduce-scattered over E to their owners (exact: every slot has at most
one nonzero addend), the owned experts run, and their outputs are
all-gathered; the backward of each exchange is the other one. Tensor
parallelism (parallel/tensor.py): ``w1``/``b1`` are sharded on the hidden
axis and ``w2``/``b2`` on ``n_embd``; each rank computes its channels
from the whole input and gathers them, the router is a sharded Linear.
``gathered`` holds whole expert weights that stand in for the module's
slices (the pipeline's ``fsdp_experts``, gathered once a step).

int8 serving (nn/quant.py): the expert kernels are stored int8
(``w1_q``/``w2_q``) with per-(expert, out-channel) fp32 scales applied
after each einsum. Live dropout (a ``Dropout`` from nn/transformer.py)
acts on the expert hidden after the GELU.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.nn.transformer import Linear, cast_param, top_k
from tempo_tpu_torch.parallel import tensor
from tempo_tpu_torch.parallel.mesh import (all_gather_dim0, all_reduce_sum,
                                           gather_dim0, scatter_dim0)
from tempo_tpu_torch.ops.losses import lm_cross_entropy
from tempo_tpu_torch.ops.norms import gelu_exact


def expert_capacity(n_tokens: int, n_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots an expert: every token occupies ``top_k`` of them in all."""
    return max(1, math.ceil(top_k * n_tokens / n_experts * capacity_factor))


def moe_lm_loss_fn(model: nn.Module, aux_weight: float = 0.01
                   ) -> Callable:
    """(model, tokens, targets, generator=None) -> (loss, {'nll',
    'moe_aux'}): the next-token NLL plus ``aux_weight`` times the mean
    Switch loss over the MoE blocks (0 without experts). With a generator
    and a dropout-configured model, dropout is live and draws from it."""
    dropout = model.config.dropout > 0.0

    def loss_fn(model, tokens, targets, generator=None):
        live = dropout and generator is not None
        logits, aux = model(tokens, deterministic=not live,
                            generator=generator if live else None,
                            with_aux=True)
        nll = lm_cross_entropy(logits, targets)
        return nll + aux_weight * aux, {"nll": nll, "moe_aux": aux}

    return loss_fn


class MoEBlock(nn.Module):
    """In place of MLPBlock when ``n_experts`` > 0: forward(x [b, t, d],
    drop=None) -> (y [b, t, d] in compute_dtype, the Switch loss, 0-d
    fp32)."""

    def __init__(self, cfg):
        super().__init__()
        self.config = cfg
        e, k, d = cfg.n_experts, cfg.expert_top_k, cfg.n_embd
        if not 1 <= k <= e:
            raise ValueError(f"expert_top_k={k} must be in [1, {e}]")
        f = int(cfg.rmlp * d)
        self.router = Linear(d, e, False, torch.float32)
        if cfg.quantize == "int8":
            self.w1_q = nn.Parameter(torch.zeros((e, d, f), dtype=torch.int8),
                                     requires_grad=False)
            self.w1_scale = nn.Parameter(torch.ones((e, f)),
                                         requires_grad=False)
            self.w2_q = nn.Parameter(torch.zeros((e, f, d), dtype=torch.int8),
                                     requires_grad=False)
            self.w2_scale = nn.Parameter(torch.ones((e, d)),
                                         requires_grad=False)
        else:
            self.w1 = nn.Parameter(torch.zeros((e, d, f)))
            self.w2 = nn.Parameter(torch.zeros((e, f, d)))
        self.b1 = nn.Parameter(torch.zeros((e, f)))
        self.b2 = nn.Parameter(torch.zeros((e, d)))
        # set by the parallelisms (see the module's docstring)
        self.route_group = None
        self.expert_parallel = None
        self.gathered = None

    def _weight(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        if self.gathered is not None and name in self.gathered:
            return self.gathered[name].to(dtype)
        p = getattr(self, name)
        if p.dtype == torch.int8:  # dequantized at the read, never cached
            return p.to(dtype)
        return cast_param(self, p, dtype)

    def _route(self, assign_k: torch.Tensor, probs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the Switch loss, each (token, rank) slot's position [N, k]) of
        the local routes ``assign_k`` [N, k, E] within the group's global
        rank-major order."""
        e = self.config.n_experts
        group = self.route_group
        n = assign_k.shape[0]
        if group is None:
            aux = e * torch.sum(assign_k[:, 0].mean(0) * probs.mean(0))
            k = assign_k.shape[1]
            assign_flat = assign_k.transpose(0, 1).reshape(k * n, e)
            pos_flat = (torch.cumsum(assign_flat, 0) * assign_flat
                        - assign_flat)
            return aux, pos_flat.sum(-1).long().reshape(k, n).T
        world, rank = dist.get_world_size(group), dist.get_rank(group)
        sums = all_reduce_sum(torch.cat([assign_k[:, 0].sum(0),
                                         probs.sum(0)]), group)
        means = sums / (n * world)
        aux = e * torch.sum(means[:e] * means[e:])
        counts = all_gather_dim0(assign_k.sum(0)[None], group)  # [R, k, E]
        total = counts.sum(0)
        offset = (torch.cumsum(total, 0) - total) + counts[:rank].sum(0)
        local = torch.cumsum(assign_k, 0) - assign_k                # [N,k,E]
        return aux, ((local + offset) * assign_k).sum(-1).long()

    def _experts(self, x: torch.Tensor, drop) -> torch.Tensor:
        """The stacked expert MLPs on ``x`` [E', C, d] (E' the experts
        this rank holds), each layer's output channels computed by their
        tensor-parallel shards and gathered where the weights are
        shards."""
        cd = self.config.dtype
        quant = self.config.quantize == "int8"
        tp = self.__dict__.get("tensor_parallel")

        def layer(x, w, b, scale):
            entered = tp is not None and tensor.is_shard(getattr(self, w))
            if entered:
                (x,) = tensor.enter(tp, x)
            y = torch.einsum("ecd,edh->ech", x, self._weight(w, cd))
            if quant:
                y = y * self._weight(scale, cd)[:, None, :]
            return y + self._weight(b, cd)[:, None], entered

        h, entered = layer(x, "w1_q" if quant else "w1", "b1", "w1_scale")
        h = gelu_exact(h)
        if entered:
            h = tensor.gather(h, tp)
        if drop is not None:
            h = drop(h)
        out, entered = layer(h, "w2_q" if quant else "w2", "b2", "w2_scale")
        return tensor.gather(out, tp) if entered else out

    def forward(self, x: torch.Tensor, drop=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        e, k = cfg.n_experts, cfg.expert_top_k
        b, t, d = x.shape
        n = b * t
        world = (1 if self.route_group is None
                 else dist.get_world_size(self.route_group))
        capacity = expert_capacity(n * world, e, k,
                                   cfg.expert_capacity_factor)
        tokens = x.reshape(n, d)

        # routing in fp32
        probs = torch.softmax(self.router(tokens.float()), dim=-1)  # [N, E]
        top_p, top_i = top_k(probs, k)                              # [N, k]
        gates = top_p / top_p.sum(-1, keepdim=True) if k > 1 else top_p
        # one-hots by comparison: F.one_hot checks its indices' range,
        # which reads them back to the host (no sync inside a capture)
        experts = torch.arange(e, device=x.device)
        assign_k = (top_i[..., None] == experts).float()            # [N,k,E]
        # capacity-bounded position of each (token, rank) slot, rank-major
        aux, pos = self._route(assign_k, probs)                     # [N, k]
        fits = pos < capacity
        keep = fits.float() * gates
        pos_hot = (pos[..., None] == torch.arange(
            capacity, device=x.device)).float()                     # [N,k,C]
        dispatch_k = (assign_k[..., None] * pos_hot[:, :, None, :]
                      * fits[:, :, None, None])                     # [N,k,E,C]
        dispatch = dispatch_k.sum(1)                                # [N,E,C]
        combine = (dispatch_k * keep[:, :, None, None]).sum(1)

        cd = cfg.dtype
        expert_in = torch.einsum("nec,nd->ecd", dispatch.to(cd),
                                 tokens.to(cd))
        ep = self.expert_parallel
        if ep is None:
            out = self._experts(expert_in, drop)
        else:  # the owners' experts on every rank's slots
            out = gather_dim0(self._experts(
                scatter_dim0(expert_in, ep.group), drop), ep.group)
        y = torch.einsum("nec,ecd->nd", combine.to(cd), out)
        return y.reshape(b, t, d), aux


def moe_aux_mean(auxes) -> Optional[torch.Tensor]:
    """The mean of the blocks' Switch losses as JAX takes it (a sum in
    block order, then / n_blocks); None without MoE blocks."""
    auxes = [a for a in auxes if a is not None]
    if not auxes:
        return None
    return sum(auxes) / len(auxes)


def route_globally(model: nn.Module, group) -> nn.Module:
    """Make every MoE block of ``model`` route over the global batch of
    ``group``'s ranks (each holding its slice of it), as JAX's one program
    does; a group of one process (or None) keeps local routing, bitwise
    as before."""
    if group is not None and dist.get_world_size(group) == 1:
        group = None
    for m in model.modules():
        if isinstance(m, MoEBlock):
            m.route_group = group
    return model


def has_experts(model: nn.Module) -> bool:
    return any(isinstance(m, MoEBlock) for m in model.modules())
