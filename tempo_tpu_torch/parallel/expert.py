"""Expert (MoE-axis) parallelism: the stacked expert weights sharded over
an ('expert',) axis of processes; counterpart of
tempo_tpu/parallel/expert.py.

The rule is JAX's (``ep_sharding_rule``): a parameter inside an ``moe``
module whose leading axis divides by the axis size is sharded on that
axis (the stacked ``w1``/``b1``/``w2``/``b2``, [E, ...]); the router and
every other parameter stay whole on every rank. JAX's EP is one SPMD
program over the whole batch, whose answer is the unsharded model's; the
port runs one process per GPU with the same answer:

- each rank trains its contiguous slice of the global batch, as under
  DDP, and routes its own tokens over the group's global batch
  (nn/moe.py ``route_group``: JAX's capacity, Switch loss and rank-major
  positions);
- the [E, C, d] expert inputs are reduce-scattered over E to their
  owners, each rank runs its E/n experts and all-gathers their outputs
  (nn/moe.py); the backward of each exchange is the other;
- each rank's loss is the mean over its slice, so the gradient an owner
  gathers for its experts is the sum over the ranks' losses: n times the
  global mean's. ``average_grads`` scales the owned gradients by 1/n, once,
  and averages the whole parameters' gradients over the group;
- the global gradient norm counts each expert shard once and each whole
  parameter once (``global_norm``); AdamW's moments exist for the rank's
  own experts only (``shard_state_ep`` builds the optimizer over the
  slices).

A sharded parameter holds ``ep_axis`` (the ExpertParallel). Checkpoints
gather the slices (``full_state_dict``, ``full_optimizer_state``: the
single-device keys) and give each rank its slice of a whole file
(``load_full_state_dict``, ``load_full_optimizer_state``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.parallel.mesh import (all_gather_dim0, all_reduce_flat_,
                                           comm_device)

EXPERT_AXIS = "expert"
_ROOT = "_expert_parallel"


@dataclasses.dataclass(frozen=True)
class ExpertParallel:
    """This process's place on the expert axis: ``rank`` of ``world`` in
    ``group``."""

    rank: int
    world: int
    group: Any

    def bounds(self, n: int) -> tuple:
        """This rank's [lo, hi) of a leading axis of ``n`` (a multiple of
        ``world``)."""
        per = n // self.world
        return self.rank * per, (self.rank + 1) * per


def create_ep_mesh(n_expert: int, device=None):
    """The ('expert',) DeviceMesh over every process: the axis spans the
    world (ValueError naming both numbers where it does not)."""
    from torch.distributed.device_mesh import init_device_mesh

    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.parallel.mesh import process_count

    world = process_count()
    if world != n_expert:
        raise ValueError(f"FATAL: parallel.expert={n_expert} needs a world of "
                         f"{n_expert} processes, the run has {world}")
    return init_device_mesh(resolve_device(device).type, (n_expert,),
                            mesh_dim_names=(EXPERT_AXIS,))


def expert_parallel(mesh) -> ExpertParallel:
    """The expert axis of a ``create_ep_mesh`` mesh."""
    if isinstance(mesh, ExpertParallel):
        return mesh
    return ExpertParallel(mesh.get_local_rank(EXPERT_AXIS),
                          mesh[EXPERT_AXIS].size(),
                          mesh[EXPERT_AXIS].get_group())


def ep_sharding_rule(mesh):
    """JAX's path-keyed rule: rule(name, tensor) -> 0 for a tensor inside
    an ``moe`` module (not its router) whose leading axis divides by the
    expert axis's size, None (whole on every rank) otherwise."""
    n = mesh.world if isinstance(mesh, ExpertParallel) else mesh[
        EXPERT_AXIS].size()

    def rule(name: str, leaf) -> Optional[int]:
        parts = name.split(".")
        shape = tuple(getattr(leaf, "shape", ()))
        if ("moe" in parts and "router" not in parts and len(shape) >= 1
                and shape[0] % n == 0):
            return 0
        return None

    return rule


def of(model: nn.Module) -> Optional[ExpertParallel]:
    """The ExpertParallel of a model sharded by ``shard_params_ep``, or
    None."""
    return model.__dict__.get(_ROOT)


def is_shard(p: torch.Tensor) -> bool:
    return hasattr(p, "ep_axis")


def shard_params_ep(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s expert weights over the expert axis in place: each
    is replaced by the rank's slice of its leading axis (``ep_axis`` set
    on it), and each MoE block routes over the axis's global batch and
    exchanges its expert inputs and outputs with their owners. Build the
    optimizer after this, over the slices."""
    from tempo_tpu_torch.nn.moe import MoEBlock

    ep = expert_parallel(mesh)
    rule = ep_sharding_rule(ep)
    for name, p in list(model.named_parameters()):
        if rule(name, p) is None:
            continue
        mod_name, _, attr = name.rpartition(".")
        lo, hi = ep.bounds(p.shape[0])
        with torch.no_grad():
            shard = nn.Parameter(p.detach()[lo:hi].clone(),
                                 requires_grad=p.requires_grad)
        shard.ep_axis = ep
        setattr(model.get_submodule(mod_name), attr, shard)
    for m in model.modules():
        if isinstance(m, MoEBlock):
            m.expert_parallel = ep
            m.route_group = ep.group if ep.world > 1 else None
    model.__dict__[_ROOT] = ep
    return model


def shard_state_ep(state, mesh, tx):
    """Expert parallelism over the mesh: the model sharded in place, the
    optimizer rebuilt by ``tx`` over its slices (AdamW's moments for the
    rank's own experts only), the generator drawing per rank. Call on a
    fresh state (a checkpoint is loaded after)."""
    from tempo_tpu_torch.parallel.mesh import check_replicas_agree, rank_seed

    check_replicas_agree(state.model)
    shard_params_ep(state.model, mesh)
    state.optimizer = tx.build(state.model)
    rank_seed(state.generator)
    return state


# ------------------------------------------------------------ the step

def average_grads(params, ep: ExpertParallel) -> None:
    """The gradients of the global mean loss from the ranks' local means:
    the whole parameters' averaged over the group (one all-reduce), the
    owned experts' (each the sum over the ranks' losses) scaled by
    1/world."""
    whole = [p.grad for p in params if p.grad is not None
             and not is_shard(p)]
    all_reduce_flat_(whole, ep.group, ep.world)
    owned = [p.grad for p in params if p.grad is not None and is_shard(p)]
    if owned:
        torch._foreach_div_(owned, ep.world)


def global_norm(params, ep: ExpertParallel) -> torch.Tensor:
    """The L2 norm of the gradients as one device's: the expert shards'
    squares summed over the group, each whole parameter counted once."""
    shards = [p.grad.float() for p in params
              if p.grad is not None and is_shard(p)]
    rest = [p.grad.float() for p in params
            if p.grad is not None and not is_shard(p)]
    dev = (shards + rest)[0].device
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    if shards:
        sq = torch.stack(torch._foreach_norm(shards)).square().sum()
        buf = sq.to(comm_device(sq, "all_reduce", ep.group))
        dist.all_reduce(buf, group=ep.group)
        sq = buf.to(dev)
    if rest:
        sq = sq + torch.stack(torch._foreach_norm(rest)).square().sum()
    return sq.sqrt()


# ------------------------------------------------------- whole-state views

def full_of(local: torch.Tensor, ep: ExpertParallel) -> torch.Tensor:
    """The whole tensor of every rank's leading-axis slice (a
    collective)."""
    return all_gather_dim0(local.detach(), ep.group)


def local_of(full: torch.Tensor, ep: ExpertParallel) -> torch.Tensor:
    lo, hi = ep.bounds(full.shape[0])
    return full[lo:hi].contiguous()


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every expert shard gathered (a
    collective: every rank calls it), as one device's."""
    ep = of(model)
    return {k: full_of(v, ep) if is_shard(v) else v.detach()
            for k, v in model.state_dict(keep_vars=True).items()}


def _params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer) -> dict:
    """The optimizer's state dict with the moments of every shard gathered
    (a collective), as one device's."""
    sd = optimizer.state_dict()
    params = _params(optimizer)
    state = {}
    for i, st in sd["state"].items():
        p = params[int(i)]
        state[i] = {k: (full_of(v, p.ep_axis)
                        if is_shard(p) and k != "step" else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_state_dict(model: nn.Module,
                         state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a whole (one-device) state dict: each shard takes its
    slice."""
    ep = of(model)
    shards = {n for n, p in model.named_parameters() if is_shard(p)}
    model.load_state_dict({k: local_of(v, ep) if k in shards else v
                           for k, v in state_dict.items()})


def load_full_optimizer_state(optimizer, state_dict: dict) -> None:
    """Load a whole optimizer state dict over sharded parameters: each
    moment of a shard takes its slice."""
    params = _params(optimizer)
    optimizer.load_state_dict({
        "state": {i: {k: (local_of(v, params[int(i)].ep_axis)
                          if k != "step" and is_shard(params[int(i)])
                          else v)
                      for k, v in st.items()}
                  for i, st in state_dict["state"].items()},
        "param_groups": state_dict["param_groups"]})
