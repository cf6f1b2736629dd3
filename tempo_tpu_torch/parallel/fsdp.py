"""Fully-sharded data parallelism (ZeRO-3) over the 'data' axis;
counterpart of tempo_tpu/parallel/fsdp.py on FSDP2.

``shard_params_fsdp`` applies FSDP2's ``fully_shard`` to each block (a
module held in an ``nn.ModuleList`` that holds none itself) and then to
the root: each parameter becomes a DTensor sharded over the mesh, each block
all-gathers its parameters just before its forward (and again for its
backward) and frees them after, and gradients leave as reduce-scatters
(averaged over ranks, as DDP's all-reduce). ``shard_state_fsdp`` shards the
model and rebuilds the optimizer over the sharded parameters, so AdamW's
moments live as DTensor shards: the update runs on each rank's 1/N.

Placement: JAX's rule shards each leaf's largest evenly divisible
dimension and replicates the rest; FSDP2 shards dimension 0 of every
parameter, padding the last rank's shard where it does not divide. The
numbers do not depend on the placement. FSDP2 refuses 0-d parameters (the VAE's ``logvar``): they
stay plain replicated tensors outside FSDP2, as JAX replicates scalars,
and the train step averages their gradients over the ranks itself
(``replicated_params``).

The loss reaches the model through its own methods (``get_loss``,
``compute_loss``, ``reconstruct``), not only ``forward``: each one the
model has is registered as a forward method, so the root's parameters are
gathered around it. K2's packed-weight cache (nn/blocks.py Conv2d) is
turned off on every conv of a sharded model: the gathered weight FSDP2
hands a forward keeps its version count while its values change, so the
cache's key cannot see an update.

Full-state checkpoints (train/checkpoint.py) gather the shards with
``full_state_dict`` / ``full_optimizer_state`` on every rank (rank 0
writes) and scatter a full file back with ``load_full_state_dict`` /
``load_full_optimizer_state``.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

FORWARD_METHODS = ("get_loss", "compute_loss", "reconstruct")


def is_sharded(t: Any) -> bool:
    """A DTensor (a parameter, gradient or moment of a sharded model)."""
    return isinstance(t, DTensor)


def _blocks(model: nn.Module) -> list:
    """The blocks: every module held in an nn.ModuleList that holds no
    ModuleList itself (a VAE or CUNet level's ResNet and attention blocks,
    a transformer's layers; a level's own down or up conv stays with the
    root)."""
    return [m for lst in model.modules() if isinstance(lst, nn.ModuleList)
            for m in lst
            if not any(isinstance(c, nn.ModuleList) for c in m.modules())]


def shard_params_fsdp(model: nn.Module, mesh) -> nn.Module:
    """FSDP2 over ``model`` in place (blocks, then the root); returns it.
    The optimizer must be built after this, over the sharded
    parameters."""
    from torch.distributed.fsdp import (fully_shard,
                                        register_fsdp_forward_method)

    for m in model.modules():
        if hasattr(m, "cache_packed"):
            m.cache_packed = False
    scalars = {p for p in model.parameters() if p.ndim == 0}
    for block in _blocks(model):
        fully_shard(block, mesh=mesh, ignored_params=scalars)
    fully_shard(model, mesh=mesh, ignored_params=scalars)
    for name in FORWARD_METHODS:
        if hasattr(model, name):
            register_fsdp_forward_method(model, name)
    return model


def replicated_params(params: Sequence[torch.Tensor]) -> list:
    """The parameters of a sharded model that FSDP2 leaves replicated (its
    0-d ones): their gradients are averaged by the step. Empty when no
    parameter is sharded (one device, or DDP, which averages them all)."""
    if not any(is_sharded(p) for p in params):
        return []
    return [p for p in params if not is_sharded(p)]


def shard_state_fsdp(state, mesh, tx):
    """ZeRO-3 over the process group: the model sharded in place, the
    optimizer rebuilt by ``tx`` (train/state.py Optimizer) over the sharded
    parameters, and the generator drawing per rank. Call on a fresh state
    (a checkpoint is loaded after)."""
    from tempo_tpu_torch.parallel.mesh import (rank_seed,
                                               route_experts_globally)

    shard_params_fsdp(state.model, mesh)
    route_experts_globally(state.model)
    state.optimizer = tx.build(state.model)
    rank_seed(state.generator)
    return state


def shard_params_like(full: torch.Tensor, like) -> Any:
    """``full`` placed as the DTensor ``like`` is (each rank keeps its
    shard; every rank holds the full value, so nothing is sent)."""
    return distribute_tensor(full.to(like.device, like.dtype),
                             like.device_mesh, like.placements,
                             src_data_rank=None)


def _full(t: Any) -> Any:
    return t.full_tensor() if is_sharded(t) else t


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every shard gathered (a collective:
    every rank calls it), keyed as the unsharded model's."""
    return {k: _full(v) for k, v in model.state_dict().items()}


def full_optimizer_state(optimizer: torch.optim.Optimizer) -> dict:
    """The optimizer's state dict (parameter indices, as on one device)
    with every moment gathered (a collective)."""
    sd = optimizer.state_dict()
    return {"state": {i: {k: _full(v) for k, v in st.items()}
                      for i, st in sd["state"].items()},
            "param_groups": sd["param_groups"]}


def load_full_state_dict(model: nn.Module,
                         state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a full (single-device) state dict into a sharded model."""
    current = model.state_dict()
    model.load_state_dict({
        k: shard_params_like(v, current[k]) if is_sharded(current.get(k))
        else v for k, v in state_dict.items()})


def load_full_optimizer_state(optimizer: torch.optim.Optimizer,
                              state_dict: dict) -> None:
    """Load a full optimizer state dict over sharded parameters: each
    moment is placed as its parameter."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    optimizer.load_state_dict({
        "state": {i: {k: (shard_params_like(v, params[int(i)])
                          if k != "step" and is_sharded(params[int(i)])
                          else v)
                      for k, v in st.items()}
                  for i, st in state_dict["state"].items()},
        "param_groups": state_dict["param_groups"]})
