"""Tensor (model-axis) parallelism: output-channel shards over a 2-D
('data', 'model') mesh; counterpart of tempo_tpu/parallel/tensor.py.

The sharding rule is JAX's, applied to the JAX leaf (``tp_sharding_rule``):
a float leaf is sharded on its last axis, the output channel of a flax
conv or Dense kernel, when that axis is at least the model axis's size and
divides by it; every other leaf stays whole on every rank (``logvar``, a
channel count that does not divide). A port parameter is sharded on the
torch dimension that the weight bridge maps from that axis
(interop/jax_layout.py): dim 0 of a conv, Dense, Linear or kernel-2
downsample weight, the one dim of a bias or norm affine, dim 1 of
``wte``/``wpe``. A kernel-2 upsample's JAX kernel is [in, (di, dj, out)],
whose last axis merges three torch dimensions: its shard is held in the
JAX layout, [in, 4 out / n], and the layer computes in JAX's matmul +
depth-to-space form. Each rank holds only its slice of each sharded
parameter (``shard_params_tp``) and of that parameter's AdamW moments
(``shard_state_tp`` builds the optimizer over the slices).

JAX's SPMD partitioner inserts the activation collectives; here the
layers make them (nn/blocks.py, nn/transformer.py), one process per GPU.
The plan lives on the sharded parameters and their modules (``tp_kind``,
``tp_axis``, ``tensor_parallel``), not in a context to enter: a sharded
model runs its exchanges wherever it is called (a loss, encode, a
rematerialized block's recompute), and a whole one runs none:

- activations are whole on every rank of a data row;
- a sharded conv, Dense or Linear takes the whole input through ``enter``
  (the identity forward; its backward sums the input's gradient over the
  model axis, where each rank holds only its channels' share), computes
  its rank's output channels with its weight shard (K2 for GroupNorm +
  conv, cuDNN, cuBLAS), and all-gathers them (``gather``: the backward
  takes the rank's slice of the whole, identical gradient, and sums
  nothing). An output channel is computed from the same input in the
  same order as on one device;
- GroupNorm, LayerNorm and attention run on the whole activations on
  every rank (K1a, K1b, K5), their sharded affines gathered first
  (``affine``);
- GPT's tied head contracts over ``n_embd``, the axis ``wte`` is sharded
  on: it gathers ``wte`` in the compute type and runs the one-device
  matmul (V x n_embd bf16 moved once a step against B x T x V fp32
  partial logits summed over the ranks the other way round).

The data axis: the step averages the gradients over the 'data' group
(train/step.py), never over the world; the posterior sample and dropout
draw the same numbers on the model-axis peers, whose generators and
loaders are seeded by their data rank (parallel/mesh.py).

Transport, as parallel/spatial.py's: NCCL for CUDA tensors; gloo takes
CUDA tensors for all-reduce only, so a gather over gloo (two ranks
sharing one card) goes through host memory. ``EXCHANGED`` counts the bytes
each kind of exchange brought to this rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.interop import jax_layout
from tempo_tpu_torch.parallel.mesh import (DATA_AXIS, all_reduce_flat_,
                                           comm_device)

MODEL_AXIS = "model"
# Bytes brought to this rank: gathered output channels, summed input
# gradients, gathered parameters (norm affines, biases added after a
# gather, GPT's tied table).
EXCHANGED = {"activations": 0, "input_grads": 0, "weights": 0}
_FLOATS = {"float16", "bfloat16", "float32", "float64"}
_ROOT = "_tensor_parallel"


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This process's place on the model axis (``rank`` of ``world``
    ranks in ``group``) and on the data axis."""

    rank: int
    world: int
    group: Any
    data_rank: int
    data_world: int
    data_group: Any

    def bounds(self, width: int) -> tuple:
        """This rank's [lo, hi) of an axis of ``width`` (a multiple of
        ``world``)."""
        n = width // self.world
        return self.rank * n, (self.rank + 1) * n


def create_tp_mesh(n_model: int, device=None):
    """The ('data', 'model') DeviceMesh over every process: 'model' the
    inner axis, so rank r = d * n_model + m, as JAX's reshape orders the
    devices. ValueError where the process count does not divide by
    ``n_model``."""
    from torch.distributed.device_mesh import init_device_mesh

    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.parallel.mesh import process_count

    world = process_count()
    if n_model < 1 or world % n_model:
        raise ValueError(f"FATAL: {world} devices not divisible by "
                         f"tensor_parallel={n_model}")
    return init_device_mesh(resolve_device(device).type,
                            (world // n_model, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def tensor_parallel(mesh) -> TensorParallel:
    """The model and data axes of a ``create_tp_mesh`` mesh."""
    model, data = mesh[MODEL_AXIS], mesh[DATA_AXIS]
    return TensorParallel(mesh.get_local_rank(MODEL_AXIS), model.size(),
                          model.get_group(), mesh.get_local_rank(DATA_AXIS),
                          data.size(), data.get_group())


def _model_size(mesh) -> int:
    if isinstance(mesh, int):
        return mesh
    if isinstance(mesh, TensorParallel):
        return mesh.world
    return mesh[MODEL_AXIS].size()


def tp_sharding_rule(leaf, mesh) -> Optional[int]:
    """JAX's rule on a JAX-layout leaf (anything with ``shape`` and
    ``dtype``): the axis it is sharded on, its last, or None where it is
    replicated. ``mesh``: a TP mesh, a TensorParallel or the model axis's
    size."""
    n_model = _model_size(mesh)
    shape = tuple(getattr(leaf, "shape", ()))
    dtype = str(getattr(leaf, "dtype", "")).rsplit(".", 1)[-1]
    if (dtype in _FLOATS and len(shape) >= 1 and shape[-1] >= n_model
            and shape[-1] % n_model == 0):
        return len(shape) - 1
    return None


# ---------------------------------------------------------------- exchanges

def _all_gather_last(t: torch.Tensor, tp: TensorParallel,
                     kind: str) -> torch.Tensor:
    """Every rank's ``t`` concatenated along the last axis in rank order,
    on t's device."""
    buf = t.detach().to(comm_device(t, "all_gather", tp.group)).contiguous()
    bufs = [torch.empty_like(buf) for _ in range(tp.world)]
    dist.all_gather(bufs, buf, group=tp.group)
    EXCHANGED[kind] += (tp.world - 1) * buf.numel() * buf.element_size()
    return torch.cat(bufs, dim=-1).to(t.device)


class _Gather(torch.autograd.Function):
    """All-gather along the last axis; the backward takes the rank's slice
    of the incoming gradient, which every rank holds whole and equal."""

    @staticmethod
    def forward(ctx, t, tp, kind):
        ctx.tp, ctx.width = tp, t.shape[-1]
        return _all_gather_last(t, tp, kind)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.tp.rank * ctx.width
        return grad.narrow(-1, lo, ctx.width).contiguous(), None, None


def _sum_over_model(grads, tp: TensorParallel) -> tuple:
    """Each gradient summed over the model axis: one all-reduce of the
    concatenation of those of each type."""
    out = list(grads)
    by_type: Dict[tuple, list] = {}
    for i, g in enumerate(grads):
        if g is not None:
            by_type.setdefault((g.dtype, g.device), []).append(i)
    for idx in by_type.values():
        parts = [grads[i] for i in idx]
        flat = torch.cat([g.reshape(-1) for g in parts])
        buf = flat.to(comm_device(flat, "all_reduce", tp.group))
        dist.all_reduce(buf, group=tp.group)
        EXCHANGED["input_grads"] += buf.numel() * buf.element_size()
        flat = buf.to(flat.device)
        for i, piece in zip(idx, flat.split([g.numel() for g in parts])):
            out[i] = piece.view_as(grads[i])
    return tuple(out)


class _Enter(torch.autograd.Function):
    """The entry of replicated tensors into a sharded computation: the
    identity forward; the backward sums their gradients over the model
    axis (each rank computed only its output channels' share)."""

    @staticmethod
    def forward(ctx, tp, *tensors):
        ctx.tp = tp
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + _sum_over_model(grads, ctx.tp)


def gather(t: torch.Tensor, tp: TensorParallel,
           kind: str = "activations") -> torch.Tensor:
    """The whole of ``t``, sharded along its last axis, on every rank of
    the model axis (differentiable: see _Gather)."""
    if tp.world == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _Gather.apply(t, tp, kind)
    return _all_gather_last(t, tp, kind)


def enter(tp: TensorParallel, *tensors):
    """``tensors`` (None kept) as they are, their gradients summed over
    the model axis in the backward."""
    live = [i for i, t in enumerate(tensors)
            if t is not None and t.requires_grad]
    if tp.world == 1 or not live or not torch.is_grad_enabled():
        return tensors
    entered = _Enter.apply(tp, *(tensors[i] for i in live))
    out = list(tensors)
    for i, t in zip(live, entered):
        out[i] = t
    return tuple(out)


# ---------------------------------------------------------------- layers

def of_layer(module: nn.Module) -> Optional[TensorParallel]:
    """The TensorParallel of a layer whose ``weight`` is a shard, or None
    (a layer computed whole on every rank)."""
    w = getattr(module, "weight", None)
    if w is None or not hasattr(w, "tp_kind"):
        return None
    return module.tensor_parallel


def sharded_call(module: nn.Module, fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a layer; for a sharded layer its rank's output
    channels from the whole ``x`` (entered), gathered along the last
    axis."""
    tp = of_layer(module)
    if tp is None:
        return fn(x)
    (x,) = enter(tp, x)
    return gather(fn(x), tp)


def gather_output(module: nn.Module, out: torch.Tensor,
                  kind: str = "activations") -> torch.Tensor:
    """A sharded layer's output channels (an embedding's lookup, or its
    table itself) gathered; ``out`` itself for a whole layer."""
    tp = of_layer(module)
    return out if tp is None else gather(out, tp, kind)


def whole(module: nn.Module, name: str) -> Optional[torch.Tensor]:
    """The parameter ``name`` of ``module`` whole: gathered where it is a
    shard of a last-axis-sharded JAX leaf laid out as ``id`` (an affine, a
    bias, an embedding table), as it is otherwise."""
    p = getattr(module, name)
    if p is None or not hasattr(p, "tp_kind"):
        return p
    return gather(p, module.tensor_parallel, "weights")


def affine(norm: nn.Module) -> tuple:
    """A norm's (weight, bias), gathered where they are shards."""
    return whole(norm, "weight"), whole(norm, "bias")


# ---------------------------------------------------------------- sharding

def of(model: nn.Module) -> Optional[TensorParallel]:
    """The TensorParallel of a model sharded by ``shard_params_tp``, or
    None."""
    return model.__dict__.get(_ROOT)


def is_shard(p: torch.Tensor) -> bool:
    """A parameter that holds its rank's slice of a sharded leaf (its
    ``tp_kind`` the leaf's layout kind, its ``tp_axis`` the
    TensorParallel)."""
    return hasattr(p, "tp_kind")


def _sharded_modules() -> tuple:
    from tempo_tpu_torch.nn.blocks import (Conv2d, Dense, Downsample2x,
                                           GroupNorm, Upsample2x)
    from tempo_tpu_torch.nn.moe import MoEBlock
    from tempo_tpu_torch.nn.transformer import LayerNorm, Linear

    return (Conv2d, Dense, Downsample2x, Upsample2x, GroupNorm, Linear,
            LayerNorm, nn.Embedding, MoEBlock)


def local_of(full: torch.Tensor, kind: str,
             tp: TensorParallel) -> torch.Tensor:
    """This rank's slice of a whole torch-layout tensor: the JAX leaf's
    last-axis chunk, in the torch layout (the JAX one for ``up``)."""
    chunk = jax_layout.to_jax(kind, full)
    lo, hi = tp.bounds(chunk.shape[-1])
    chunk = chunk[..., lo:hi]
    return (chunk if kind == "up" else jax_layout.from_jax(kind, chunk)
            ).contiguous()


def full_of(local: torch.Tensor, kind: str,
            tp: TensorParallel) -> torch.Tensor:
    """The whole torch-layout tensor of every rank's ``local`` (a
    collective)."""
    chunk = local if kind == "up" else jax_layout.to_jax(kind, local)
    whole_jax = _all_gather_last(chunk.contiguous(), tp, "weights")
    return jax_layout.from_jax(kind, whole_jax).contiguous()


def shard_params_tp(model: nn.Module, mesh) -> nn.Module:
    """Shard ``model``'s parameters over the mesh's model axis in place by
    JAX's rule on their JAX leaves: each sharded parameter is replaced by
    its rank's slice (``tp_kind`` set on it), and its module computes its
    output channels and gathers them. Raises NotImplementedError for a
    sharded parameter of a module the TP plan does not cover (an int8 or
    LoRA layer, the untokenized head). An MoE block's ``w1``/``b1`` shard on
    the hidden axis and ``w2``/``b2`` on ``n_embd`` (nn/moe.py). Build the optimizer after
    this, over the slices."""
    tp = mesh if isinstance(mesh, TensorParallel) else tensor_parallel(mesh)
    layout = jax_layout.jax_layout(model)
    supported = _sharded_modules()
    for name, p in list(model.named_parameters()):
        leaf = layout[name]
        shape = jax_layout.jax_shape(leaf.kind, p.shape)
        if tp_sharding_rule(torch.empty(shape, dtype=p.dtype,
                                        device="meta"), tp) is None:
            continue
        mod_name, _, attr = name.rpartition(".")
        module = model.get_submodule(mod_name)
        if not isinstance(module, supported) or getattr(
                getattr(module, "config", None), "quantize", "none") != "none":
            raise NotImplementedError(
                f"tensor parallelism over {type(module).__name__} "
                f"({name}) is not ported")
        with torch.no_grad():
            local = local_of(p.detach(), leaf.kind, tp).clone()
        shard = nn.Parameter(local, requires_grad=p.requires_grad)
        shard.tp_kind, shard.tp_axis = leaf.kind, tp
        setattr(module, attr, shard)
        module.tensor_parallel = tp
    model.__dict__[_ROOT] = tp
    return model


def shard_state_tp(state, mesh, tx):
    """Tensor parallelism over the mesh: the model sharded in place
    (``shard_params_tp``), the optimizer rebuilt by ``tx`` over the slices,
    so AdamW's moments are slices too, and the generator seeded by the
    data rank (model-axis peers draw alike). Call on a fresh state (a
    checkpoint is loaded after)."""
    from tempo_tpu_torch.parallel.mesh import (rank_seed,
                                               route_experts_globally)

    tp = mesh if isinstance(mesh, TensorParallel) else tensor_parallel(mesh)
    shard_params_tp(state.model, tp)
    if tp.data_world > 1:  # the model-axis peers route the same tokens
        route_experts_globally(state.model, tp.data_group)
    state.optimizer = tx.build(state.model)
    rank_seed(state.generator, tp.data_rank)
    return state


def share_generator(model: nn.Module, generator: torch.Generator) -> None:
    """Give ``model``'s model-axis peers the generator state of their
    model rank 0 (a no-op without tensor parallelism): the peers compute
    the same activations, so they must draw alike, also after a resume
    from a file of another layout (one device, or DDP at this world
    size), whose per-rank states are not by data rank."""
    tp = of(model)
    if tp is None or tp.world == 1:
        return
    box = [generator.get_state()]
    dist.broadcast_object_list(box, src=dist.get_global_rank(tp.group, 0),
                               group=tp.group)
    generator.set_state(box[0])


def data_group(model: nn.Module):
    """The group a model's batch is cut over: its data axis under TP (None
    for a data axis of one), the world over several processes, else
    None."""
    from tempo_tpu_torch.parallel.mesh import process_count

    tp = of(model)
    if tp is not None:
        return tp.data_group if tp.data_world > 1 else None
    return dist.group.WORLD if process_count() > 1 else None


# ------------------------------------------------------- whole-state views

def _sharded_names(model: nn.Module) -> Dict[str, str]:
    return {n: p.tp_kind for n, p in model.named_parameters() if is_shard(p)}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's state dict with every shard gathered (a collective:
    every rank calls it), as one device's."""
    tp = of(model)
    kinds = _sharded_names(model)
    return {k: (full_of(v.detach(), kinds[k], tp) if k in kinds
                else v.detach())
            for k, v in model.state_dict(keep_vars=True).items()}


def _params(optimizer) -> list:
    return [p for g in optimizer.param_groups for p in g["params"]]


def full_optimizer_state(optimizer) -> dict:
    """The optimizer's state dict with every moment of a shard gathered (a
    collective), as one device's."""
    sd = optimizer.state_dict()
    params = _params(optimizer)
    state = {}
    for i, st in sd["state"].items():
        p = params[int(i)]
        state[i] = {k: (full_of(v, p.tp_kind, p.tp_axis)
                        if is_shard(p) and k != "step" else v)
                    for k, v in st.items()}
    return {"state": state, "param_groups": sd["param_groups"]}


def load_full_state_dict(model: nn.Module,
                         state_dict: Dict[str, torch.Tensor]) -> None:
    """Load a whole (one-device) state dict into a sharded model: each
    shard takes its slice."""
    tp = of(model)
    kinds = _sharded_names(model)
    model.load_state_dict({k: local_of(v, kinds[k], tp) if k in kinds else v
                           for k, v in state_dict.items()})


def load_full_optimizer_state(optimizer, state_dict: dict) -> None:
    """Load a whole optimizer state dict over sharded parameters: each
    moment of a shard takes its slice."""
    params = _params(optimizer)
    optimizer.load_state_dict({
        "state": {i: {k: (local_of(v, params[int(i)].tp_kind,
                                   params[int(i)].tp_axis)
                          if k != "step" and is_shard(params[int(i)])
                          else v)
                      for k, v in st.items()}
                  for i, st in state_dict["state"].items()},
        "param_groups": state_dict["param_groups"]})


def param_bytes(model: nn.Module, optimizer=None) -> int:
    """Bytes this rank holds of the parameters and, with ``optimizer``,
    of their AdamW moments."""
    total = sum(p.numel() * p.element_size() for p in model.parameters())
    if optimizer is not None:
        for st in optimizer.state.values():
            total += sum(v.numel() * v.element_size() for k, v in st.items()
                         if k != "step" and torch.is_tensor(v))
    return total


def global_norm(params, tp: TensorParallel) -> torch.Tensor:
    """The L2 norm of the gradients of ``params`` as one device's: the
    squares of the shards' gradients summed over the model axis in one
    all-reduce, each whole parameter's counted once."""
    shards = [p.grad.float() for p in params
              if p.grad is not None and is_shard(p)]
    rest = [p.grad.float() for p in params
            if p.grad is not None and not is_shard(p)]
    dev = (shards + rest)[0].device
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    if shards:
        sq = torch.stack(torch._foreach_norm(shards)).square().sum()
        if tp.world > 1:
            buf = sq.to(comm_device(sq, "all_reduce", tp.group))
            dist.all_reduce(buf, group=tp.group)
            sq = buf.to(dev)
    if rest:
        sq = sq + torch.stack(torch._foreach_norm(rest)).square().sum()
    return sq.sqrt()


def average_over_data(params, tp: TensorParallel) -> None:
    """Average the gradients of ``params`` over the data axis (the
    model-axis peers' shards differ; the data-axis peers' match): one
    all-reduce of their concatenation."""
    if tp.data_world > 1:
        all_reduce_flat_([p.grad for p in params], tp.data_group,
                         tp.data_world)


def mean_over_data(values: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The mean of ``values`` over the data axis."""
    if tp.data_world == 1:
        return values
    buf = values.to(comm_device(values, "all_reduce", tp.data_group),
                    copy=True)
    dist.all_reduce(buf, group=tp.data_group)
    return buf.to(values.device) / tp.data_world
