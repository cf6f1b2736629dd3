"""Pipeline (stage-axis) parallelism for the GPT: the block stack split
into consecutive stages, one process per stage; counterpart of
tempo_tpu/parallel/pipeline.py.

Layout (``place_pipeline_params``): a stage rank holds its L/S
consecutive blocks under their global names (``transformer.h.{i}``), so
its state dict is a subset of one device's, and ``rest`` (``wte``,
``wpe``, ``ln_f``, ``lm_head``) whole, as JAX replicates it. JAX's
parameter trees are (rest, stage_stack), the blocks stacked to
[S, L/S, ...] leaves (``split_pipeline_params``,
``merge_pipeline_params``, on trees of JAX-layout leaves: the sharded
checkpoint and the JAX checkpoint bridge read them).

Schedule: GPipe with explicit point-to-point sends. JAX's forward is a
fill-drain of ``n_micro + S - 1`` ticks, one hop a tick, and its gradient
the transpose. Here each stage runs its microbatches in order: stage 0
embeds, the others receive the [mb, T, D] boundary activation from the
stage before, run their blocks and send it on; the last runs the head and
JAX's cross-entropy (the mean over the batch: the mean of the
microbatches' means). The backward runs the microbatches in reverse: the
last stage backpropagates its losses / n_micro, every stage sends the
gradient of its input activation back and receives that of its output.
A stage waits only for its neighbours, so the stages overlap as the
fill-drain does. The embedding's and the head's gradients of ``rest``
land on the first and last stage: ``reduce_grads`` sums ``rest``'s
gradients over the pipe group once (JAX's psum of the replicated
``rest``'s cotangents; a tied ``wte`` gets both), so every stage steps
the same ``rest``.

Compositions, on ``create_pp_mesh``'s axes:

- ('data', 'pipe'): each data row runs its own pipeline over its slice of
  the batch; every gradient is averaged over 'data';
- ('data', 'pipe', 'model'): each stage's parameters are tensor-parallel
  channel shards (parallel/tensor.py) over 'model';
- ``fsdp_experts``: a stage's stacked MoE weights hold 1/D of the expert
  axis over 'data' (``fsdp_expert`` set on them), all-gathered once a step
  at stage entry; the backward is a reduce-scatter.

MoE blocks route each microbatch by itself (capacity over the local
microbatch's tokens, as inside JAX's shard_map), and the pipeline trains
on the LM loss alone, without dropout, as JAX's.

Transport: NCCL sends CUDA tensors; gloo (ranks sharing one card) takes
no CUDA tensor for a send, so an activation or its gradient goes through
pinned host memory. ``EXCHANGED`` counts the bytes a rank sent.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.parallel import tensor
from tempo_tpu_torch.parallel.mesh import (DATA_AXIS, all_gather_dim0,
                                           all_reduce_flat_, comm_device,
                                           reduce_scatter_dim0)
from tempo_tpu_torch.parallel.tensor import MODEL_AXIS

PIPE_AXIS = "pipe"
# Bytes this rank sent to its neighbours: forward activations, gradients.
EXCHANGED = {"activations": 0, "grads": 0}
_ROOT = "_pipeline_parallel"
_BLOCKS = "transformer.h."
_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def create_pp_mesh(n_pipe: int, device=None, n_data: int = 1,
                   n_model: int = 1):
    """The DeviceMesh over every process: ('pipe',), or ('data', 'pipe')
    with ``n_data`` > 1, or ('data', 'pipe', 'model') with ``n_model`` >
    1, the faster axes inner, as JAX's. ValueError naming both numbers
    where the world is not n_data x n_pipe x n_model."""
    from torch.distributed.device_mesh import init_device_mesh

    from tempo_tpu_torch.device import resolve_device
    from tempo_tpu_torch.parallel.mesh import process_count

    need, world = n_pipe * n_data * n_model, process_count()
    if world != need:
        raise ValueError(
            f"FATAL: {n_data}x{n_pipe}x{n_model} (data,pipe,model) needs a "
            f"world of {need} processes, the run has {world}")
    kind = resolve_device(device).type
    if n_model > 1:
        return init_device_mesh(kind, (n_data, n_pipe, n_model),
                                mesh_dim_names=(DATA_AXIS, PIPE_AXIS,
                                                MODEL_AXIS))
    if n_data == 1:
        return init_device_mesh(kind, (n_pipe,), mesh_dim_names=(PIPE_AXIS,))
    return init_device_mesh(kind, (n_data, n_pipe),
                            mesh_dim_names=(DATA_AXIS, PIPE_AXIS))


@dataclasses.dataclass(frozen=True)
class PipelineParallel:
    """This process's place: ``stage`` of ``n_stages`` in the pipe group
    ``group`` (whose global ranks, by stage, are ``ranks``), its data
    axis, its tensor-parallel axis (None without 'model'), and whether
    the experts are sharded over 'data'. ``whole`` is the unsplit model
    on the meta device (names and the optimizer's one-device order)."""

    stage: int
    n_stages: int
    group: Any
    ranks: Tuple[int, ...]
    data_rank: int = 0
    data_world: int = 1
    data_group: Any = None
    tp: Optional[tensor.TensorParallel] = None
    fsdp_experts: bool = False
    whole: Any = dataclasses.field(default=None, compare=False, repr=False)

    @property
    def first(self) -> bool:
        return self.stage == 0

    @property
    def last(self) -> bool:
        return self.stage == self.n_stages - 1


def of(model: nn.Module) -> Optional[PipelineParallel]:
    """The PipelineParallel of a model placed by
    ``place_pipeline_params``, or None."""
    return model.__dict__.get(_ROOT)


# ------------------------------------------------ (rest, stage_stack) trees

def _stack(leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack([np.asarray(v) for v in leaves])


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def split_pipeline_params(params: Dict, n_stages: int) -> Tuple[Dict, Any]:
    """A JAX-layout GPT tree (``h_0`` ... ``h_{L-1}`` beside ``wte``,
    ``wpe``, ``ln_f``, ``lm_head``; numpy or torch leaves) -> (rest,
    stage_stack), the blocks' leaves stacked to [S, L/S, ...].
    ValueError unless n_layer divides by n_stages."""
    names = sorted((k for k in params if k.startswith("h_")),
                   key=lambda k: int(k.split("_")[1]))
    n_layer = len(names)
    if not n_layer or n_layer % n_stages:
        raise ValueError(f"FATAL: n_layer={n_layer} must be a positive "
                         f"multiple of n_stages={n_stages}")
    per = n_layer // n_stages
    stack = _tree_map(
        lambda *ls: _stack(list(ls)).reshape(
            (n_stages, per) + tuple(ls[0].shape)),
        *(params[k] for k in names))
    rest = {k: v for k, v in params.items() if not k.startswith("h_")}
    return rest, stack


def merge_pipeline_params(rest: Dict, stage_stack: Any) -> Dict:
    """Inverse of ``split_pipeline_params``."""
    first = stage_stack
    while isinstance(first, dict):
        first = next(iter(first.values()))
    n_stages, per = first.shape[:2]
    params = dict(rest)
    for i in range(n_stages * per):
        params[f"h_{i}"] = _tree_map(lambda l, i=i: l[i // per][i % per],
                                     stage_stack)
    return params


# ------------------------------------------------------------- placement

class StageBlocks(nn.Module):
    """A stage's blocks under their global indices (``transformer.h.6``
    ... on stage 1 of 2 for 12 layers), iterated in order."""

    def __init__(self, blocks: Dict[int, nn.Module]):
        super().__init__()
        for i, block in blocks.items():
            self.add_module(str(i), block)

    def __iter__(self):
        return iter(self._modules.values())

    def __len__(self) -> int:
        return len(self._modules)


def pipeline_parallel(mesh, fsdp_experts: bool = False
                      ) -> PipelineParallel:
    """The axes of a ``create_pp_mesh`` mesh for this process."""
    names = mesh.mesh_dim_names
    pipe = mesh[PIPE_AXIS]
    group = pipe.get_group()
    data = ((mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size(),
             mesh[DATA_AXIS].get_group()) if DATA_AXIS in names
            else (0, 1, None))
    tp = None
    if MODEL_AXIS in names:
        model = mesh[MODEL_AXIS]
        tp = tensor.TensorParallel(mesh.get_local_rank(MODEL_AXIS),
                                   model.size(), model.get_group(), *data)
    return PipelineParallel(
        mesh.get_local_rank(PIPE_AXIS), pipe.size(), group,
        tuple(dist.get_process_group_ranks(group)), *data, tp=tp,
        fsdp_experts=fsdp_experts and data[1] > 1)


def is_fsdp_expert(p: torch.Tensor) -> bool:
    """An expert weight that holds its data rank's slice of the expert
    axis (``fsdp_experts``; ``fsdp_expert`` is the data axis's size)."""
    return getattr(p, "fsdp_expert", 0) > 0


def place_pipeline_params(mesh, model: nn.Module,
                          fsdp_experts: bool = False) -> nn.Module:
    """Place a whole Transformer (every rank built the same one) on this
    process's stage, in place: only the stage's blocks stay; on a 3-D
    mesh the parameters become their 'model' channel shards; with
    ``fsdp_experts`` and a 'data' axis the stacked experts keep their
    rank's 1/D of the expert axis. Build the optimizer after this."""
    from tempo_tpu_torch.nn.transformer import Transformer

    pp = pipeline_parallel(mesh, fsdp_experts)
    blocks = list(model.transformer["h"])
    n_layer = len(blocks)
    if not n_layer or n_layer % pp.n_stages:
        raise ValueError(f"FATAL: n_layer={n_layer} must be a positive "
                         f"multiple of n_stages={pp.n_stages}")
    per = n_layer // pp.n_stages
    lo = pp.stage * per
    whole = Transformer(model.config, device="meta")
    model.transformer["h"] = StageBlocks(
        {i: blocks[i] for i in range(lo, lo + per)})
    if pp.tp is not None:
        tensor.shard_params_tp(model, pp.tp)
    if pp.fsdp_experts:
        n_experts = model.config.n_experts
        if n_experts % pp.data_world:
            raise ValueError(
                f"FATAL: n_experts={n_experts} must be a positive multiple "
                f"of the mesh 'data' axis ({pp.data_world}) for "
                f"fsdp_experts")
        for block in model.transformer["h"]:
            moe = getattr(block, "moe", None)
            for leaf in (_EXPERT_LEAVES if moe is not None else ()):
                p = getattr(moe, leaf)
                part = p.shape[0] // pp.data_world
                shard = nn.Parameter(
                    p.detach()[pp.data_rank * part:
                               (pp.data_rank + 1) * part].clone())
                shard.__dict__.update(p.__dict__)  # tp_kind / tp_axis
                shard.fsdp_expert = pp.data_world
                setattr(moe, leaf, shard)
    model.__dict__[_ROOT] = dataclasses.replace(pp, whole=whole)
    return model


def shard_state_pp(state, mesh, tx, fsdp_experts: bool = False):
    """Pipeline parallelism over the mesh: the model placed on its stage
    in place and the optimizer rebuilt by ``tx`` over what the stage
    holds (the model-axis peers' generators seeded by their data rank).
    Build ``tx`` from the whole model (its decay mask names every
    block). Call on a fresh state."""
    from tempo_tpu_torch.parallel.mesh import check_replicas_agree, rank_seed

    check_replicas_agree(state.model)
    pp = of(place_pipeline_params(mesh, state.model, fsdp_experts))
    state.optimizer = tx.build(state.model)
    rank_seed(state.generator, pp.data_rank)
    return state


# -------------------------------------------------------------- transport

def _send(t: torch.Tensor, dst: int, kind: str) -> None:
    buf = t.detach().contiguous()
    if comm_device(buf, "p2p").type != buf.device.type:
        host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
        buf = host.copy_(buf)
    dist.send(buf, dst)
    EXCHANGED[kind] += buf.numel() * buf.element_size()


def _recv(shape, dtype, device: torch.device, src: int) -> torch.Tensor:
    like = torch.empty(0, device=device)
    dev = comm_device(like, "p2p")
    buf = torch.empty(shape, dtype=dtype, device=dev,
                      pin_memory=dev.type != device.type)
    dist.recv(buf, src)
    return buf.to(device)


# ------------------------------------------------------------------ stages

def _run_stage(model: nn.Module, h: torch.Tensor) -> torch.Tensor:
    from tempo_tpu_torch.nn.transformer import _remat_block

    remat = model.config.remat and torch.is_grad_enabled()
    for block in model.transformer["h"]:
        h = (_remat_block(block, h, None, None) if remat
             else block(h))[0]
    return h


def _gather_experts(model: nn.Module, pp: PipelineParallel,
                    grad: bool) -> list:
    """``fsdp_experts``: every stacked expert weight of the stage gathered
    over 'data' to the whole expert axis, once, for this step's
    microbatches (MoEBlock.gathered); returns (block, shard, whole) for
    the reduce-scatter of the gradients."""
    out = []
    if not pp.fsdp_experts:
        return out
    for block in model.transformer["h"]:
        moe = getattr(block, "moe", None)
        if moe is None:
            continue
        moe.gathered = {}
        for leaf in _EXPERT_LEAVES:
            p = getattr(moe, leaf)
            whole = all_gather_dim0(p.detach(), pp.data_group)
            whole.requires_grad_(grad and p.requires_grad)
            moe.gathered[leaf] = whole
            out.append((moe, p, whole))
    return out


def _release_experts(gathered: list, pp: PipelineParallel) -> None:
    """Each gathered expert weight's gradient reduce-scattered onto its
    shard (summed over 'data'; ``reduce_grads`` takes the mean), and the
    gathered weights dropped."""
    for moe, p, whole in gathered:
        if whole.grad is not None:
            g = reduce_scatter_dim0(whole.grad, pp.data_group)
            p.grad = g if p.grad is None else p.grad + g
        moe.gathered = None


def _schedule(model: nn.Module, tokens: torch.Tensor, n_micro: int,
              targets: Optional[torch.Tensor] = None,
              backward: bool = False):
    """The GPipe schedule on this stage: (the mean loss over the batch,
    the same on every stage; None without targets), (the logits [B, T,
    V] on every stage; None with targets)."""
    from tempo_tpu_torch.ops.losses import lm_cross_entropy

    pp = of(model)
    b = tokens.shape[0]
    if b % n_micro:
        raise ValueError(f"FATAL: batch {b} % n_micro {n_micro} != 0")
    dev = model.device
    cfg = model.config
    micro = tokens.chunk(n_micro)
    micro_tgt = None if targets is None else targets.chunk(n_micro)
    prev = None if pp.first else pp.ranks[pp.stage - 1]
    nxt = None if pp.last else pp.ranks[pp.stage + 1]
    gathered = _gather_experts(model, pp, backward)
    saved, outs = [], []
    try:
        with torch.set_grad_enabled(backward):
            for m in range(n_micro):
                if pp.first:
                    h_in = model._embed(micro[m], None, dev, None)
                else:
                    shape = tuple(micro[m].shape[:2]) + (cfg.n_embd,)
                    h_in = _recv(shape, cfg.dtype, dev, prev)
                    h_in.requires_grad_(backward)
                h = _run_stage(model, h_in)
                if pp.last:
                    logits = model.unembed(h)
                    outs.append(logits if micro_tgt is None else
                                lm_cross_entropy(logits, micro_tgt[m]))
                else:
                    _send(h, nxt, "activations")
                saved.append((h_in, h))
        if backward:
            for m in reversed(range(n_micro)):
                h_in, h = saved[m]
                if pp.last:
                    (outs[m] / n_micro).backward()
                else:
                    h.backward(_recv(h.shape, h.dtype, dev, nxt))
                if not pp.first:
                    _send(h_in.grad, prev, "grads")
                saved[m] = None
    finally:
        _release_experts(gathered, pp)
    src = pp.ranks[-1]
    with torch.no_grad():
        if micro_tgt is not None:
            loss = (torch.stack([o.detach() for o in outs]).sum() / n_micro
                    if pp.last else torch.zeros((), device=dev))
            return _broadcast(loss.float(), src, pp), None
        if pp.last:
            logits = torch.cat(outs)
        else:
            logits = torch.empty((b, tokens.shape[1], cfg.in_size),
                                 dtype=cfg.dtype, device=dev)
        return None, _broadcast(logits, src, pp)


def _broadcast(t: torch.Tensor, src: int, pp: PipelineParallel):
    """``t`` of the last stage on every stage of the pipe group."""
    if pp.n_stages == 1:
        return t
    buf = t.contiguous().to(comm_device(t, "broadcast", pp.group))
    dist.broadcast(buf, src, group=pp.group)
    return buf.to(t.device)


def make_pipelined_apply(config, n_stages: int, n_micro: int, mesh=None,
                         fsdp_experts: bool = False):
    """Returns apply(model, tokens) -> logits [B, T, vocab], the pipelined
    forward of Transformer.forward (deterministic) over a model placed by
    ``place_pipeline_params``, the same on every stage. tokens: [B, T]
    ids, B a multiple of n_micro (of each data row's rows under 'data')."""

    def apply(model, tokens):
        _check(model, n_stages)
        with torch.no_grad():
            return _schedule(model, tokens, n_micro)[1]

    return apply


def _check(model: nn.Module, n_stages: int) -> PipelineParallel:
    pp = of(model)
    if pp is None or pp.n_stages != n_stages:
        raise ValueError(f"the model is not placed on a pipeline of "
                         f"{n_stages} stages (place_pipeline_params)")
    return pp


class PipelineLoss:
    """JAX's cross-entropy through the pipeline (tokenized models):
    ``loss(model, tokens, targets)`` is the loss, without gradients;
    ``loss.value_and_grad(model, tokens, targets)`` runs the backward
    schedule too and leaves each stage's gradients of its own parameters
    (not yet reduced: ``reduce_grads``)."""

    def __init__(self, n_stages: int, n_micro: int):
        self.n_stages, self.n_micro = n_stages, n_micro

    def __call__(self, model, tokens, targets) -> torch.Tensor:
        _check(model, self.n_stages)
        with torch.no_grad():
            return _schedule(model, tokens, self.n_micro, targets)[0]

    def value_and_grad(self, model, tokens, targets) -> torch.Tensor:
        _check(model, self.n_stages)
        return _schedule(model, tokens, self.n_micro, targets,
                         backward=True)[0]


def make_pp_loss_fn(config, n_stages: int, n_micro: int, mesh=None,
                    fsdp_experts: bool = False) -> PipelineLoss:
    """Cross-entropy LM loss through the pipeline (the mesh and
    ``fsdp_experts`` live on the placed model)."""
    return PipelineLoss(n_stages, n_micro)


# ------------------------------------------------------------------ step

def _is_rest(name: str) -> bool:
    return not name.startswith(_BLOCKS)


def reduce_grads(model: nn.Module, pp: PipelineParallel) -> None:
    """Each stage's gradients made the global batch's: ``rest``'s summed
    over the pipe group (a stage that does not use a table holds zeros),
    every gradient averaged over 'data' (the experts' shards, already
    summed over 'data' by the reduce-scatter, divided by D)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    rest = [p for n, p in named if _is_rest(n)]
    for p in rest:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_flat_([p.grad for p in rest], pp.group)
    if pp.data_world == 1:
        return
    all_reduce_flat_([p.grad for _, p in named
                      if p.grad is not None and not is_fsdp_expert(p)],
                     pp.data_group, pp.data_world)
    owned = [p.grad for _, p in named
             if p.grad is not None and is_fsdp_expert(p)]
    if owned:
        torch._foreach_div_(owned, pp.data_world)


def _replicas(name: str, p: torch.Tensor, pp: PipelineParallel) -> int:
    """How many ranks of the world hold the same gradient as this one."""
    n = 1 if is_fsdp_expert(p) else pp.data_world
    if _is_rest(name):
        n *= pp.n_stages
    if pp.tp is not None and not tensor.is_shard(p):
        n *= pp.tp.world
    return n


def global_norm(model: nn.Module, pp: PipelineParallel) -> torch.Tensor:
    """The L2 norm of the gradients as one device's: each rank's squares
    weighted by 1 / the ranks that hold the same gradient, summed over the
    world in one all-reduce."""
    terms = [(p.grad.float(), _replicas(n, p, pp))
             for n, p in model.named_parameters() if p.grad is not None]
    norms = torch.stack(torch._foreach_norm([g for g, _ in terms]))
    weights = torch.tensor([1.0 / r for _, r in terms],
                           device=norms.device)
    sq = (norms.square() * weights).sum()
    buf = sq.to(comm_device(sq, "all_reduce"))
    dist.all_reduce(buf)
    return buf.to(sq.device).sqrt()


def mean_over_data(values: torch.Tensor, pp: PipelineParallel
                   ) -> torch.Tensor:
    if pp.data_world == 1:
        return values
    buf = values.to(comm_device(values, "all_reduce", pp.data_group),
                    copy=True)
    dist.all_reduce(buf, group=pp.data_group)
    return buf.to(values.device) / pp.data_world


# ------------------------------------------------------- whole-state views

def _whole(model: nn.Module, pp: PipelineParallel,
           values: Dict[str, torch.Tensor]) -> Dict:
    """``values`` ({parameter name: a tensor laid out as the parameter})
    whole over 'model' and 'data' (collectives of the stage's model and
    data groups), on the host."""
    params = dict(model.named_parameters())
    out = {}
    for k, v in values.items():
        p = params.get(k)
        v = v.detach()
        if p is not None and tensor.is_shard(p):
            v = tensor.full_of(v, p.tp_kind, p.tp_axis)
        if p is not None and is_fsdp_expert(p):
            v = all_gather_dim0(v, pp.data_group)
        out[k] = v.cpu()
    return out


def _on_first_stage(model: nn.Module, values: Dict) -> Dict:
    pp = of(model)
    parts = _to_first_stage(_whole(model, pp, values), pp)
    if parts is None:
        return {}
    return {k: v for part in parts for k, v in part.items()}


def _to_first_stage(obj: Any, pp: PipelineParallel) -> Optional[List]:
    """Every stage's ``obj`` on stage 0 (by stage), None elsewhere."""
    if pp.n_stages == 1:
        return [obj]
    out = [None] * pp.n_stages if pp.first else None
    dist.gather_object(obj, out, dst=pp.ranks[0], group=pp.group)
    return out


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """One device's state dict, keys in its order, on the first stage of
    each pipe group (the host), a collective of every rank; the rank's
    own stage's elsewhere."""
    merged = _on_first_stage(model, model.state_dict(keep_vars=True))
    return {k: merged[k] for k in of(model).whole.state_dict()
            if k in merged}


def full_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters' gradients whole, as one device's, on the first
    stage (a collective of every rank; {} elsewhere)."""
    return _on_first_stage(model, {n: p.grad for n, p in
                                   model.named_parameters()
                                   if p.grad is not None})


def one_device_order(model: nn.Module, tx) -> List[str]:
    """The parameter names in the index order of one device's optimizer
    (``tx`` built from the whole model)."""
    pp = of(model)
    whole = pp.whole if pp is not None else model
    names = {id(p): n for n, p in whole.named_parameters()}
    return [names[id(p)] for g in tx.param_groups(whole)
            for p in g["params"]]


def _local_order(model: nn.Module, optimizer) -> List[str]:
    names = {id(p): n for n, p in model.named_parameters()}
    return [names[id(p)] for g in optimizer.param_groups
            for p in g["params"]]


def full_optimizer_state(state) -> dict:
    """One device's optimizer state dict on the first stage (a collective
    of every rank), the moments of every stage's parameters under their
    one-device indices."""
    model, opt = state.model, state.optimizer
    pp = of(model)
    sd = (tensor.full_optimizer_state(opt) if pp.tp is not None
          else opt.state_dict())
    params = dict(model.named_parameters())
    local = {}
    for i, name in enumerate(_local_order(model, opt)):
        st = sd["state"].get(i)
        if st is None:
            continue
        if is_fsdp_expert(params[name]):
            st = {k: v if k == "step" else all_gather_dim0(v, pp.data_group)
                  for k, v in st.items()}
        local[name] = {k: v.detach().cpu() for k, v in st.items()}
    parts = _to_first_stage(local, pp)
    if parts is None:
        return {}
    merged = {k: v for part in parts for k, v in part.items()}
    order = one_device_order(model, state.tx)
    groups, start = [], 0
    for g, whole_g in zip(sd["param_groups"],
                          state.tx.param_groups(pp.whole)):
        n = len(whole_g["params"])
        groups.append(dict(g, params=list(range(start, start + n))))
        start += n
    return {"state": {i: merged[n] for i, n in enumerate(order)
                      if n in merged},
            "param_groups": groups}


def _local_slice(p: torch.Tensor, v: torch.Tensor,
                 pp: PipelineParallel) -> torch.Tensor:
    if is_fsdp_expert(p):
        part = v.shape[0] // pp.data_world
        v = v[pp.data_rank * part:(pp.data_rank + 1) * part]
    return v


def load_full_state_dict(model: nn.Module,
                         state_dict: Dict[str, torch.Tensor]) -> None:
    """Load one device's state dict: each stage takes its blocks and
    ``rest``, each shard its slice."""
    pp = of(model)
    params = dict(model.named_parameters())
    sd = {k: _local_slice(params[k], state_dict[k], pp) if k in params
          else state_dict[k] for k in model.state_dict()}
    if pp.tp is not None:
        tensor.load_full_state_dict(model, sd)
    else:
        model.load_state_dict(sd)


def load_full_optimizer_state(state, state_dict: dict) -> None:
    """Load one device's optimizer state dict (indices in its order): each
    stage takes its parameters' moments, each shard its slice."""
    model, opt = state.model, state.optimizer
    pp = of(model)
    params = dict(model.named_parameters())
    by_name = {n: state_dict["state"][i] for i, n in enumerate(
        one_device_order(model, state.tx)) if i in state_dict["state"]}
    local = {}
    for i, n in enumerate(_local_order(model, opt)):
        if n in by_name:
            local[i] = {k: v if k == "step" else _local_slice(params[n], v,
                                                              pp)
                        for k, v in by_name[n].items()}
    sd = opt.state_dict()
    out = {"state": local, "param_groups": sd["param_groups"]}
    if pp.tp is not None:
        tensor.load_full_optimizer_state(opt, out)
    else:
        opt.load_state_dict(out)
