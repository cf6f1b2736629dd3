"""Process group, mesh and data parallelism; counterpart of
tempo_tpu/parallel/mesh.py.

JAX runs one process per host, which drives every local chip through a
``Mesh``; XLA partitions the jitted step and inserts the gradient
all-reduce. The port runs one process per GPU, PyTorch's idiom: the
counterpart of JAX's automatic local mesh is

    torchrun --nproc-per-node=N -m tempo_tpu_torch.cli.<cli> cfg.yaml

and the ``distributed:`` section (``enabled``, ``coordinator_address``,
``num_processes``, ``process_id: auto``) is the explicit multi-host form:
NCCL over CUDA, gloo over the CPU. A caller that needs another backend
(two ranks sharing one card, which NCCL refuses, take gloo) joins the
group itself before the CLI's ``run``, which takes a live group as it
is. ``create_mesh`` gives a
one-axis ``DeviceMesh`` named ``data`` over every process; each process
drives ``cuda:LOCAL_RANK`` (device.py ``resolve_device``).

Data parallelism (``shard_state``) wraps the model in DDP: the parameters
are broadcast from rank 0 once every rank has shown that it holds the
same ones, gradients are averaged by DDP's bucketed all-reduce, and a
parameter that no loss reaches (the flagship's last encoder ``down``
conv) keeps its gradient None on every rank, as on one device. DDP runs
the loss through its own forward (``LossForward``), so any loss function
of (model, batch, generator) trains under it; ``state.model`` stays the
plain module, whose state dict has the single-device keys.

Each rank reads its LOCAL batch: the host loaders give each rank
``batch_size // LOCAL_WORLD_SIZE`` (the global batch is batch_size x
hosts, as JAX's per-host batch), and a source that yields the global
batch (the replicated device buffer, the token loader) is cut to the
rank's contiguous slice by ``batch_sharding``. An MoE model routes over
the global batch (``route_experts_globally``), as JAX's one program does.
Losses that are means over the batch average across ranks to the global
mean; the one that is not, the L2 head's masked MSE, sums its count over
the group the train step hands it (models/vae_l2.py ``masked_mse``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
from typing import Any, Iterator, Optional

import torch
import torch.distributed as dist
from torch import nn

from tempo_tpu_torch.device import resolve_device

DATA_AXIS = "data"
# The collectives each backend runs on CUDA tensors (torch.distributed's
# table): gloo takes CUDA tensors for broadcast and all-reduce only.
_CUDA_COLLECTIVES = {"nccl": {"all_reduce", "all_gather", "broadcast", "p2p"},
                     "gloo": {"all_reduce", "broadcast"}}
RANK_VARS = ("JAX_PROCESS_ID", "SLURM_PROCID", "PMI_RANK", "RANK")
RENDEZVOUS_TIMEOUT_S = 600.0  # and each collective's


def is_active() -> bool:
    """A process group is initialized (this process is one rank of a
    run)."""
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_active() else 0


def process_count() -> int:
    return dist.get_world_size() if is_active() else 1


def is_primary() -> bool:
    """Rank 0, or a run without a process group: the process that prints
    and writes the run's files."""
    return process_index() == 0


def local_world_size() -> int:
    """Processes on this host (torchrun's LOCAL_WORLD_SIZE; 1 without
    it: one process per host, as JAX runs)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def comm_device(t: torch.Tensor, op: str, group=None) -> torch.device:
    """Where collective ``op`` of ``group`` moves ``t``: on t's device
    where the backend takes it there, else through host memory (a CUDA
    tensor's all-gather over gloo)."""
    if t.device.type == "cpu":
        return t.device
    return (t.device if op in _CUDA_COLLECTIVES.get(dist.get_backend(group),
                                                    ())
            else torch.device("cpu"))


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def resolve_process_id(value) -> Optional[int]:
    """Config 'distributed.process_id': an int, None (the launcher's
    environment), or 'auto': the rank from the standard launcher variables,
    the JAX package's list, whose last is torchrun's RANK."""
    if value != "auto":
        return value
    for var in RANK_VARS:
        if var in os.environ:
            return int(os.environ[var])
    raise ValueError(
        "FATAL: distributed.process_id: auto, but none of "
        + " / ".join(RANK_VARS) + " is set")


def _init_method(address: Optional[str]) -> str:
    """'host:port' -> tcp://host:port; a URL (tcp://, file://, env://) as
    it is; None -> env:// (torchrun's MASTER_ADDR / MASTER_PORT)."""
    if address is None:
        return "env://"
    return address if "://" in address else f"tcp://{address}"


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None):
    """Join the run's process group (NCCL for CUDA, gloo for the CPU) and
    return the mesh over every process. Arguments left None come from the
    launcher's environment (WORLD_SIZE, RANK, MASTER_ADDR/PORT). Failures
    propagate: a process that cannot join must not train alone."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    if not is_active():
        dist.init_process_group(
            backend, init_method=_init_method(coordinator_address),
            world_size=-1 if num_processes is None else int(num_processes),
            rank=-1 if process_id is None else int(process_id),
            timeout=datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_S))
    if num_processes is not None and process_count() != int(num_processes):
        raise RuntimeError(
            f"FATAL: the process group has {process_count()} processes, "
            f"the config says {num_processes}")
    return create_mesh(dev)


def maybe_initialize_distributed(config: dict, device=None):
    """CLI hook: the mesh of the run's process group, or None. A group the
    caller already joined is used as it is; an enabled ``distributed``
    section joins one explicitly; a torchrun launch (WORLD_SIZE in the
    environment) joins through env://; otherwise the run has no group."""
    dist_cfg = dict((config or {}).get("distributed") or {})
    if is_active():
        return create_mesh(device)
    if dist_cfg.get("enabled", False):
        return initialize_multihost(
            dist_cfg.get("coordinator_address"),
            dist_cfg.get("num_processes"),
            resolve_process_id(dist_cfg.get("process_id")), device=device)
    if "WORLD_SIZE" in os.environ:
        return initialize_multihost(device=device)
    return None


@contextlib.contextmanager
def process_group(config: dict, device=None, single: bool = False,
                  n_model: int = 1) -> Iterator[Any]:
    """``maybe_initialize_distributed`` for the length of a run: yields the
    mesh (None without a group) and destroys on exit the group it joined
    (never one the caller joined). ``single``: with no group to join, join
    a group of this process alone (FSDP2 needs a mesh even at world 1).
    ``n_model`` > 1: the mesh is the ('data', 'model') one
    (parallel/tensor.py ``create_tp_mesh``; ValueError where the process
    count does not divide)."""
    joined = not is_active()
    mesh = maybe_initialize_distributed(config, device)
    if mesh is None and single:
        dev = resolve_device(device)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
            rank=0, world_size=1)
        mesh = create_mesh(dev)
    try:
        if n_model > 1:
            from tempo_tpu_torch.parallel.tensor import create_tp_mesh

            mesh = create_tp_mesh(n_model, device)
        yield mesh
    finally:
        if joined and is_active():
            dist.destroy_process_group()


def create_mesh(device=None):
    """A one-axis DeviceMesh named ``data`` over every process of the
    group."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve_device(device).type, (process_count(),),
                            mesh_dim_names=(DATA_AXIS,))


@dataclasses.dataclass(frozen=True)
class BatchShard:
    """A rank's contiguous slice of a global batch along its leading axis:
    rows [rank * B / world, (rank + 1) * B / world)."""

    rank: int
    world: int

    def local_size(self, global_batch: int) -> int:
        if global_batch % self.world:
            raise ValueError(f"FATAL: global batch {global_batch} must "
                             f"divide evenly over {self.world} processes")
        return global_batch // self.world

    def rows(self, global_batch: int) -> slice:
        n = self.local_size(global_batch)
        return slice(self.rank * n, (self.rank + 1) * n)

    def take(self, batch):
        """The rank's slice of an array, a tensor or a dict of them."""
        if isinstance(batch, dict):
            return {k: self.take(v) for k, v in batch.items()}
        return batch[self.rows(batch.shape[0])]


def data_axis(mesh) -> tuple:
    """(this rank's index, size) of the mesh's 'data' axis: of the whole
    mesh for the one-axis mesh, of its outer axis for the ('data',
    'model') and pipeline ones (the model-axis peers and a pipeline's
    stages share an index), of the ('expert',) axis; a BatchShard's
    own."""
    if mesh is None:
        return 0, 1
    if isinstance(mesh, BatchShard):
        return mesh.rank, mesh.world
    names = mesh.mesh_dim_names
    if DATA_AXIS in names:
        return mesh.get_local_rank(DATA_AXIS), mesh[DATA_AXIS].size()
    if names == ("expert",):  # each expert rank trains its slice
        return mesh.get_local_rank(), mesh.size()
    return 0, 1  # the stages of one pipeline read the same rows


def batch_sharding(mesh=None) -> BatchShard:
    """This rank's slice of a global batch, cut over the mesh's 'data'
    axis only (the whole batch without a mesh; a BatchShard is its
    own)."""
    if isinstance(mesh, BatchShard):
        return mesh
    return BatchShard(*data_axis(mesh))


class RankSlice:
    """An iterator of global batches cut to this rank's slice (every rank
    draws the same global batch from a shared seed, as JAX's single
    process does)."""

    def __init__(self, loader, shard: BatchShard):
        self.loader, self.shard = loader, shard

    def __iter__(self):
        for batch in self.loader:
            yield self.shard.take(batch)

    def close(self) -> None:
        if hasattr(self.loader, "close"):
            self.loader.close()


def make_place_fn(device=None):
    """Host -> device placement of this rank's local batch (an array, a
    tensor or a dict of them) on its device, ``cuda:LOCAL_RANK`` by
    default (JAX's takes the mesh: a rank's batch is already its slice
    here)."""
    from tempo_tpu_torch.train.trainer import to_device

    dev = resolve_device(device)
    return lambda batch: to_device(batch, dev)


def _fingerprint(module: nn.Module) -> list:
    """Float64 sums of every parameter and buffer, in order: equal on two
    ranks that built the same module."""
    with torch.no_grad():
        return [float(t.double().sum()) for t in
                list(module.parameters()) + list(module.buffers())]


def check_replicas_agree(module: nn.Module) -> None:
    """Raise unless every rank holds the module rank 0 holds (the same
    seeds give the same weights; a disagreement is a bug to surface, not
    one to hide behind the broadcast)."""
    prints = [None] * process_count()
    dist.all_gather_object(prints, _fingerprint(module))
    for rank, other in enumerate(prints):
        if other != prints[0]:
            raise RuntimeError(f"FATAL: rank {rank}'s parameters differ from "
                               f"rank 0's")


class LossForward(nn.Module):
    """The module DDP wraps: its forward(loss_fn, batch, generator) is
    loss_fn(model, batch, generator), so DDP's hooks run around any loss
    of the model's methods."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, loss_fn, batch, generator):
        return loss_fn(self.model, batch, generator)


def replicate_sharding(model: nn.Module, mesh=None):
    """``model`` replicated over the process group: the ranks' parameters
    checked equal, then DDP over ``LossForward(model)`` (broadcast from
    rank 0, unused parameters found every step and left without a
    gradient, buffers not re-broadcast per step)."""
    from torch.nn.parallel import DistributedDataParallel

    check_replicas_agree(model)
    return DistributedDataParallel(
        LossForward(model), broadcast_buffers=False,
        find_unused_parameters=True,
        process_group=None if mesh is None else mesh.get_group())


def rank_seed(generator: torch.Generator,
              rank: Optional[int] = None) -> None:
    """Reseed a generator to initial_seed + 1000 * rank (the world rank by
    default; the data rank under tensor parallelism, so model-axis peers
    draw alike): each rank draws its own posterior, time and noise
    samples (rank 0 keeps the seed)."""
    rank = process_index() if rank is None else rank
    if rank:
        generator.manual_seed(generator.initial_seed() + 1000 * rank)


def shard_state(state, mesh=None):
    """Data parallelism over the process group: ``state.wrapper`` becomes
    the DDP replica the step runs its loss through, and the generator
    draws per rank. The optimizer keeps the parameters it holds (DDP does
    not replace them)."""
    state.wrapper = replicate_sharding(state.model, mesh)
    route_experts_globally(state.model)
    rank_seed(state.generator)
    return state


def route_experts_globally(model: nn.Module, group=None) -> None:
    """An MoE model's blocks route over the global batch of ``group``'s
    ranks (nn/moe.py ``route_globally``): a new group over the world by
    default, apart from the one DDP's and FSDP2's gradient exchanges run
    on, whose order the routing's backward all-reduce would then have to
    follow. A model without experts, or one process, is left as it
    is."""
    from tempo_tpu_torch.nn.moe import has_experts, route_globally

    if not has_experts(model) or process_count() == 1:
        return
    route_globally(model, dist.new_group() if group is None else group)


def all_reduce_mean(values: torch.Tensor) -> torch.Tensor:
    """The mean over ranks of a tensor (itself without a group)."""
    if process_count() == 1:
        return values
    values = values.clone()
    dist.all_reduce(values)
    return values / process_count()


def all_reduce_sum_(values: torch.Tensor) -> torch.Tensor:
    """In-place sum over ranks (a no-op without a group)."""
    if process_count() > 1:
        dist.all_reduce(values)
    return values


# ------------------------------------------- exchanges along a leading axis

def all_gather_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` of ``group`` concatenated along dim 0 in group
    rank order, on t's device (through host memory where the backend
    takes no CUDA tensor for an all-gather: gloo)."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    dev = comm_device(t, "all_gather", group)
    buf = t.detach().to(dev).contiguous()
    if dev.type == "cuda":
        out = torch.empty((world * buf.shape[0],) + tuple(buf.shape[1:]),
                          dtype=buf.dtype, device=dev)
        dist.all_gather_into_tensor(out, buf, group=group)
    else:
        bufs = [torch.empty_like(buf) for _ in range(world)]
        dist.all_gather(bufs, buf, group=group)
        out = torch.cat(bufs)
    return out.to(t.device)


def reduce_scatter_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's chunk along dim 0 of the sum over ``group`` of every
    rank's ``t`` (dim 0 a multiple of the group's size): NCCL's
    reduce-scatter, an all-reduce and the rank's slice over gloo, which
    has no reduce-scatter of CUDA tensors."""
    world = dist.get_world_size(group)
    if world == 1:
        return t
    n = t.shape[0] // world
    rank = dist.get_rank(group)
    if t.is_cuda and dist.get_backend(group) == "nccl":
        out = torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        dist.reduce_scatter_tensor(out, t.detach().contiguous(),
                                   group=group)
        return out
    buf = t.detach().to(comm_device(t, "all_reduce", group), copy=True)
    dist.all_reduce(buf, group=group)
    return buf[rank * n:(rank + 1) * n].to(t.device).contiguous()


def all_reduce_flat_(tensors, group, divisor: int = 1) -> None:
    """Sum each tensor of ``tensors`` over ``group`` in place, divided by
    ``divisor`` (the group's size: the mean): one all-reduce of their
    concatenation (of one dtype and device)."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    if dist.get_world_size(group) > 1:
        buf = flat.to(comm_device(flat, "all_reduce", group))
        dist.all_reduce(buf, group=group)
        flat = buf.to(flat.device)
    if divisor != 1:
        flat = flat / divisor
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group; the backward sums the incoming gradients over
    it too (each rank's output feeds its own loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        buf = t.detach().to(comm_device(t, "all_reduce", group), copy=True)
        dist.all_reduce(buf, group=group)
        return buf.to(t.device)

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group`` (differentiable: the backward is
    the sum of the ranks' gradients)."""
    return _AllReduceSum.apply(t, group)


class _GatherDim0(torch.autograd.Function):
    """All-gather along dim 0; the backward is the reduce-scatter (each
    rank's slice of the sum of the ranks' gradients)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_gather_dim0(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _ScatterDim0.apply(grad, ctx.group), None


class _ScatterDim0(torch.autograd.Function):
    """Reduce-scatter along dim 0; the backward is the all-gather."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return reduce_scatter_dim0(t, group)

    @staticmethod
    def backward(ctx, grad):
        return _GatherDim0.apply(grad, ctx.group), None


def gather_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_dim0``, differentiable (its backward reduce-scatters
    the gradient)."""
    return _GatherDim0.apply(t, group)


def scatter_dim0(t: torch.Tensor, group) -> torch.Tensor:
    """``reduce_scatter_dim0``, differentiable (its backward all-gathers
    the gradient)."""
    return _ScatterDim0.apply(t, group)
