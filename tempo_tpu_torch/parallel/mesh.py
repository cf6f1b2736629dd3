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
rank's contiguous slice by ``batch_sharding``. Losses that are means over
the batch average across ranks to the global mean; the one that is not,
the L2 head's masked MSE, sums its count over the group the train step
hands it (models/vae_l2.py ``masked_mse``).
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
def process_group(config: dict, device=None,
                  single: bool = False) -> Iterator[Any]:
    """``maybe_initialize_distributed`` for the length of a run: yields the
    mesh (None without a group) and destroys on exit the group it joined
    (never one the caller joined). ``single``: with no group to join, join
    a group of this process alone (FSDP2 needs a mesh even at world 1)."""
    joined = not is_active()
    mesh = maybe_initialize_distributed(config, device)
    if mesh is None and single:
        dev = resolve_device(device)
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
            rank=0, world_size=1)
        mesh = create_mesh(dev)
    try:
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


def batch_sharding(mesh=None) -> BatchShard:
    """This rank's slice of a global batch (the whole batch without a
    mesh; a BatchShard is its own)."""
    if mesh is None:
        return BatchShard(0, 1)
    if isinstance(mesh, BatchShard):
        return mesh
    return BatchShard(mesh.get_local_rank(DATA_AXIS), mesh.size())


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


def rank_seed(generator: torch.Generator) -> None:
    """Reseed a generator to initial_seed + 1000 * rank: each rank draws
    its own posterior, time and noise samples (rank 0 keeps the seed)."""
    rank = process_index()
    if rank:
        generator.manual_seed(generator.initial_seed() + 1000 * rank)


def shard_state(state, mesh=None):
    """Data parallelism over the process group: ``state.wrapper`` becomes
    the DDP replica the step runs its loss through, and the generator
    draws per rank. The optimizer keeps the parameters it holds (DDP does
    not replace them)."""
    state.wrapper = replicate_sharding(state.model, mesh)
    rank_seed(state.generator)
    return state


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
