"""Spatial sharding for whole-granule inference; counterpart of
tempo_tpu/parallel/spatial.py.

A whole granule ([1, 128, 2048, 1028], and the 512-channel maps behind it)
is split along W, the track axis, over the ranks of the process group
(one process per GPU, parallel/mesh.py); each rank copies only its W share
to its device. In JAX, XLA's SPMD partitioner inserts every exchange the
split needs. Here the blocks make them (nn/blocks.py) while
``sharded_forward`` is active, through this module's ``SpatialPlan``:

- every 3x3 conv (``Conv2d.forward``, each K2 call of ``norm_act_conv``)
  takes its neighbours' edge columns (``halo``: the raw, un-normalized
  input), runs SAME over the widened shard and crops the added columns.
  Its zero padding then lands only on cropped columns, and at the
  granule's true edges nothing is added, so the padding there is JAX's;
- every GroupNorm takes its statistics from K1a's sums mode summed over
  the ranks (``group_stats``: ``gn_sums``, an all-reduce of [B, 2, G]
  fp32, ``stats_from_sums``), then K1b or K2 as on one device;
- the mid attention gathers K and V along W from every rank (``gather_w``,
  in the compute type, the channel-major head layout kept) and attends its
  own queries to every key.

Two layers need no exchange: the stride-2 resamples (``Downsample2x``,
``Upsample2x``, kernel 2), because every shard width is a multiple of the
model's total stride, so each shard boundary falls on a kernel boundary at
every level; and ``Dense`` (1x1), which is pointwise.

Shard widths are multiples of the total stride (``VAEConfig.
spatial_factor``, 4 for the flagship: 64 -> 32 -> 16), as even as that
allows: the first (W / stride) mod R ranks hold one unit more. Any number
of ranks works, 3 included; a W that is not a multiple of the stride, or
has fewer units than ranks, raises ValueError. The posterior-mean latent
stays split along W, each rank holding a quarter of its own share.

Transport, by the backend's table of collectives (torch.distributed): NCCL
takes CUDA tensors for all of them; gloo takes CPU tensors for all and
CUDA tensors only for broadcast and all-reduce. So a halo or a gather of
CUDA tensors over gloo (two ranks sharing one card) goes through host
memory; the compute never leaves the device. ``EXCHANGED`` counts the
bytes each exchange brought to this rank.

The sharded forward is inference only (the K1a sums op has no backward).
The statistics and the attention sum in another order than on one device,
so the sharded result equals the one-device one to rounding, not bitwise.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from tempo_tpu_torch.ops import cuda_gn
from tempo_tpu_torch.parallel.mesh import comm_device

SPATIAL_AXIS = "data"  # the mesh's one axis (parallel/mesh.py)
# Bytes brought to this rank by each exchange: halo columns, W gathers (the
# attention's K/V, the assembly of outputs), all-reduced GroupNorm sums.
EXCHANGED = {"halo": 0, "gather": 0, "reduce": 0}
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("spatial_plan",
                                                         default=None)


@dataclasses.dataclass(frozen=True)
class SpatialSharding:
    """This process's place in a W split over the ``world`` ranks of
    ``group`` (None: the default group)."""

    rank: int
    world: int
    group: Any = None

    def widths(self, width: int, stride: int = 1) -> list:
        """Each rank's share of ``width`` columns, in whole units of
        ``stride``, as even as that allows."""
        units, rest = divmod(width, stride)
        if rest or units < self.world:
            raise ValueError(
                f"W = {width} cannot be split over {self.world} ranks: W must "
                f"be a multiple of the model's total stride {stride} and at "
                f"least {self.world} x {stride}")
        q, r = divmod(units, self.world)
        return [(q + (i < r)) * stride for i in range(self.world)]

    def bounds(self, width: int, stride: int = 1) -> tuple:
        """This rank's columns [lo, hi) of ``width``."""
        w = self.widths(width, stride)
        lo = sum(w[:self.rank])
        return lo, lo + w[self.rank]

    def comm_device(self, t: torch.Tensor, op: str) -> torch.device:
        """Where ``op`` moves ``t`` (parallel/mesh.py ``comm_device``)."""
        return comm_device(t, op, self.group)

    def peer(self, rank: int) -> int:
        """The global rank of ``rank`` of the group."""
        return (rank if self.group is None
                else dist.get_global_rank(self.group, rank))


def spatial_sharding(mesh=None, axis_name: str = SPATIAL_AXIS
                     ) -> SpatialSharding:
    """The W split over the mesh's ``axis_name`` (parallel/mesh.py
    ``create_mesh``); without a mesh, this process alone (a
    SpatialSharding is its own)."""
    if mesh is None:
        return SpatialSharding(0, 1)
    if isinstance(mesh, SpatialSharding):
        return mesh
    group = mesh.get_group(axis_name)
    return SpatialSharding(mesh.get_local_rank(axis_name),
                           dist.get_world_size(group), group)


def shard_w(x, sharding: SpatialSharding, stride: int = 1,
            device=None) -> torch.Tensor:
    """This rank's share of ``x`` [..., W, C] (a numpy array or a tensor,
    wherever it lies) as a contiguous tensor on ``device`` (x's own for a
    tensor, without one): only the share is copied there."""
    lo, hi = sharding.bounds(x.shape[-2], stride)
    if isinstance(x, np.ndarray):
        piece = torch.from_numpy(np.array(x[..., lo:hi, :]))
    else:
        piece = x[..., lo:hi, :]
    return piece.to(piece.device if device is None else device).contiguous()


def all_reduce_sum(t: torch.Tensor, sharding: SpatialSharding,
                   kind: str = "reduce") -> torch.Tensor:
    """The sum of ``t`` over the ranks, on t's device (t itself at world
    1); ``kind`` is the EXCHANGED entry its bytes count in."""
    if sharding.world == 1:
        return t
    buf = t.to(sharding.comm_device(t, "all_reduce"), copy=True)
    dist.all_reduce(buf, group=sharding.group)
    EXCHANGED[kind] += buf.numel() * buf.element_size()
    return buf.to(t.device)


def all_widths(width: int, sharding: SpatialSharding) -> list:
    """Every rank's ``width`` (each rank gives its own)."""
    if sharding.world == 1:
        return [width]
    out = [None] * sharding.world
    dist.all_gather_object(out, int(width), group=sharding.group)
    return out


def _gather(t: torch.Tensor, widths: Sequence[int],
            sharding: SpatialSharding, host: bool) -> torch.Tensor:
    """The rank pieces [..., widths[r], C] of every rank, concatenated
    along W in rank order; each piece is padded to the widest for the
    all-gather and cut back after it."""
    dev = sharding.comm_device(t, "all_gather")
    shape = list(t.shape)
    shape[-2] = max(widths)
    buf = torch.zeros(shape, dtype=t.dtype, device=dev)
    buf[..., :t.shape[-2], :] = t
    bufs = [torch.empty_like(buf) for _ in widths]
    dist.all_gather(bufs, buf, group=sharding.group)
    out = torch.cat([b[..., :w, :] for b, w in zip(bufs, widths)], dim=-2)
    EXCHANGED["gather"] += (out.numel() - t.numel()) * t.element_size()
    return out.cpu() if host else out.to(t.device)


def gather_w(t: torch.Tensor, sharding: SpatialSharding,
             host: bool = False) -> torch.Tensor:
    """The whole of a W-sharded ``t`` [..., w, C] on every rank: on t's
    device, or with ``host`` in host memory (over gloo it is assembled
    there; over NCCL on the device, then copied)."""
    if sharding.world == 1:
        return t.cpu() if host else t
    return _gather(t, all_widths(t.shape[-2], sharding), sharding, host)


def halo(x: torch.Tensor, p: int, sharding: SpatialSharding
         ) -> tuple:
    """x [B, H, w, C] widened by ``p`` columns of each neighbour (none at
    the granule's edges): (the widened shard, columns added on the left,
    on the right)."""
    rank, world = sharding.rank, sharding.world
    dev = sharding.comm_device(x, "p2p")
    ops, recv = [], []
    for side, nb in ((0, rank - 1), (1, rank + 1)):
        if not 0 <= nb < world:
            recv.append(None)
            continue
        edge = x.narrow(-2, 0 if side == 0 else x.shape[-2] - p, p)
        edge = edge.to(dev).contiguous()
        got = torch.empty_like(edge)
        peer = sharding.peer(nb)
        ops += [dist.P2POp(dist.isend, edge, peer, sharding.group),
                dist.P2POp(dist.irecv, got, peer, sharding.group)]
        recv.append(got)
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    parts = [r.to(x.device) for r in recv[:1] if r is not None] + [x] + [
        r.to(x.device) for r in recv[1:] if r is not None]
    EXCHANGED["halo"] += sum(r.numel() * r.element_size()
                             for r in recv if r is not None)
    return (torch.cat(parts, dim=-2), p * (recv[0] is not None),
            p * (recv[1] is not None))


@dataclasses.dataclass(frozen=True)
class SpatialPlan:
    """A W-sharded forward: the split and each rank's width of its input,
    in units of the input's total stride (every level's widths are these
    units times the level's columns a unit)."""

    sharding: SpatialSharding
    units: tuple

    def level_widths(self, width: int) -> list:
        """Every rank's width at the level where this rank holds
        ``width``."""
        mine = self.units[self.sharding.rank]
        if width % mine:
            raise ValueError(f"a shard of {width} columns is not a whole "
                             f"number of this rank's {mine} units")
        return [u * (width // mine) for u in self.units]

    def halo_conv(self, x: torch.Tensor, conv: Callable, p: int
                  ) -> torch.Tensor:
        """``conv`` (SAME, padding p) over x [B, H, w, C] widened by its
        neighbours' p edge columns, the added columns cropped."""
        if p == 0 or self.sharding.world == 1:
            return conv(x)
        if min(self.level_widths(x.shape[-2])) < p:
            raise ValueError(f"a shard narrower than the conv's halo of {p} "
                             f"columns")
        wide, left, right = halo(x, p, self.sharding)
        out = conv(wide)
        return out[:, :, left:out.shape[2] - right].contiguous()

    def group_stats(self, x: torch.Tensor, num_groups: int,
                    eps: float) -> torch.Tensor:
        """[B, 2, C] GroupNorm mean and rstd of the whole sample of which x
        [B, H, w, C] is this rank's share: K1a's sums mode, summed over the
        ranks, finished by K1a's formula."""
        b, h, w, c = x.shape
        sums = all_reduce_sum(cuda_gn.gn_sums(x, num_groups), self.sharding)
        n = h * sum(self.level_widths(w)) * (c // num_groups)
        return cuda_gn.stats_from_sums(sums, n, c, eps)

    def gather_w(self, t: torch.Tensor) -> torch.Tensor:
        """The whole of t [B, H, w, C] along W, on every rank."""
        if self.sharding.world == 1:
            return t
        return _gather(t, self.level_widths(t.shape[-2]), self.sharding,
                       host=False)


def active() -> Optional[SpatialPlan]:
    """The plan of the sharded forward running in this context, if any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded_forward(sharding: SpatialSharding, widths: Sequence[int],
                    stride: int = 1) -> Iterator[SpatialPlan]:
    """While active, the blocks make the exchanges of a forward over an
    input split along W into ``widths`` (every rank's, in rank order), each
    a multiple of ``stride``, the model's total stride at that input."""
    world = sharding.world
    if len(widths) != world or any(w % stride or w < stride for w in widths):
        raise ValueError(f"shard widths {list(widths)} are not {world} whole "
                         f"multiples of the stride {stride}")
    plan = SpatialPlan(sharding, tuple(w // stride for w in widths))
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


@torch.inference_mode()
def encode_spatially_sharded(model, granule_bhwc, mesh,
                             axis_name: str = SPATIAL_AXIS) -> torch.Tensor:
    """Whole-granule encode with the track axis split over the mesh's
    ranks: the whole granule [B, H, W, C] (a host array, or a tensor
    anywhere) in, this rank's share copied to the model's device, and this
    rank's share of the posterior-mean latent [B, H/f, w/f, Z] out (f the
    total stride), on the device."""
    sharding = spatial_sharding(mesh, axis_name)
    stride = model.config.spatial_factor
    widths = sharding.widths(granule_bhwc.shape[-2], stride)
    x = shard_w(granule_bhwc, sharding, stride, _model_device(model))
    with sharded_forward(sharding, widths, stride):
        return model.encode(x).mean


@torch.inference_mode()
def decode_spatially_sharded(model, latent_bhwc, mesh,
                             axis_name: str = SPATIAL_AXIS) -> torch.Tensor:
    """Whole-latent decode over the mesh's ranks: the whole latent [B, h,
    w, Z] in, this rank's share of the decoding [B, f h, f w_r, C] out, on
    the model's device (the latent split as ``encode_spatially_sharded``
    splits its output)."""
    sharding = spatial_sharding(mesh, axis_name)
    widths = sharding.widths(latent_bhwc.shape[-2])
    z = shard_w(latent_bhwc, sharding, 1, _model_device(model))
    with sharded_forward(sharding, widths):
        return model.decode(z)
