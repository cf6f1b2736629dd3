"""Parallelism over processes; counterpart of tempo_tpu/parallel.

Ported: the mesh and data parallelism (mesh.py, DDP) and ZeRO-3 (fsdp.py,
FSDP2). Tensor, pipeline, expert, context and spatial parallelism are not
ported yet (ROADMAP Queue 1, M13)."""

from tempo_tpu_torch.parallel.fsdp import shard_params_fsdp, shard_state_fsdp
from tempo_tpu_torch.parallel.mesh import (
    batch_sharding,
    create_mesh,
    make_place_fn,
    replicate_sharding,
    shard_state,
)

__all__ = [
    "create_mesh",
    "batch_sharding",
    "replicate_sharding",
    "make_place_fn",
    "shard_state",
    "shard_state_fsdp",
    "shard_params_fsdp",
]
