"""Parallelism over processes; counterpart of tempo_tpu/parallel.

Ported: the mesh and data parallelism (mesh.py, DDP), ZeRO-3 (fsdp.py,
FSDP2), spatial sharding of a whole granule along W (spatial.py: conv
halos, GroupNorm sums over the ranks, the mid attention's K/V gathered),
tensor parallelism (tensor.py: output channels over a ('data',
'model') mesh, their gathers made by the layers), expert parallelism
(expert.py: the stacked experts over an ('expert',) axis, MoE routed over
the global batch) and pipeline parallelism (pipeline.py: GPipe over
stage processes, with 'data' and 'model' axes). Context parallelism is
not ported yet (ROADMAP Queue 1, M13).

The names below load their module at first use, so that importing a
submodule (nn/blocks.py reads spatial.py's plan) does not load FSDP2's
DTensor machinery."""

import importlib

_EXPORTS = {
    "create_mesh": "mesh",
    "batch_sharding": "mesh",
    "replicate_sharding": "mesh",
    "make_place_fn": "mesh",
    "shard_state": "mesh",
    "shard_state_fsdp": "fsdp",
    "shard_params_fsdp": "fsdp",
    "spatial_sharding": "spatial",
    "shard_w": "spatial",
    "gather_w": "spatial",
    "sharded_forward": "spatial",
    "encode_spatially_sharded": "spatial",
    "decode_spatially_sharded": "spatial",
    "MODEL_AXIS": "tensor",
    "create_tp_mesh": "tensor",
    "tp_sharding_rule": "tensor",
    "shard_state_tp": "tensor",
    "shard_params_tp": "tensor",
    "EXPERT_AXIS": "expert",
    "create_ep_mesh": "expert",
    "ep_sharding_rule": "expert",
    "shard_params_ep": "expert",
    "PIPE_AXIS": "pipeline",
    "create_pp_mesh": "pipeline",
    "split_pipeline_params": "pipeline",
    "merge_pipeline_params": "pipeline",
    "place_pipeline_params": "pipeline",
    "make_pipelined_apply": "pipeline",
    "make_pp_loss_fn": "pipeline",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
