"""CLI entry points.

Every script follows the reference's contract (reference:
docs/repo_usage.md:35-42): `python -m tempo_tpu_torch.cli.<script> config.yaml
[--overwrite] [--debug]`; required config keys fail fast; the config is
copied into the output directory; --debug shrinks the run to minutes.
The trainers share the run-level helpers below (the run directory, the
host loader's batch, the state's parallelism); they import what they use
when called, so a script that needs none of them loads no torch.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Callable


def run_cli(main: Callable[[str, bool, bool], None], description: str = "") -> None:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config_path", type=str, help="Path to YAML config")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite existing output directory")
    parser.add_argument("--debug", action="store_true",
                        help="Debug mode with reduced work")
    args = parser.parse_args()
    main(args.config_path, args.overwrite, args.debug)


def start_run_directory(config, overwrite: bool, config_path,
                        subdirs=("checkpoints", "figures", "logs")) -> Path:
    """Rank 0 makes the output directory (the overwrite contract, the
    auto-resume re-entry) and copies the config; every rank returns its
    path once it is there."""
    from tempo_tpu_torch.parallel.mesh import barrier, is_primary
    from tempo_tpu_torch.train.checkpoint import wants_auto_resume
    from tempo_tpu_torch.utils.config import copy_config, save_json_yaml
    from tempo_tpu_torch.utils.dirs import init_directory

    output_dir = Path(config["output_dir"])
    if is_primary():
        output_dir = init_directory(
            output_dir, overwrite=overwrite,
            allow_existing=wants_auto_resume(config["training"]))
        for sub in subdirs:
            (output_dir / sub).mkdir(parents=True, exist_ok=True)
        if config_path is not None:
            copy_config(config_path, output_dir)
        else:
            save_json_yaml(config, output_dir / "config.yaml")
    barrier()
    return output_dir


def host_batch(batch_size: int, mesh) -> int:
    """A rank's host-loader batch: ``batch_size`` without a mesh, its share
    of the host's batch over one."""
    from tempo_tpu_torch.data.loader import local_batch_size
    from tempo_tpu_torch.parallel.mesh import local_world_size

    return (batch_size if mesh is None
            else local_batch_size(batch_size, local_world_size()))


def parallelize(state, tx, mesh, fsdp: bool):
    """The state sharded as the run asks: FSDP2 over the mesh, DDP over a
    mesh of more than one process, as it is otherwise."""
    from tempo_tpu_torch.parallel.fsdp import shard_state_fsdp
    from tempo_tpu_torch.parallel.mesh import process_count, shard_state

    if fsdp:
        print(f"FSDP (ZeRO-3) over {process_count()} process(es)")
        return shard_state_fsdp(state, mesh, tx)
    if mesh is not None and process_count() > 1:
        print(f"Data-parallel over {process_count()} processes")
        return shard_state(state, mesh)
    return state
