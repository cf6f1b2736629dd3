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
import contextlib
import dataclasses
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


# parallel.<key>: the value that means "not parallel", and the trainers
# that read the key (a trainer ignores the keys it does not read, as the
# JAX CLIs do; train_gpt refuses an unknown key)
SERIAL = {"pipeline": 1, "tensor": 1, "expert": 1, "context": 1,
          "context_zigzag": False, "fsdp": False, "n_micro": None}
READS = {"train_vae": ("tensor", "fsdp"), "train_vae_l2": ("tensor",),
         "train_diffusion": (), "train_gpt": tuple(SERIAL)}
# the keys a trainer reads that the port does not run: NotImplementedError
UNPORTED = ("context", "context_zigzag")


@dataclasses.dataclass(frozen=True)
class ParallelPlan:
    """What a run's ``parallel:`` section asks of the port: FSDP2, or
    tensor parallelism over ``n_model`` ranks (data parallelism over the
    rest), or a pipeline of ``n_pipe`` stages (``n_micro`` microbatches),
    or experts over ``n_expert`` ranks, or none (DDP over several
    processes)."""

    fsdp: bool = False
    n_model: int = 1
    n_pipe: int = 1
    n_expert: int = 1
    n_micro: int = 4

    @property
    def single(self) -> bool:
        """A mesh is needed even without a launcher."""
        return (self.fsdp or self.n_model > 1 or self.n_pipe > 1
                or self.n_expert > 1)


def parallel_plan(config, trainer: str) -> ParallelPlan:
    """The ``parallel:`` section validated for ``trainer``, in one table,
    as the JAX CLIs validate it: an unknown key (train_gpt) raises
    ValueError; so do ``tensor`` > 1 together with ``fsdp``, ``pipeline``,
    ``expert`` or ``context`` (tensor parallelism composes with data
    parallelism only), ``expert`` with ``pipeline``, and ``fsdp`` with
    any of the others; a parallelism the port does not have raises
    NotImplementedError."""
    parallel = dict(config.get("parallel") or {})
    reads = READS[trainer]
    if trainer == "train_gpt":
        for key in parallel:
            if key not in SERIAL:
                raise ValueError(f"FATAL: unknown parallel.{key}")

    def set_(key: str) -> bool:
        return (key in reads and key in parallel
                and SERIAL[key] is not None
                and parallel[key] != SERIAL[key])

    n_model = int(parallel.get("tensor", 1)) if "tensor" in reads else 1
    if set_("expert") and set_("pipeline"):
        raise ValueError("FATAL: parallel.expert with parallel.pipeline is "
                         "not a CLI path (use fsdp_experts in the library "
                         "pipeline instead)")
    if n_model > 1:
        for key in ("fsdp", "pipeline", "expert", "context"):
            if set_(key):
                raise ValueError(
                    f"FATAL: parallel.tensor composes with data parallelism "
                    f"only, not with parallel.{key}")
    if set_("fsdp"):
        for key in ("pipeline", "expert", "context"):
            if set_(key):
                raise ValueError(
                    f"FATAL: parallel.fsdp shards state over the 'data' axis "
                    f"— it does not compose with parallel.{key}")
    for key in UNPORTED:
        if set_(key):
            raise NotImplementedError(
                f"parallel.{key}={parallel[key]!r} is not ported: it waits "
                f"for its parallelism (ROADMAP Queue 1, M13)")
    return ParallelPlan(
        fsdp=set_("fsdp"), n_model=n_model,
        n_pipe=int(parallel.get("pipeline", 1)) if set_("pipeline") else 1,
        n_expert=int(parallel.get("expert", 1)) if set_("expert") else 1,
        n_micro=int(parallel.get("n_micro") or 4))


def host_batch(batch_size: int, mesh) -> int:
    """A rank's host-loader batch: ``batch_size`` without a mesh, its share
    of the host's batch over one: the host's processes split it over their
    data-axis ranks (the model-axis peers of tensor parallelism load the
    same rows)."""
    from tempo_tpu_torch.data.loader import local_batch_size
    from tempo_tpu_torch.parallel.mesh import (BatchShard, data_axis,
                                               local_world_size)

    if mesh is None:
        return batch_size
    n_model = (1 if isinstance(mesh, BatchShard)
               else mesh.size() // data_axis(mesh)[1])
    return local_batch_size(batch_size, max(1, local_world_size() // n_model))


def loader_seed(seed: int, mesh) -> int:
    """A host loader's seed: ``seed + 1000 * rank``, the rank on the data
    axis (model-axis peers draw the same rows)."""
    from tempo_tpu_torch.parallel.mesh import data_axis

    return seed + 1000 * data_axis(mesh)[0]


@contextlib.contextmanager
def parallel_group(config, device, plan: ParallelPlan):
    """``process_group`` for the run: a group of this process alone where
    a parallelism needs a mesh without a launcher; the ('data', 'model')
    mesh under tensor parallelism, the ('pipe',) or ('expert',) one over
    the world for a pipeline or experts (ValueError where the world is of
    another size)."""
    from tempo_tpu_torch.parallel.expert import create_ep_mesh
    from tempo_tpu_torch.parallel.mesh import process_group
    from tempo_tpu_torch.parallel.pipeline import create_pp_mesh

    with process_group(config, device, single=plan.single,
                       n_model=plan.n_model) as mesh:
        if plan.n_pipe > 1:
            mesh = create_pp_mesh(plan.n_pipe, device)
        elif plan.n_expert > 1:
            mesh = create_ep_mesh(plan.n_expert, device)
        yield mesh


def parallelize(state, tx, mesh, plan: ParallelPlan):
    """The state sharded as the run asks: FSDP2 over the mesh, tensor
    parallelism over its model axis, the pipeline's stages or the experts
    over its axis, DDP over a mesh of more than one process, as it is
    otherwise."""
    from tempo_tpu_torch.parallel.expert import shard_state_ep
    from tempo_tpu_torch.parallel.fsdp import shard_state_fsdp
    from tempo_tpu_torch.parallel.mesh import process_count, shard_state
    from tempo_tpu_torch.parallel.pipeline import shard_state_pp
    from tempo_tpu_torch.parallel.tensor import shard_state_tp

    if plan.fsdp:
        print(f"FSDP (ZeRO-3) over {process_count()} process(es)")
        return shard_state_fsdp(state, mesh, tx)
    if plan.n_model > 1:
        print(f"Tensor-parallel over {plan.n_model} ranks x data-parallel "
              f"over {process_count() // plan.n_model}")
        return shard_state_tp(state, mesh, tx)
    if plan.n_pipe > 1:
        print(f"Pipeline-parallel: {plan.n_pipe} stages x {plan.n_micro} "
              f"microbatches")
        return shard_state_pp(state, mesh, tx)
    if plan.n_expert > 1:
        print(f"Expert-parallel: [E,...] weights over {plan.n_expert} "
              f"processes")
        return shard_state_ep(state, mesh, tx)
    if mesh is not None and process_count() > 1:
        print(f"Data-parallel over {process_count()} processes")
        return shard_state(state, mesh)
    return state
