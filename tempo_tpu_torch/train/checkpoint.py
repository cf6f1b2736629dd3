"""Checkpointing: single-file snapshots of the train state; counterpart of
tempo_tpu/train/checkpoint.py.

Checkpoints are <output_dir>/checkpoints/ckpt_step=NNNNNN.pt (the same
``ckpt_step=*`` naming as the JAX package's .msgpack files) holding the
step, the model's and the optimizer's state dicts, the generator's state,
the EMA and the metric histories, all copied to the host first
(``_host_payload``) and then written through a temporary file and an
atomic rename (``_write_payload``), so a preempted save never leaves a
torn checkpoint. ``AsyncCheckpointer`` writes the same file on a
background thread. ``load_checkpoint`` resumes from the port's ``.pt``
files and from the JAX package's ``.msgpack`` full states
(interop/optax_state.py). ``load_params`` restores only the model's
parameters, for inference and analysis, from the port's ``.pt``
checkpoints, reference torch checkpoints and the JAX package's
``.msgpack`` ones (interop/jax_ckpt.py). ``checkpoint_format: sharded``
writes ``ckpt_step=NNNNNN.shards/`` directories in the JAX package's
format (train/sharded_checkpoint.py), which ``load_checkpoint``,
``load_params`` and ``list_checkpoints`` take as well as files.

Over a process group every rank joins a save and rank 0 alone writes the
file, in the single-device format with the single-device keys: under DDP
the plain module's state dicts are those; under FSDP2 the shards are
gathered first (parallel/fsdp.py ``full_state_dict``,
``full_optimizer_state``: collectives, on the calling thread, also for the
async writer), and so are tensor-parallel slices and expert shards
(parallel/tensor.py's and parallel/expert.py's functions of the same
names) and a pipeline's stages (parallel/pipeline.py: the stages' blocks
and moments brought to the first stage, under one device's keys and
optimizer indices). A multi-rank file also holds
``rank_generators``, every rank's generator state, so a resume at the
same world size draws as the run would have (``restore_generator``; under
tensor parallelism the model-axis peers then take their model rank 0's,
whatever layout wrote the file). ``load_checkpoint`` and ``load_params``
read a file on one device and under DDP, FSDP2, tensor, expert or pipeline
parallelism (a sharded model takes its shards of the full tensors, a stage
its own parameters); so does a JAX ``.msgpack`` full state, also one of a
JAX pipeline run, whose (rest, stage_stack) trees are merged
(interop/jax_ckpt.py).
"""

from __future__ import annotations

import concurrent.futures
import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.distributed as dist

from tempo_tpu_torch.parallel import expert, fsdp, pipeline, tensor
from tempo_tpu_torch.parallel.mesh import (barrier, is_primary,
                                           process_count, process_index)
from tempo_tpu_torch.train.state import TrainState

CKPT_PREFIX = "ckpt_step="
CKPT_SUFFIX = ".pt"
JAX_SUFFIX = ".msgpack"  # the JAX package's checkpoints, read by load_params


def check_format(fmt: str) -> None:
    """A ``checkpoint_format`` the port writes: 'msgpack' (the JAX
    package's name of its single-file format; the port's files are .pt),
    'async' (the same files, written by AsyncCheckpointer) or 'sharded'
    (train/sharded_checkpoint.py); anything else raises ValueError."""
    if fmt not in ("msgpack", "async", "sharded"):
        raise ValueError(f"FATAL: unknown checkpoint_format {fmt!r} "
                         f"(msgpack | async | sharded)")


def checkpoint_path(ckpt_dir: Union[str, Path], step: int) -> Path:
    return Path(ckpt_dir) / f"{CKPT_PREFIX}{step:06d}{CKPT_SUFFIX}"


Staging = Dict[tuple, torch.Tensor]  # pinned host buffers of CUDA tensors


def _key(t: torch.Tensor) -> tuple:
    """A tensor's memory and layout: tensors that alias (tied weights)
    share one key, and so one host copy, as torch.save shares a storage."""
    return (t.device, t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def _host_copy(t: torch.Tensor, staging: Optional[Staging]) -> torch.Tensor:
    """A host copy of ``t`` that the caller owns. With ``staging``, a CUDA
    tensor goes into a pinned buffer kept there under its key, which the
    next save reuses (no allocation, page faults or bounce copy), the copy
    enqueued without a wait."""
    if staging is None or not t.is_cuda:
        return t.to("cpu", copy=True)
    if _key(t) not in staging:
        staging[_key(t)] = torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=True)
    return staging[_key(t)].copy_(t, non_blocking=True)


def _to_host(obj: Any, memo: Dict[tuple, torch.Tensor],
             staging: Optional[Staging] = None) -> Any:
    """``obj`` with every tensor replaced by its ``_host_copy`` (tensors
    of one key copied once), dicts (their ``_metadata`` too), lists and
    tuples rebuilt, other values kept."""
    if isinstance(obj, torch.Tensor):
        if _key(obj) not in memo:
            memo[_key(obj)] = _host_copy(obj.detach(), staging)
        return memo[_key(obj)]
    if isinstance(obj, dict):
        out = type(obj)((k, _to_host(v, memo, staging))
                        for k, v in obj.items())
        if hasattr(obj, "_metadata"):
            out._metadata = obj._metadata
        return out
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v, memo, staging) for v in obj)
    return obj


def _is_sharded(model: torch.nn.Module) -> bool:
    return any(fsdp.is_sharded(p) for p in model.parameters())


def _full_views(state: TrainState) -> tuple:
    """The model's and optimizer's state dicts as one device's: gathered
    under FSDP2, tensor, expert or pipeline parallelism (collectives), as
    they are otherwise; and whether they were gathered."""
    model = state.model
    if _is_sharded(model):
        return (fsdp.full_state_dict(model),
                fsdp.full_optimizer_state(state.optimizer), True)
    if pipeline.of(model) is not None:
        return (pipeline.full_state_dict(model),
                pipeline.full_optimizer_state(state), True)
    if tensor.of(model) is not None:
        return (tensor.full_state_dict(model),
                tensor.full_optimizer_state(state.optimizer), True)
    if expert.of(model) is not None:
        return (expert.full_state_dict(model),
                expert.full_optimizer_state(state.optimizer), True)
    return model.state_dict(), state.optimizer.state_dict(), False


def load_full_params(model: torch.nn.Module,
                     state_dict: Dict[str, torch.Tensor]) -> None:
    """Load one device's state dict into ``model``: each shard takes its
    slice under FSDP2, tensor or expert parallelism, each pipeline stage
    its own parameters."""
    if _is_sharded(model):
        fsdp.load_full_state_dict(model, state_dict)
    elif pipeline.of(model) is not None:
        pipeline.load_full_state_dict(model, state_dict)
    elif tensor.of(model) is not None:
        tensor.load_full_state_dict(model, state_dict)
    elif expert.of(model) is not None:
        expert.load_full_state_dict(model, state_dict)
    else:
        model.load_state_dict(state_dict)


def load_full_state(state: TrainState, model_sd: Dict[str, torch.Tensor],
                    opt_sd: Optional[dict] = None) -> None:
    """Load one device's state dicts into ``state``: each shard takes its
    slice under FSDP2, tensor or expert parallelism, each pipeline stage
    its own parameters and moments."""
    model, opt = state.model, state.optimizer
    load_full_params(model, model_sd)
    if opt_sd is None:
        return
    if _is_sharded(model):
        fsdp.load_full_optimizer_state(opt, opt_sd)
    elif pipeline.of(model) is not None:
        pipeline.load_full_optimizer_state(state, opt_sd)
    elif tensor.of(model) is not None:
        tensor.load_full_optimizer_state(opt, opt_sd)
    elif expert.of(model) is not None:
        expert.load_full_optimizer_state(opt, opt_sd)
    else:
        opt.load_state_dict(opt_sd)


def _host_payload(state: TrainState,
                  train_metrics: Optional[List[Dict]],
                  val_metrics: Optional[List[Dict]],
                  staging: Optional[Staging] = None
                  ) -> Optional[Dict[str, Any]]:
    """Everything a checkpoint stores, copied to the host before this
    returns (``staging``: see ``_host_copy``; its copies are waited on
    here). The train step updates the parameters and AdamW's moments in
    place, so a payload that still referenced them would change under a
    write in flight. Over a process group every rank calls this (the
    gathers are collectives) and only rank 0 gets the payload; the others
    get None."""
    model_sd, opt_sd, gathered = _full_views(state)
    if gathered:
        staging = None  # the gathered tensors are new at every save
    generators = None
    if process_count() > 1:
        generators = [None] * process_count()
        dist.all_gather_object(generators, state.generator.get_state())
    if not is_primary():
        return None
    memo: Dict[tuple, torch.Tensor] = {}
    payload = {
        "step": int(state.step),
        "model": _to_host(model_sd, memo, staging),
        "optimizer": _to_host(opt_sd, memo, staging),
        "generator": state.generator.get_state(),
        "ema": {k: float(v) for k, v in (state.ema or {}).items()},
        "train_metrics": json.dumps(train_metrics or []),
        "val_metrics": json.dumps(val_metrics or []),
    }
    if generators is not None:
        payload["rank_generators"] = generators
    device = next(state.model.parameters()).device
    if staging is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
    return payload


def _write_payload(ckpt_dir: Path, payload: Dict[str, Any]) -> Path:
    path = checkpoint_path(ckpt_dir, payload["step"])
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoints on preemption
    return path


def save_checkpoint(ckpt_dir: Union[str, Path], state: TrainState,
                    train_metrics: Optional[List[Dict]] = None,
                    val_metrics: Optional[List[Dict]] = None) -> Path:
    """Write the state's checkpoint; over a process group every rank calls
    this, rank 0 writes, and all return once the file is there."""
    payload = _host_payload(state, train_metrics, val_metrics)
    path = checkpoint_path(ckpt_dir, state.step)
    if payload is not None:
        Path(ckpt_dir).mkdir(parents=True, exist_ok=True)
        _write_payload(Path(ckpt_dir), payload)
    barrier()
    return path


class AsyncCheckpointer:
    """Checkpoint writes that overlap training; counterpart of
    tempo_tpu/train/checkpoint.py ``AsyncCheckpointer``.

    ``save()`` takes the host copy of the state before it returns (the
    next train step updates the parameters and moments in place), into
    pinned buffers that it keeps for the next save where the state is on
    CUDA, and hands ``torch.save`` and the atomic rename to one writer
    thread. One write is in flight at a time: a save first joins the
    previous one (whose payload the buffers hold), and a failed write
    re-raises on the next ``save()`` or ``wait()``. The file is the one
    ``save_checkpoint`` writes. Call ``wait()`` before reading the last
    checkpoint back, ``close()`` when done."""

    def __init__(self):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: Optional[concurrent.futures.Future] = None
        self._staging: Staging = {}

    def wait(self) -> Optional[Path]:
        """Join the write in flight; re-raises its exception, if any."""
        if self._pending is None:
            return None
        fut, self._pending = self._pending, None
        return fut.result()

    def save(self, ckpt_dir: Union[str, Path], state: TrainState,
             train_metrics: Optional[List[Dict]] = None,
             val_metrics: Optional[List[Dict]] = None) -> Path:
        self.wait()  # one in flight; surfaces the previous write's error
        ckpt_dir = Path(ckpt_dir)
        payload = _host_payload(state, train_metrics, val_metrics,
                                self._staging)
        if payload is not None:  # rank 0 (or no process group) writes
            ckpt_dir.mkdir(parents=True, exist_ok=True)
            self._pending = self._pool.submit(_write_payload, ckpt_dir,
                                              payload)
        return checkpoint_path(ckpt_dir, state.step)

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)


def restore_generator(state: TrainState, generators: Optional[list],
                      first: Optional[torch.Tensor]) -> None:
    """The generator of a resumed run: a rank's own state where the file
    has every rank's (``generators``, by world rank) for this world size;
    otherwise rank 0 takes ``first`` (the file's rank-0 state; None keeps
    it) and the others keep their seeds. Under tensor parallelism the
    model-axis peers then take their model rank 0's state, so that they
    draw alike whatever layout wrote the file."""
    if generators is not None and len(generators) == process_count():
        state.generator.set_state(generators[process_index()])
    elif first is not None and process_index() == 0:
        state.generator.set_state(first)
    tensor.share_generator(state.model, state.generator)


def load_checkpoint(path: Union[str, Path], state: TrainState
                    ) -> Tuple[TrainState, List[Dict], List[Dict]]:
    """Restore ``state`` (a state of the same model and optimizer layout)
    from ``path`` in place; returns it with the metric histories. A
    ``.shards`` directory (either package's) goes through
    train/sharded_checkpoint.py. A JAX ``.msgpack`` full state
    (parameters, optax's AdamW moments and count, the EMA, the histories)
    is mapped by interop/optax_state.py; its PRNG key seeds the generator
    (``generator_seed``)."""
    path = Path(path)
    if path.is_dir():
        from tempo_tpu_torch.train.sharded_checkpoint import (
            load_checkpoint_sharded)

        return load_checkpoint_sharded(path, state)
    if path.suffix == JAX_SUFFIX:
        from tempo_tpu_torch.interop.jax_ckpt import read_jax_checkpoint
        from tempo_tpu_torch.interop.optax_state import load_jax_train_state

        return load_jax_train_state(read_jax_checkpoint(path), state,
                                    load_full_state)
    device = next(state.model.parameters()).device
    # on the host: load_state_dict moves what belongs with the parameters
    # (the optimizer's step counts stay on the host, as a fresh AdamW's)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    load_full_state(state, raw["model"], raw["optimizer"])
    restore_generator(state, raw.get("rank_generators"), raw["generator"])
    if raw["ema"]:
        state.ema = {k: torch.tensor(v, dtype=torch.float32, device=device)
                     for k, v in raw["ema"].items()}
    state.step = int(raw["step"])
    return (state, json.loads(raw["train_metrics"]),
            json.loads(raw["val_metrics"]))


def load_params(path: Union[str, Path], model: torch.nn.Module
                ) -> torch.nn.Module:
    """Load only the model's parameters from ``path`` into ``model`` (in
    place, strict) and return it; counterpart of
    tempo_tpu/train/checkpoint.py ``load_params``.

    Takes the port's checkpoints (``model`` of save_checkpoint's payload,
    from any of its trainers), reference torch checkpoints (a bare state
    dict, or the trainer schema's ``model_state_dict``): the port's
    parameter names are the reference's; and the JAX package's ``.msgpack``
    checkpoints, their ``params`` converted by the model's class
    (interop/jax_ckpt.py), and either package's ``.shards`` directories.
    A model without an L2 head takes the ``vae`` half of an L2-supervised
    checkpoint."""
    path = Path(path)
    if path.is_dir():
        from tempo_tpu_torch.train.sharded_checkpoint import (
            load_params_sharded)

        return load_params_sharded(path, model)
    if path.suffix == JAX_SUFFIX:
        from tempo_tpu_torch.interop.jax_ckpt import (jax_state_dict_for,
                                                      read_jax_checkpoint)

        load_full_params(model, jax_state_dict_for(
            model, read_jax_checkpoint(path)["params"]))
        return model
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in raw and isinstance(raw["model"], dict):
        raw = raw["model"]
    state_dict = raw.get("model_state_dict", raw)
    if not any(k.startswith("vae.") for k in model.state_dict()):
        nested = {k[4:]: v for k, v in state_dict.items()
                  if k.startswith("vae.")}
        state_dict = nested or state_dict
    load_full_params(model, state_dict)
    return model


def list_checkpoints(ckpt_dir: Union[str, Path]) -> List[Path]:
    """Every checkpoint in a directory (the port's and reference ``.pt``
    files, the JAX package's ``.msgpack`` ones, and either package's
    ``.shards`` directories that hold an ``index.json``), sorted by
    step."""
    from tempo_tpu_torch.train.sharded_checkpoint import (
        SHARDED_SUFFIX, is_sharded_checkpoint)

    found = [p for suffix in (CKPT_SUFFIX, JAX_SUFFIX)
             for p in Path(ckpt_dir).glob(f"{CKPT_PREFIX}*{suffix}")]
    found += [p for p in Path(ckpt_dir).glob(
        f"{CKPT_PREFIX}*{SHARDED_SUFFIX}") if is_sharded_checkpoint(p)]
    return sorted(found, key=checkpoint_step)


def latest_checkpoint(ckpt_dir: Union[str, Path]) -> Optional[Path]:
    """Highest-step checkpoint in a directory, or None (the auto-resume
    hook, ``training.resume_from: auto``)."""
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def wants_auto_resume(train_cfg: dict) -> bool:
    """True when ``training.resume_from: auto``: the CLI may then re-enter
    an existing output dir."""
    return train_cfg.get("resume_from") == "auto"


def resolve_resume_from(train_cfg: dict,
                        output_dir: Union[str, Path]) -> Optional[Path]:
    """An explicit ``training.resume_from`` path as it is; 'auto' resolves
    to the run's own latest checkpoint (None + a notice when there is none
    yet: a fresh start)."""
    resume_from = train_cfg.get("resume_from")
    if resume_from == "auto":
        resume_from = latest_checkpoint(Path(output_dir) / "checkpoints")
        if resume_from is None:
            print("\nresume_from: auto — no checkpoint found, starting fresh")
    return resume_from


def checkpoint_step(path: Union[str, Path]) -> int:
    """The step of ckpt_step=NNNNNN.<ext>, for any extension."""
    return int(Path(path).stem[len(CKPT_PREFIX):])
