#!/usr/bin/env python3
"""Train the TEMPO spectral VAE on one GPU or data-parallel over many;
counterpart of tempo_tpu/cli/train_vae.py.

    python -m tempo_tpu_torch.cli.train_vae config.yaml [--overwrite] [--debug]
    torchrun --nproc-per-node=N -m tempo_tpu_torch.cli.train_vae config.yaml

The same config schema, directory contract and artifacts: config.yaml
copied into output_dir, checkpoints/ckpt_step=NNNNNN.pt, figures/
reconstructions_step_NNNNNN.png at every checkpoint, summary plots,
logs/, metrics.json and training_info.yaml (with samples_per_sec).
--debug shrinks the run to 200 steps and a buffer of 10 tiles. Batches come
from the host TileLoader (data/loader.py) or, with ``data.loader: device``,
from the device-resident DeviceTileBuffer (data/device_buffer.py:
``buffer_slots``, ``swap_every``, ``buffer_dtype``); the step is the VAE's
``get_loss`` (its GroupNorm and GroupNorm+act+conv through the K1 and K2
kernels, their backward a recompute of the plain versions), the global-norm
clip at 1.0 and AdamW (train/state.py make_optimizer_from_config). Weights
come from the config's seed through the port's own initializer, so a run
does not reproduce the JAX package's weights.

The trainer's options, as the JAX CLI's: ``training.metrics_jsonl: true``
streams every train and val record to logs/metrics.jsonl;
``training.profile_steps: [start, end]`` traces the steps after ``start``
through ``end`` into profile/ (torch.profiler's Chrome trace);
``training.checkpoint_format: async`` writes the same checkpoints on a
background thread while training goes on, ``sharded`` writes
``ckpt_step=NNNNNN.shards/`` directories in the JAX package's format, each
rank its own bytes (train/sharded_checkpoint.py).

Parallelism, one process per GPU (parallel/mesh.py): under torchrun, or
with an enabled ``distributed:`` section (``coordinator_address``,
``num_processes``, ``process_id: auto``), every rank trains its local
batch under DDP; ``parallel.fsdp: true`` shards the parameters and
AdamW's moments with FSDP2 instead (parallel/fsdp.py; at world 1 too, as
JAX's one-device mesh); ``parallel.tensor: N`` shards every output channel
that divides over N ranks of a ('data', 'model') mesh instead, data
parallelism over the rest (parallel/tensor.py), and with ``parallel.fsdp``
raises ValueError, as JAX's CLI does. The host loader gives each rank
``batch_size // LOCAL_WORLD_SIZE`` tiles from ``seed + 1000 * rank``
(JAX's per-host batch and seed, one process per device; under tensor
parallelism the rank on the data axis, so the model-axis peers load the
same rows); the device buffer takes ``batch_size`` as the global batch and
``data.partition`` (``replicate`` or ``process``: data/device_buffer.py).
Rank 0 alone writes the run's files; training_info.yaml's ``n_devices``
is the world size.

``run(config_dict)`` is the same run from a dict: it needs no YAML reader,
and writes config.yaml and training_info.yaml as JSON, which YAML readers
read.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from tempo_tpu_torch.cli import (host_batch, loader_seed, parallel_group,
                                 parallel_plan, parallelize, run_cli,
                                 start_run_directory)
from tempo_tpu_torch.data.device_buffer import DeviceTileBuffer
from tempo_tpu_torch.data.loader import TileLoader
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.parallel.mesh import is_primary, process_count
from tempo_tpu_torch.train.checkpoint import (check_format,
                                              resolve_resume_from)
from tempo_tpu_torch.train.metrics import JsonlSink
from tempo_tpu_torch.train.schedules import sqrt_save_steps
from tempo_tpu_torch.train.state import (create_train_state,
                                         make_optimizer_from_config)
from tempo_tpu_torch.train.step import vae_loss_fn
from tempo_tpu_torch.train.trainer import Trainer
from tempo_tpu_torch.utils.config import (load_config, require_keys,
                                          save_json_yaml, save_yaml)


def validate_config(config) -> None:
    require_keys(config, ["output_dir", "data", "data.train_dir", "model",
                          "training"])
    data = config["data"]
    for key in ("train_dir", "val_dir"):
        if key in data and not Path(data[key]).exists():
            raise ValueError(f"FATAL: {key} doesn't exist: {data[key]}")
    refuse_unported(config)


def refuse_unported(config, trainer: str = "train_vae") -> None:
    """NotImplementedError for what the port's trainers do not do,
    ValueError for unknown choices and the parallel compositions JAX
    refuses (cli/__init__.py ``parallel_plan``)."""
    data, train = config["data"], config["training"]
    parallel_plan(config, trainer)
    loader = data.get("loader", "host")
    if loader not in ("host", "device"):
        raise ValueError(f"FATAL: data.loader must be 'host' or 'device', "
                         f"got {loader!r}")
    partition = data.get("partition", "replicate")
    if loader == "device" and partition not in ("replicate", "process"):
        raise ValueError(f"FATAL: data.partition must be 'replicate' or "
                         f"'process', got {partition!r}")
    check_format(train.get("checkpoint_format", "msgpack"))


def _metric_sinks(train_cfg, output_dir):
    """``training.metrics_jsonl: true``: every train and val record to
    logs/metrics.jsonl; counterpart of the JAX CLI's ``_metric_sinks``."""
    if not train_cfg.get("metrics_jsonl") or not is_primary():
        return None
    return [JsonlSink(Path(output_dir) / "logs" / "metrics.jsonl")]


def make_train_loader(data_cfg, train_dir, batch_size: int, seed: int,
                      device, l2_products=None, mesh=None):
    """The training stream ``data.loader`` asks for: the host TileLoader
    or the DeviceTileBuffer on ``device``. Over a ``mesh`` the buffer
    takes the global ``batch_size`` and ``data.partition``; the host
    loader this rank's share and ``seed + 1000 * rank``."""
    if data_cfg.get("loader", "host") == "device":
        return DeviceTileBuffer(
            train_dir, batch_size=batch_size,
            slots=data_cfg.get("buffer_slots", 4),
            swap_every=data_cfg.get("swap_every", 16), seed=seed,
            dtype=data_cfg.get("buffer_dtype", "float32"), device=device,
            mesh=mesh, l2_products=l2_products,
            partition=data_cfg.get("partition", "replicate"))
    return TileLoader(
        data_dir=train_dir, batch_size=host_batch(batch_size, mesh),
        min_buffer_size=data_cfg.get("min_buffer_size", 200),
        l2_products=l2_products, seed=loader_seed(seed, mesh),
        prefetch=data_cfg.get("prefetch", 2),
        num_threads=data_cfg.get("loader_threads",
                                 data_cfg.get("num_workers", 2)),
        verbose=True)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None):
    """Train as the config dict says, on ``device`` (None: CUDA, raising
    without it; ``cuda:LOCAL_RANK`` under torchrun); returns the Trainer
    and its throughput stats. ``config_path`` is copied into the run as
    config.yaml; without it the dict is written there, and
    training_info.yaml too, as JSON."""
    validate_config(config)
    plan = parallel_plan(config, "train_vae")
    with parallel_group(config, device, plan) as mesh:
        return _run(config, overwrite, debug, device, config_path, mesh,
                    plan)


def _run(config, overwrite, debug, device, config_path, mesh, plan):
    dev = resolve_device(device)
    output_dir = start_run_directory(config, overwrite, config_path)

    seed = config.get("seed", 42)
    if debug:
        print("DEBUG MODE: Reduced training steps and data")
        config["training"]["n_steps"] = min(
            200, config["training"].get("n_steps", 10000))
        config["data"]["min_buffer_size"] = min(
            10, config["data"].get("min_buffer_size", 200))
        config["training"]["save_every"] = 50
        config["training"]["val_every"] = 25
        config["training"]["plot_every"] = 20

    data_cfg = config["data"]
    batch_size = data_cfg.get("batch_size", 16)
    print("\nLoading training data...")
    train_loader = make_train_loader(data_cfg, data_cfg["train_dir"],
                                     batch_size, seed, dev, mesh=mesh)
    val_loader = None
    if "val_dir" in data_cfg:
        print("\nLoading validation data...")
        val_loader = TileLoader(
            data_dir=data_cfg["val_dir"],
            batch_size=host_batch(batch_size, mesh),
            min_buffer_size=data_cfg.get("val_min_buffer_size", 100),
            seed=loader_seed(seed, mesh) + 1,
            num_threads=data_cfg.get("val_num_workers", 1), verbose=True)

    print("\nInitializing model...")
    model, model_cfg = build_vae(config.get("model", {}), device=dev,
                                 seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model parameters: {n_params:,}")

    train_cfg = config["training"]
    tx = make_optimizer_from_config(
        config.get("optimizer", {}),
        n_steps=int(train_cfg.get("n_steps", 10_000)))
    state = parallelize(create_train_state(model, tx, seed + 2), tx, mesh,
                        plan)
    save_steps = None
    if train_cfg.get("save_schedule") == "sqrt":
        save_steps = sqrt_save_steps(train_cfg["n_steps"],
                                     train_cfg.get("n_saves", 100))
    profile_steps = train_cfg.get("profile_steps")  # e.g. [100, 110]
    trainer = Trainer(
        loss_fn=vae_loss_fn(model), tx=tx, state=state,
        output_dir=output_dir,
        save_every=train_cfg.get("save_every", 1000),
        val_every=train_cfg.get("val_every", 100),
        log_every=train_cfg.get("log_every", 10),
        plot_every=train_cfg.get("plot_every", 50),
        save_steps=save_steps,
        grad_accum=int(train_cfg.get("grad_accum", 1)),
        device=dev,
        recon_fn=lambda m, x, g: m.reconstruct(x, generator=g),
        profile_steps=tuple(profile_steps) if profile_steps else None,
        checkpoint_format=train_cfg.get("checkpoint_format", "msgpack"),
        metric_sinks=_metric_sinks(train_cfg, output_dir))
    resume_from = resolve_resume_from(train_cfg, output_dir)
    if resume_from:
        print(f"\nResuming from checkpoint: {resume_from}")
        trainer.load_checkpoint(resume_from)

    n_steps = train_cfg["n_steps"]
    print(f"\nStarting training for {n_steps} steps...")
    print(f"Output directory: {output_dir}")
    start_time = datetime.now()
    try:
        stats = trainer.train(
            train_iter=iter(train_loader),
            val_iter_factory=(None if val_loader is None
                              else lambda: iter(val_loader)),
            n_steps=n_steps)
    finally:
        train_loader.close()
        if val_loader is not None:
            val_loader.close()
    end_time = datetime.now()
    if not is_primary():
        return trainer, stats
    write = save_yaml if config_path is not None else save_json_yaml
    write({
        "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "n_devices": process_count(),
        "n_processes": process_count(),
        "n_params": int(n_params),
        "compute_dtype": model_cfg.compute_dtype,
        "training_time": str(end_time - start_time),
        "start_time": start_time.isoformat(),
        "end_time": end_time.isoformat(),
        "samples_per_sec": float(stats["samples_per_sec"]),
    }, output_dir / "training_info.yaml")
    print(f"Training info saved to {output_dir / 'training_info.yaml'}")
    print("\nDone!")
    return trainer, stats


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Train as the YAML config at ``config_path`` says."""
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Train VAE on TEMPO tiles (one GPU)")
