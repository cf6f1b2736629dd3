#!/usr/bin/env python3
"""Train the TEMPO spectral VAE on one GPU; counterpart of
tempo_tpu/cli/train_vae.py's single-device path.

    python -m tempo_tpu_torch.cli.train_vae config.yaml [--overwrite] [--debug]

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
background thread while training goes on.

``run(config_dict)`` is the same run from a dict: it needs no YAML reader,
and writes config.yaml and training_info.yaml as JSON, which YAML readers
read.

Not ported (NotImplementedError from validate_config): ``distributed``
(multi-host), ``parallel.tensor`` > 1 and ``parallel.fsdp``,
``data.partition: process`` and ``training.checkpoint_format: sharded``
(M13).
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.device_buffer import DeviceTileBuffer
from tempo_tpu_torch.data.loader import TileLoader
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.train.checkpoint import (check_format,
                                              resolve_resume_from,
                                              wants_auto_resume)
from tempo_tpu_torch.train.metrics import JsonlSink
from tempo_tpu_torch.train.schedules import sqrt_save_steps
from tempo_tpu_torch.train.state import (create_train_state,
                                         make_optimizer_from_config)
from tempo_tpu_torch.train.step import vae_loss_fn
from tempo_tpu_torch.train.trainer import Trainer
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml,
                                          save_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def validate_config(config) -> None:
    require_keys(config, ["output_dir", "data", "data.train_dir", "model",
                          "training"])
    data = config["data"]
    for key in ("train_dir", "val_dir"):
        if key in data and not Path(data[key]).exists():
            raise ValueError(f"FATAL: {key} doesn't exist: {data[key]}")
    refuse_unported(config)


def refuse_unported(config) -> None:
    """NotImplementedError for what the port's trainers do not do,
    ValueError for unknown choices."""
    data, train = config["data"], config["training"]
    if dict(config.get("distributed", {})).get("enabled", False):
        raise NotImplementedError("distributed (multi-host) training is not "
                                  "ported: the port trains on one device")
    parallel = dict(config.get("parallel", {}))
    if int(parallel.get("tensor", 1)) != 1:
        raise NotImplementedError("parallel.tensor > 1 is not ported: the "
                                  "port trains on one device")
    if parallel.get("fsdp", False):
        raise NotImplementedError("parallel.fsdp is not ported: the port "
                                  "trains on one device")
    loader = data.get("loader", "host")
    if loader not in ("host", "device"):
        raise ValueError(f"FATAL: data.loader must be 'host' or 'device', "
                         f"got {loader!r}")
    if loader == "device" and data.get("partition") == "process":
        raise NotImplementedError("data.partition: process (a buffer per "
                                  "host process) is not ported: the port "
                                  "trains on one device")
    check_format(train.get("checkpoint_format", "msgpack"))


def _metric_sinks(train_cfg, output_dir):
    """``training.metrics_jsonl: true``: every train and val record to
    logs/metrics.jsonl; counterpart of the JAX CLI's ``_metric_sinks``."""
    if not train_cfg.get("metrics_jsonl"):
        return None
    return [JsonlSink(Path(output_dir) / "logs" / "metrics.jsonl")]


def make_train_loader(data_cfg, train_dir, batch_size: int, seed: int,
                      device, l2_products=None):
    """The training stream ``data.loader`` asks for: the host TileLoader
    or the DeviceTileBuffer on ``device``."""
    if data_cfg.get("loader", "host") == "device":
        return DeviceTileBuffer(
            train_dir, batch_size=batch_size,
            slots=data_cfg.get("buffer_slots", 4),
            swap_every=data_cfg.get("swap_every", 16), seed=seed,
            dtype=data_cfg.get("buffer_dtype", "float32"), device=device,
            l2_products=l2_products)
    return TileLoader(
        data_dir=train_dir, batch_size=batch_size,
        min_buffer_size=data_cfg.get("min_buffer_size", 200),
        l2_products=l2_products, seed=seed,
        prefetch=data_cfg.get("prefetch", 2),
        num_threads=data_cfg.get("loader_threads",
                                 data_cfg.get("num_workers", 2)),
        verbose=True)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None):
    """Train as the config dict says, on ``device`` (None: CUDA, raising
    without it); returns the Trainer and its throughput stats.
    ``config_path`` is copied into the run as config.yaml; without it the
    dict is written there, and training_info.yaml too, as JSON."""
    validate_config(config)
    dev = resolve_device(device)
    resume_auto = wants_auto_resume(config["training"])
    output_dir = init_directory(Path(config["output_dir"]),
                                overwrite=overwrite,
                                allow_existing=resume_auto)
    for sub in ("checkpoints", "figures", "logs"):
        (output_dir / sub).mkdir(parents=True, exist_ok=True)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

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
                                     batch_size, seed, dev)
    val_loader = None
    if "val_dir" in data_cfg:
        print("\nLoading validation data...")
        val_loader = TileLoader(
            data_dir=data_cfg["val_dir"], batch_size=batch_size,
            min_buffer_size=data_cfg.get("val_min_buffer_size", 100),
            seed=seed + 1, num_threads=data_cfg.get("val_num_workers", 1),
            verbose=True)

    print("\nInitializing model...")
    model, model_cfg = build_vae(config.get("model", {}), device=dev,
                                 seed=seed)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"Model parameters: {n_params:,}")

    train_cfg = config["training"]
    tx = make_optimizer_from_config(
        config.get("optimizer", {}),
        n_steps=int(train_cfg.get("n_steps", 10_000)))
    state = create_train_state(model, tx, seed + 2)
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
    write = save_yaml if config_path is not None else save_json_yaml
    write({
        "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "n_devices": 1,
        "n_processes": 1,
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
