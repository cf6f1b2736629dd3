#!/usr/bin/env python3
"""Train the VAE with multi-task L2 product supervision on one GPU or
data-parallel over many; counterpart of tempo_tpu/cli/train_vae_l2.py.

    python -m tempo_tpu_torch.cli.train_vae_l2 config.yaml [--overwrite] [--debug]
    torchrun --nproc-per-node=N -m tempo_tpu_torch.cli.train_vae_l2 config.yaml

Dict batches of spectral tiles and the L2 products' fields from
``data.data_dir``/train (and /val when it exists), through the host
TileLoader or, with ``data.loader: device``, the DeviceTileBuffer; the
model is VAEWithL2Head (models/vae_l2.py) and one AdamW over all its
parameters, after the global-norm clip at 1.0. The ``l2:`` section sets
``components`` (default NO2, O3TOT, HCHO, CLDO4), per-product ``weights``
(default 0.1) and the head's ``mlp_hidden`` (default [512, 512]).
``model.init_from_vae_checkpoint`` warm-starts ``vae.*`` from a checkpoint
of the port's train_vae or the JAX package's (a ``.msgpack``, through
train/checkpoint.py ``load_params``; the optimizer starts fresh, over every
parameter). The config, --overwrite, --debug, ``training.resume_from``
(auto or a path), ``training.grad_accum``, ``training.metrics_jsonl`` and
``training.checkpoint_format`` (msgpack, async or sharded) behave as in the port's
train_vae; ``training.profile_steps`` is neither read nor refused, as the
JAX CLI reads none. The artifacts are train_vae's plus
summary/l2_losses.png, the L2 panels of the figures, and the products and
weights in training_info.yaml.

Parallelism as in the port's train_vae (torchrun or ``distributed:``,
DDP over the ranks, the loaders' local batches and seeds, ``data.partition``
for the device buffer, rank 0 writing), without FSDP: as the JAX CLI, it
reads no ``parallel.fsdp``; ``parallel.tensor: N`` as in train_vae. The
L2 losses divide by the valid positions of the global batch
(models/vae_l2.py ``masked_mse``, the counts summed over the data axis),
as JAX's mesh step.

``run(config_dict)`` is the same run from a dict: it needs no YAML
reader, and writes config.yaml and training_info.yaml as JSON, which
YAML readers read. Not ported: as train_vae.
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from tempo_tpu_torch.cli import (host_batch, loader_seed, parallel_group,
                                 parallel_plan, parallelize, run_cli,
                                 start_run_directory)
from tempo_tpu_torch.cli.train_vae import (_metric_sinks, make_train_loader,
                                           refuse_unported)
from tempo_tpu_torch.data.loader import TileLoader
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.vae_l2 import L2_PRODUCTS, build_vae_l2
from tempo_tpu_torch.parallel.mesh import is_primary, process_count
from tempo_tpu_torch.train.checkpoint import (load_params,
                                              resolve_resume_from)
from tempo_tpu_torch.train.state import (create_train_state,
                                         make_optimizer_from_config)
from tempo_tpu_torch.train.step import vae_l2_loss_fn
from tempo_tpu_torch.train.trainer import Trainer
from tempo_tpu_torch.utils.config import (load_config, require_keys,
                                          save_json_yaml)


def validate_config(config: Dict[str, Any]) -> None:
    require_keys(config, ["output_dir", "data", "data.data_dir", "model",
                          "training"])
    data_dir = Path(config["data"]["data_dir"])
    if not data_dir.exists():
        raise ValueError(f"FATAL: data directory doesn't exist: {data_dir}")
    refuse_unported(config, "train_vae_l2")


def warm_start_vae(model, path: Union[str, Path]) -> None:
    """Load ``vae.*`` from a VAE checkpoint (strict: the same VAE
    architecture): the port's train_vae ``.pt`` or the JAX package's
    ``.msgpack``."""
    load_params(path, model.vae)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None):
    """Train as the config dict says, on ``device`` (None: CUDA, raising
    without it); returns the Trainer and its throughput stats.
    ``config_path`` is copied into the run as config.yaml; without it the
    dict is written there."""
    validate_config(config)
    plan = parallel_plan(config, "train_vae_l2")
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

    l2_cfg = config.get("l2") or {}
    products = list(l2_cfg.get("components", L2_PRODUCTS))
    l2_weights = {p: float((l2_cfg.get("weights") or {}).get(p, 0.1))
                  for p in products}
    mlp_hidden = tuple(l2_cfg.get("mlp_hidden", [512, 512]))

    data_cfg = config["data"]
    data_dir = Path(data_cfg["data_dir"])
    batch_size = data_cfg.get("batch_size", 32)
    print("\nLoading training data...")
    train_loader = make_train_loader(data_cfg, data_dir / "train", batch_size,
                                     seed, dev, l2_products=products,
                                     mesh=mesh)
    val_loader = None
    if (data_dir / "val").exists():
        print("\nLoading validation data...")
        val_loader = TileLoader(
            data_dir=data_dir / "val",
            batch_size=host_batch(batch_size, mesh),
            min_buffer_size=data_cfg.get("val_min_buffer_size", 100),
            l2_products=products, seed=loader_seed(seed, mesh) + 1,
            num_threads=data_cfg.get("val_num_workers", 1), verbose=True)

    try:
        print("\nInitializing model...")
        model, model_cfg = build_vae_l2(config["model"] or {}, mlp_hidden,
                                        device=dev, seed=seed)
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Model parameters (VAE + L2 head): {n_params:,}")
        init = config["model"].get("init_from_vae_checkpoint")
        if init is not None:
            warm_start_vae(model, init)
            print(f"Initialized VAE weights from {init}")

        train_cfg = config["training"]
        tx = make_optimizer_from_config(
            config.get("optimizer", {}),
            n_steps=int(train_cfg.get("n_steps", 10_000)))
        state = parallelize(create_train_state(model, tx, seed + 2), tx,
                            mesh, plan)
        trainer = Trainer(
            loss_fn=vae_l2_loss_fn(model, l2_weights), tx=tx, state=state,
            output_dir=output_dir,
            save_every=train_cfg.get("save_every", 1000),
            val_every=train_cfg.get("val_every", 100),
            log_every=train_cfg.get("log_every", 10),
            plot_every=train_cfg.get("plot_every", 50),
            grad_accum=int(train_cfg.get("grad_accum", 1)), device=dev,
            recon_fn=lambda m, x, g: m(x, g), l2_products=products,
            checkpoint_format=train_cfg.get("checkpoint_format", "msgpack"),
            metric_sinks=_metric_sinks(train_cfg, output_dir))
        resume_from = resolve_resume_from(train_cfg, output_dir)
        if resume_from:
            print(f"\nResuming from checkpoint: {resume_from}")
            trainer.load_checkpoint(resume_from)

        n_steps = train_cfg["n_steps"]
        print(f"\nStarting L2-supervised training for {n_steps} steps...")
        start_time = datetime.now()
        stats = trainer.train(
            train_iter=iter(train_loader),
            val_iter_factory=(None if val_loader is None
                              else lambda: iter(val_loader)),
            n_steps=n_steps)
        end_time = datetime.now()
    finally:
        train_loader.close()
        if val_loader is not None:
            val_loader.close()
    if not is_primary():
        return trainer, stats
    save_json_yaml({
        "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else str(dev)),
        "n_devices": process_count(),
        "n_processes": process_count(),
        "n_params": int(n_params),
        "compute_dtype": model_cfg.compute_dtype,
        "l2_products": products,
        "l2_weights": l2_weights,
        "loader": data_cfg.get("loader", "host"),
        "training_time": str(end_time - start_time),
        "samples_per_sec": float(stats["samples_per_sec"]),
    }, output_dir / "training_info.yaml")
    print("\nDone!")
    return trainer, stats


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Train as the YAML config at ``config_path`` says."""
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Train VAE with L2 multi-task supervision (one GPU)")
