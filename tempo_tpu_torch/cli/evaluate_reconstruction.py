#!/usr/bin/env python3
"""Checkpoint-sweep reconstruction evaluation on one GPU; counterpart of
tempo_tpu/cli/evaluate_reconstruction.py.

    python -m tempo_tpu_torch.cli.evaluate_reconstruction config.yaml [--overwrite] [--debug]

For every checkpoint of an experiment directory (``model.checkpoint_pattern``
relative to ``exp_dir``, as checkpoints/ckpt_step=*.msgpack in the repo's
configs; by default every ``ckpt_step=*`` checkpoint of
``exp_dir``/checkpoints: the port's ``.pt`` files, reference torch
checkpoints and the JAX package's ``.msgpack`` files, all read by
train/checkpoint.py ``load_params``), evaluate MSE / MAE / PSNR (and
``pk_err`` when listed) over the validation tiles (``data.val_dir``: .npy
shards, else reference .pt shards); write
results/reconstruction_metrics.json, figures/metrics_vs_step.png and
figures/best_metrics_summary.png into ``exp_dir``/<output_dir name>, as the
JAX CLI does. ``run(config_dict)`` is the same run from a dict (no YAML
reader needed); the training config it reads is YAML, or JSON where PyYAML
is absent.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.tiles import load_tile_shard
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.sweep import evaluate_checkpoints
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.utils import figures as fig_kit
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory

LOWER_IS_BETTER = {"mse", "mae", "pk_err"}


def _best_entry(results, metric):
    pick = min if metric in LOWER_IS_BETTER else max
    return pick(results, key=lambda r: r[metric])


def save_sweep_figures(output_dir: Path, results: List[Dict],
                       metrics_list, exp_name: str, dpi: int = 150) -> dict:
    """metrics_vs_step.png (each metric against the step, the best
    checkpoint starred) and best_metrics_summary.png (annotated bars);
    returns the best checkpoint of each metric."""
    steps = [r["step"] for r in results]
    best = {m: _best_entry(results, m) for m in metrics_list}

    fig, axes = fig_kit.new_grid(1, len(metrics_list), panel=(5, 4))
    for ax, metric in zip(axes[0], metrics_list):
        fig_kit.curve_panel(ax, steps, {metric: [r[metric] for r in results]},
                            title=f"{metric.upper()} vs Training Step",
                            xlabel="Training Step", ylabel=metric.upper())
        champion = best[metric]
        fig_kit.mark_point(ax, champion["step"], champion[metric],
                           f"Best: {champion[metric]:.4f}")
    fig_kit.finish(fig, output_dir / "figures" / "metrics_vs_step.png",
                   suptitle=f"Reconstruction Metrics - {exp_name}", dpi=dpi)

    fig, axes = fig_kit.new_grid(1, 1, panel=(8, 5))
    fig_kit.annotated_bars(
        axes[0, 0], [m.upper() for m in metrics_list],
        [best[m][m] for m in metrics_list],
        labels=[f"{best[m][m]:.4f}\n(step {best[m]['step']})"
                for m in metrics_list],
        title="Best Checkpoint Performance by Metric")
    fig_kit.finish(fig, output_dir / "figures" / "best_metrics_summary.png",
                   dpi=dpi)
    return {m: {"value": best[m][m], "step": best[m]["step"],
                "checkpoint": best[m]["checkpoint"]} for m in metrics_list}


def load_val_tiles(val_dir: Path, max_val: Optional[int] = None,
                   debug: bool = False) -> np.ndarray:
    """[N, H, W, C] fp32 validation tiles from .npy shards (else reference
    .pt shards), at most ``max_val`` of them."""
    shards = sorted(val_dir.glob("*.npy")) or sorted(val_dir.glob("*.pt"))
    if debug:
        shards = shards[:1]
    tiles = []
    for shard in shards:
        batch = load_tile_shard(shard)
        if batch.ndim == 3:
            batch = batch[None]
        tiles.append(np.asarray(batch, dtype=np.float32))
        if max_val is not None and sum(t.shape[0] for t in tiles) >= max_val:
            break
    val_tiles = np.concatenate(tiles, axis=0)
    if max_val is not None:
        val_tiles = val_tiles[:max_val]
    return val_tiles[:2] if debug else val_tiles


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> List[Dict]:
    """The sweep as the config dict says, on ``device`` (None: CUDA,
    raising without it); returns the results."""
    require_keys(config, ["exp_dir", "output_dir"])
    dev = resolve_device(device)
    exp_dir = Path(config["exp_dir"])
    if not exp_dir.exists():
        raise ValueError(f"FATAL: Experiment directory {exp_dir} does not "
                         f"exist")
    training_config_path = exp_dir / config["model"]["training_config_path"]
    if not training_config_path.exists():
        raise ValueError(f"FATAL: Training config not found at "
                         f"{training_config_path}")
    val_dir = Path(config["data"]["val_dir"])
    if not val_dir.exists():
        raise ValueError(f"FATAL: Validation directory {val_dir} does not "
                         f"exist")

    output_dir = init_directory(exp_dir / Path(config["output_dir"]).name,
                                overwrite=overwrite)
    (output_dir / "figures").mkdir(parents=True, exist_ok=True)
    (output_dir / "results").mkdir(parents=True, exist_ok=True)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    train_config = load_config(training_config_path)
    val_tiles = load_val_tiles(val_dir, config["data"].get("max_val_samples"),
                               debug)
    print(f"Loaded {val_tiles.shape[0]} validation tiles")

    model, _ = build_vae(train_config.get("model", {}), device=dev,
                         seed=config.get("seed", 42))
    evaluation = config.get("evaluation", {})
    metrics_list = evaluation.get("metrics", ["mse", "mae", "psnr"])
    pattern = config["model"].get("checkpoint_pattern")
    results = evaluate_checkpoints(
        model, exp_dir if pattern else exp_dir / "checkpoints", val_tiles,
        batch_size=evaluation.get("batch_size", 8),
        metrics_list=metrics_list, max_checkpoints=1 if debug else None,
        pattern=pattern)

    results_file = output_dir / "results" / "reconstruction_metrics.json"
    results_file.write_text(json.dumps(results, indent=2))
    print(f"Saved results to {results_file}")

    plotting = config.get("plotting", {})
    if plotting.get("plot_metrics", True) and len(results) > 1:
        best = save_sweep_figures(output_dir, results, metrics_list,
                                  exp_dir.name, dpi=plotting.get("dpi", 150))
        print("Best checkpoints:", json.dumps(best, indent=2))
    print(f"\nEvaluation complete! Results saved to {output_dir}")
    return results


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """The sweep as the YAML config at ``config_path`` says."""
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Evaluate reconstruction across checkpoints")
