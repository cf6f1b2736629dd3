#!/usr/bin/env python3
"""Generate tiles from a trained diffusion or flow-matching run on one
GPU; counterpart of tempo_tpu/cli/sample_diffusion.py.

    python -m tempo_tpu_torch.cli.sample_diffusion config.yaml [--overwrite] [--debug]

Reads a train_diffusion output directory (family vdm or sfm): its copied
config rebuilds the model, schedule and frozen-VAE codec; a checkpoint
(``checkpoint``, else the run's latest; the port's ``.pt`` or, from a JAX
run, a ``.msgpack``, through train/checkpoint.py ``load_params``) gives
the weights; sampling runs on the device (ancestral or DDIM for vdm, SDE
integration for sfm), decoded to pixels when the run trained in latents;
writes samples.npy, samples.png (the first 8) and sampling_info.yaml. A
run without training_info.yaml (preempted, or still running) samples
too.

Config:
  run_dir: <train_diffusion output dir>
  output_dir: <where to write samples>
  checkpoint: <optional explicit ckpt path; default latest in run_dir>
  n_samples: 16
  n_steps: 250
  method: <optional; vdm: ancestral|ddim, sfm: euler|lm;
           default = the train config's sampling.method>
  eta: 0.0   # DDIM noise knob (0 deterministic, 1 == ancestral)
  seed: 0

``run(config_dict)`` is the same run from a dict: it needs no YAML reader
and writes config.yaml and sampling_info.yaml as JSON.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.cli.train_diffusion import (_build_codec,
                                                 _build_generative,
                                                 _make_sampler,
                                                 _save_sample_panel)
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.train.checkpoint import latest_checkpoint, load_params
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Dict[str, Any]:
    """Sample as the config dict says, on ``device`` (None: CUDA, raising
    without it); returns the sampling info."""
    require_keys(config, ["run_dir", "output_dir"])
    dev = resolve_device(device)
    run_dir = Path(config["run_dir"])
    train_cfg_path = run_dir / "config.yaml"
    if not train_cfg_path.exists():
        raise ValueError(f"FATAL: no config.yaml in run dir: {run_dir}")
    train_config = load_config(train_cfg_path)

    output_dir = init_directory(Path(config["output_dir"]),
                                overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    ckpt = config.get("checkpoint")
    if ckpt is None:
        ckpt = latest_checkpoint(run_dir / "checkpoints")
        if ckpt is None:
            raise ValueError(f"FATAL: no checkpoints in {run_dir}")
    print(f"Checkpoint: {ckpt}")

    n_samples = int(config.get("n_samples", 16))
    n_steps = int(config.get("n_steps", 250))
    if debug:
        n_samples, n_steps = min(n_samples, 4), min(n_steps, 20)
    seed = int(config.get("seed", 0))

    # re-derive everything from the copied train config, so that a run
    # without training_info.yaml samples too
    tile = next(Path(train_config["data"]["train_dir"]).glob("*.npy"))
    px = np.load(tile, mmap_mode="r").shape[1:]
    decode_fn = None
    if "latent" in train_config:
        _, decode_fn, z_shape, _ = _build_codec(train_config["latent"],
                                                (2, *px), dev)
        model_shape = tuple(int(s) for s in z_shape[1:])
    else:
        model_shape = tuple(int(s) for s in px)
    model, family = _build_generative(train_config, model_shape, dev)
    load_params(ckpt, model)
    model.eval()

    train_samp = dict(train_config.get("sampling", {}))
    method = str(config.get("method", train_samp.get("method", "euler")))
    eta = float(config.get("eta", train_samp.get("eta", 0.0)))
    print(f"Sampling {n_samples} tiles over {n_steps} steps "
          f"({family}, method={method})...")
    sampler = _make_sampler(model, family, model_shape, n_samples, n_steps,
                            decode_fn=decode_fn, method=method, eta=eta)
    samples = sampler(torch.Generator(device=dev).manual_seed(seed))
    samples = samples.float().cpu().numpy()
    np.save(output_dir / "samples.npy", samples)
    _save_sample_panel(output_dir / "samples.png", samples[:8])
    info = {"checkpoint": str(ckpt), "family": family,
            "n_samples": n_samples, "n_steps": n_steps, "seed": seed,
            "method": method, "eta": eta,
            "sample_shape": list(samples.shape)}
    save_json_yaml(info, output_dir / "sampling_info.yaml")
    print(f"Wrote {samples.shape} -> {output_dir / 'samples.npy'}")
    print("\nDone!")
    return info


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Sample as the YAML config at ``config_path`` says."""
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Sample tiles from a trained diffusion run (one GPU)")
