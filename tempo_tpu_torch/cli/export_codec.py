#!/usr/bin/env python3
"""Export a trained codec as serving artifacts; counterpart of
tempo_tpu/cli/export_codec.py.

    python -m tempo_tpu_torch.cli.export_codec config.yaml [--overwrite] [--debug]

Builds the VAE from the run's training config, loads a checkpoint's
parameters (train/checkpoint.py ``load_params``: the port's ``.pt``
checkpoints; ``.msgpack`` raises NotImplementedError, M11) and writes
``<output_dir>/codec/`` through infer/export_codec.py (``torch.export``
programs with the weights inside and a symbolic batch, and meta.json). A
serving host loads them with ``load_exported``, which needs the port's op
registrations and no model code. It then loads the artifacts and runs a
batch of 2 through both directions, as the JAX CLI does.

Config keys: output_dir, model.{checkpoint_path,training_config_path},
optional tile_hw [H, W] (defaults to the training tile size).
``run(config_dict)`` is the same export from a dict (config.yaml written
as JSON); both take ``device`` (None: CUDA, raising without it).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.export_codec import export_codec, load_exported
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.train.checkpoint import load_params
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Path:
    """Export as the config dict says, on ``device``; returns the artifact
    directory."""
    require_keys(config, ["output_dir", "model"])
    require_keys(config["model"], ["checkpoint_path", "training_config_path"])
    dev = resolve_device(device)

    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    train_config = load_config(config["model"]["training_config_path"])
    model, model_cfg = build_vae(train_config.get("model", {}), device=dev)
    tile_hw = tuple(config.get("tile_hw",
                               (model_cfg.input_size, model_cfg.input_size)))
    load_params(config["model"]["checkpoint_path"], model)

    out = export_codec(model, output_dir / "codec", tile_hw=tile_hw)
    print(f"Exported codec to {out}")

    # smoke: rehydrate and run one batch through both directions
    encode, decode, meta = load_exported(out, device=dev)
    x = torch.zeros((2, *tile_hw, model_cfg.in_channels), device=dev)
    z = encode(x)
    rec = decode(z)
    if rec.shape != x.shape:
        raise RuntimeError(f"the exported roundtrip gave {tuple(rec.shape)} "
                           f"for {tuple(x.shape)}")
    print(f"Verified roundtrip: {tuple(x.shape)} -> {tuple(z.shape)} -> "
          f"{tuple(rec.shape)}")
    return out


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, description=__doc__)
