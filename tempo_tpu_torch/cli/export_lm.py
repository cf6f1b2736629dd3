#!/usr/bin/env python3
"""Export a trained GPT run as serving artifacts; counterpart of
tempo_tpu/cli/export_lm.py.

    python -m tempo_tpu_torch.cli.export_lm config.yaml [--overwrite] [--debug]

Reads a ``tempo_tpu_torch.cli.train_gpt`` output directory, or a JAX
``tempo_tpu.cli.train_gpt`` one: rebuilds the model's config from the run's
copied config.yaml the way train_gpt does (``build_transformer_config``;
the vocabulary from ``model.in_size`` or the run's training_info.yaml),
loads a checkpoint's parameters (train/checkpoint.py ``load_params``: the
latest ``ckpt_step=*.pt`` or ``ckpt_step=*.msgpack`` by default) and
writes ``<output_dir>/lm/`` through infer/export_lm.py ``export_lm``: the
``torch.export`` programs (traced on the CPU; one artifact serves the CPU
and the card), weights.pt and meta.json. It then checks that greedy
decoding through the loaded programs equals ``generate`` of the live
model, on ``device`` (None: CUDA), and writes export_info.yaml.

``quantize: int8`` exports the weight-only int8 model (nn/quant.py
``quantize_lm_params``: int8 block matmuls and token table with fp32
scales; weights.pt and the programs' weight input carry the int8 tensors
and their scales, and meta.json says ``quantize: int8``); the round-trip
check then holds the programs to the live int8 model. An MoE run is
refused (NotImplementedError from export_lm: the expert capacity needs the
batch, which the programs keep symbolic; the JAX package's export fails
there too). A pipeline run's checkpoint is merged back to one model's
blocks, as JAX's export merges it: the port's ``.pt`` holds one device's
keys, and JAX's ``.msgpack`` and either package's ``.shards`` their
(rest, stage_stack) trees, which ``load_params`` merges.

Config:
  run_dir: <train_gpt output dir>
  output_dir: <where to write artifacts>
  checkpoint: <optional explicit ckpt path; default latest in run_dir>
  quantize: none | int8
  max_seq: <optional, default block_size>  # serving-window cache size
  decode_chunk: 8                   # K of the fused decode calls (0: none)
  page_size: 0                      # >0: the paged calls too
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def _resolve_vocab(train_config: dict, run_dir: Path) -> int:
    """The trained vocabulary: pinned in the config, or recorded by the
    completed run."""
    if "in_size" in train_config["model"]:
        return int(train_config["model"]["in_size"])
    info_path = run_dir / "training_info.yaml"
    if info_path.exists():
        return int(load_config(str(info_path))["vocab_size"])
    raise ValueError(
        "FATAL: vocab size unknown — the run's config has no model.in_size "
        f"and {info_path} does not exist (incomplete run). Pass the vocab "
        "by adding model.in_size to the run's config.yaml.")


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Export as the config says; the round-trip check runs on ``device``
    (None: CUDA)."""
    from tempo_tpu_torch.cli.train_gpt import build_transformer_config
    from tempo_tpu_torch.infer.export_lm import (export_lm,
                                                 greedy_decode_exported)
    from tempo_tpu_torch.nn.transformer import (Transformer, generate,
                                                num_params)
    from tempo_tpu_torch.train.checkpoint import (latest_checkpoint,
                                                  load_params)

    config = load_config(config_path)
    require_keys(config, ["run_dir", "output_dir"])
    run_dir = Path(config["run_dir"])
    train_cfg_path = run_dir / "config.yaml"
    if not train_cfg_path.exists():
        raise ValueError(f"FATAL: no config.yaml in run dir: {run_dir}")
    train_config = load_config(str(train_cfg_path))
    quantize = str(config.get("quantize", "none")).lower()
    if quantize not in ("none", "int8"):
        raise ValueError(f"FATAL: unknown quantize mode {quantize!r} "
                         "(none | int8)")
    # a pipeline run's checkpoint: the port's .pt holds one device's keys;
    # JAX's .msgpack and either package's .shards hold (rest, stage_stack),
    # which load_params merges back to the blocks the serving graph runs
    stages = int(train_config.get("parallel", {}).get("pipeline", 1))

    ckpt = config.get("checkpoint")
    if ckpt is None:
        ckpt = latest_checkpoint(run_dir / "checkpoints")
        if ckpt is None:
            raise ValueError(f"FATAL: no checkpoints in {run_dir}")
    output_dir = init_directory(Path(config["output_dir"]),
                                overwrite=overwrite)
    copy_config(config_path, output_dir)
    print(f"Checkpoint: {ckpt}")

    model_cfg = dict(train_config["model"])
    model_cfg["in_size"] = _resolve_vocab(train_config, run_dir)
    tconfig = build_transformer_config(model_cfg)
    state = load_params(ckpt, Transformer(tconfig, device="cpu")).state_dict()
    if quantize == "int8":
        from tempo_tpu_torch.nn.quant import quantize_lm_params

        print("Quantizing weights to int8 (weight-only, per-channel)")
        tconfig = dataclasses.replace(tconfig, quantize="int8")
        state = quantize_lm_params(state)
    max_seq = config.get("max_seq")
    out = export_lm(state, tconfig, output_dir / "lm",
                    max_seq=int(max_seq) if max_seq else None,
                    decode_chunk=int(config.get("decode_chunk", 8)),
                    page_size=int(config.get("page_size", 0)))
    meta = json.loads((out / "meta.json").read_text())
    print(f"Exported {len(meta['programs'])} torch.export programs + "
          f"weights.pt + meta.json to {out}")

    # the artifacts' greedy decode must equal the live model's
    model = Transformer(tconfig, device=device)
    model.load_state_dict(state)
    limit = int(max_seq) if max_seq else tconfig.block_size
    n_check = min(4 if debug else 8, limit - 4)
    prompt = np.arange(4, dtype=np.int64)[None] % tconfig.in_size
    got = greedy_decode_exported(out, prompt, n_check, device=device)
    ref = generate(model, prompt, n_check, temperature=0.0,
                   cache_dtype=tconfig.dtype, cache_len=limit).cpu().numpy()
    np.testing.assert_array_equal(got, ref)
    print(f"Verified roundtrip: prompt {prompt.shape} -> {got.shape} greedy "
          "tokens match the live model")

    save_yaml({"checkpoint": str(ckpt), "quantize": quantize,
               "vocab_size": int(tconfig.in_size),
               "n_params": int(num_params(model)),
               "max_seq": limit, "pipeline_stages_merged": stages},
              output_dir / "export_info.yaml")
    print("\nDone!")


if __name__ == "__main__":
    run_cli(main, "Export a trained GPT run as serving artifacts")
