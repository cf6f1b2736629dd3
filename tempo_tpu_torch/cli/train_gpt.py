#!/usr/bin/env python3
"""Train a GPT (dense or mixture-of-experts) on a token stream, or LoRA
fine-tune one, on one GPU; counterpart of tempo_tpu/cli/train_gpt.py's
single-device path.

    python -m tempo_tpu_torch.cli.train_gpt config.yaml [--overwrite] [--debug]

The same config schema, directory contract and artifacts: config.yaml
copied into output_dir, checkpoints/ckpt_step=NNNNNN.pt, metrics.json,
summary plots, training_info.yaml, and generation_final.npy (a greedy
continuation of the stream's first 8 tokens). The step is forward (the
attention through K5, ops/flash_attention.py), backward and AdamW with the
GPT two-group weight decay and no clipping (nn/transformer.py
make_gpt_optimizer; ``optimizer.moments_dtype: bfloat16`` keeps the first
moment in bf16). ``model.n_experts`` > 0 trains the MoE FFN (nn/moe.py,
``expert_top_k``, ``expert_capacity_factor``) with
``training.moe_aux_weight`` (default 0.01) times the Switch loss added
and logged as ``moe_aux``; ``model.dropout`` > 0 trains with dropout (the
attention materialized, as JAX's: no K5). ``finetune.lora_rank`` > 0
freezes a base checkpoint (``finetune.base_checkpoint``, or the latest of
``finetune.base_run``'s; the port's .pt or the JAX package's .msgpack) and
trains rank-r adapters (nn/lora.py; ``finetune.lora_scale``, default 1):
the checkpoints hold the adapters, and the run ends by writing
checkpoints/merged_final.pt (the base plus scale * a @ b, a plain
checkpoint that export_lm and load_params read; JAX writes
merged_final.msgpack) and generating from the merged weights.
Weights come from the config's seed through the
port's own initializer, so a run does not reproduce the JAX package's
weights; tests bridge weights where they compare the two.
``training.checkpoint_format: async`` writes the same checkpoints on a
background thread while training goes on (train/checkpoint.py
AsyncCheckpointer). As the JAX CLI, it reads no ``training.metrics_jsonl``
or ``training.profile_steps``.

``run(config_dict)`` is the same run from a dict: it needs no YAML reader,
and writes config.yaml and training_info.yaml as JSON, which YAML readers
read.

Not ported (NotImplementedError from validate_config): ``parallel.*``
(pipeline, tensor, expert, context, fsdp) and
``training.checkpoint_format: sharded`` (M13).
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.tokens import TokenLoader, make_token_stream
from tempo_tpu_torch.nn.transformer import (Transformer, TransformerConfig,
                                           generate, make_gpt_optimizer,
                                           num_params)
from tempo_tpu_torch.nn.lora import LoRA, init_lora, num_lora_params
from tempo_tpu_torch.train.checkpoint import (check_format,
                                              latest_checkpoint, load_params,
                                              resolve_resume_from,
                                              wants_auto_resume)
from tempo_tpu_torch.train.schedules import lr_schedule
from tempo_tpu_torch.train.state import create_train_state
from tempo_tpu_torch.train.step import lm_loss_fn
from tempo_tpu_torch.train.trainer import Trainer
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml,
                                          save_yaml)
from tempo_tpu_torch.utils.dirs import init_directory

# parallel.* keys and the values that mean "not parallel"
_SERIAL = {"pipeline": 1, "tensor": 1, "expert": 1, "context": 1,
           "context_zigzag": False, "fsdp": False, "n_micro": None}


def build_transformer_config(model_cfg: dict) -> TransformerConfig:
    """`model:` config section -> TransformerConfig (lists become
    tuples)."""
    return TransformerConfig(**{
        k: (tuple(v) if isinstance(v, list) else v)
        for k, v in model_cfg.items()})


def validate_config(config) -> None:
    require_keys(config, ["output_dir", "data", "model", "training"])
    data = config["data"]
    if "tokens" not in data and "synthetic" not in data:
        raise ValueError("FATAL: data needs 'tokens' (npy path) or "
                         "'synthetic' ({vocab_size, length})")
    if "tokens" in data and not Path(data["tokens"]).exists():
        raise ValueError(f"FATAL: token stream doesn't exist: {data['tokens']}")
    for key, value in dict(config.get("parallel", {})).items():
        if key not in _SERIAL:
            raise ValueError(f"FATAL: unknown parallel.{key}")
        if _SERIAL[key] is not None and value != _SERIAL[key]:
            raise NotImplementedError(
                f"parallel.{key}={value!r} is not ported: the port trains on "
                f"one device")
    ft = dict(config.get("finetune", {}))
    if int(ft.get("lora_rank", 0)) > 0 and ("base_checkpoint" not in ft
                                            and "base_run" not in ft):
        raise ValueError("FATAL: finetune.lora_rank needs "
                         "finetune.base_checkpoint (ckpt path) or "
                         "finetune.base_run (train_gpt output dir)")
    check_format(config["training"].get("checkpoint_format", "msgpack"))


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None):
    """Train as the config dict says, on ``device`` (None: CUDA, raising
    without it); returns the Trainer and its throughput stats.
    ``config_path`` is copied into the run as config.yaml; without it the
    dict is written there, and training_info.yaml too, as JSON."""
    validate_config(config)
    resume_auto = wants_auto_resume(config["training"])
    output_dir = init_directory(Path(config["output_dir"]),
                                overwrite=overwrite,
                                allow_existing=resume_auto)
    (output_dir / "checkpoints").mkdir(parents=True, exist_ok=True)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    seed = config.get("seed", 42)
    if debug:
        print("DEBUG MODE: Reduced training steps")
        config["training"]["n_steps"] = min(
            200, config["training"].get("n_steps", 10000))
        config["training"]["save_every"] = 100
        config["training"]["val_every"] = 50
        config["training"]["plot_every"] = 25

    data_cfg = config["data"]
    if "tokens" in data_cfg:
        stream = np.load(data_cfg["tokens"], mmap_mode="r")
    else:
        syn = dict(data_cfg["synthetic"])
        print(f"Generating synthetic token stream: {syn}")
        stream = make_token_stream(int(syn["vocab_size"]), int(syn["length"]),
                                   seed=seed,
                                   noise=float(syn.get("noise", 0.1)))

    model_cfg = dict(config["model"])
    if "in_size" not in model_cfg:
        model_cfg["in_size"] = int(stream.max()) + 1
    vocab = int(model_cfg["in_size"])
    tconfig = build_transformer_config(model_cfg)
    print("\nInitializing GPT...")
    model = Transformer(tconfig, device=device, seed=seed)
    n_params = num_params(model)
    print(f"Parameters: {n_params:,} (non-embedding)")
    trained = model
    lora_rank = int(dict(config.get("finetune", {})).get("lora_rank", 0))
    if lora_rank > 0:
        trained = _lora_model(config["finetune"], model, seed)

    batch_size = int(data_cfg.get("batch_size", 16))
    train_loader = TokenLoader(stream, batch_size, tconfig.block_size,
                               seed=seed + 1)
    val_loader = TokenLoader(stream, batch_size, tconfig.block_size,
                             seed=seed + 2)

    opt_cfg = dict(config.get("optimizer", {}))
    train_cfg = config["training"]
    tx = make_gpt_optimizer(
        trained, weight_decay=float(opt_cfg.get("weight_decay", 0.1)),
        learning_rate=lr_schedule(opt_cfg, int(train_cfg.get("n_steps",
                                                             10_000))),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.95))),
        moments_dtype=opt_cfg.get("moments_dtype"))
    state = create_train_state(trained, tx, seed + 3)
    aux_weight = float(train_cfg.get("moe_aux_weight", 0.01))
    trainer = Trainer(
        loss_fn=lm_loss_fn(model, aux_weight), tx=tx, state=state,
        output_dir=output_dir,
        save_every=train_cfg.get("save_every", 1000),
        val_every=train_cfg.get("val_every", 100),
        log_every=train_cfg.get("log_every", 10),
        plot_every=train_cfg.get("plot_every", 50),
        grad_accum=int(train_cfg.get("grad_accum", 1)),
        device=device,
        checkpoint_format=train_cfg.get("checkpoint_format", "msgpack"))
    resume_from = resolve_resume_from(train_cfg, output_dir)
    if resume_from:
        print(f"\nResuming from checkpoint: {resume_from}")
        trainer.load_checkpoint(resume_from)

    n_steps = train_cfg["n_steps"]
    print(f"\nTraining GPT for {n_steps} steps...")
    start_time = datetime.now()
    stats = trainer.train(train_iter=iter(train_loader),
                          val_iter_factory=lambda: iter(val_loader),
                          n_steps=n_steps)
    end_time = datetime.now()
    write = save_yaml if config_path is not None else save_json_yaml
    write({
        "seed": seed,
        "vocab_size": vocab,
        "n_params_non_embedding": int(n_params),
        "n_experts": tconfig.n_experts,
        "pipeline_stages": 1,
        "training_time": str(end_time - start_time),
        "samples_per_sec": float(stats["samples_per_sec"]),
    }, output_dir / "training_info.yaml")

    if trained is not model:
        # a plain checkpoint of the merged weights, for export and serving
        merged = trained.merged_state_dict()
        model = Transformer(tconfig, device="meta")
        model.load_state_dict(merged, assign=True)
        merged_path = output_dir / "checkpoints" / "merged_final.pt"
        torch.save({"step": int(trainer.state.step),
                    "model": {k: v.cpu() for k, v in merged.items()}},
                   merged_path)
        print(f"Merged LoRA checkpoint: {merged_path}")

    # end-of-run greedy continuation of the stream's first tokens
    n_tokens = int(dict(config.get("generation", {})).get(
        "n_tokens", 16 if debug else 64))
    prompt_len = 8
    room = tconfig.block_size - prompt_len
    if n_tokens > room:
        print(f"generation.n_tokens={n_tokens} clamped to {room} (prompt "
              f"{prompt_len} + new tokens must fit the block size "
              f"{tconfig.block_size})")
        n_tokens = room
    if n_tokens > 0:
        prompt = np.asarray(stream[:prompt_len])[None].astype(np.int64)
        continuation = generate(model, prompt, n_tokens,
                                temperature=0.0).cpu().numpy()
        np.save(output_dir / "generation_final.npy",
                continuation.astype(np.int32))
        print(f"Greedy continuation: {continuation[0][:24]}...")
    print("\nDone!")
    return trainer, stats


def _lora_model(ft_cfg: dict, model: Transformer, seed: int) -> LoRA:
    """The base checkpoint loaded into ``model`` (frozen) and rank-r
    adapters over it, drawn from seed + 7 (JAX's key)."""
    base_ckpt = ft_cfg.get("base_checkpoint")
    if base_ckpt is None:
        base_ckpt = latest_checkpoint(Path(ft_cfg["base_run"]) / "checkpoints")
        if base_ckpt is None:
            raise ValueError(f"FATAL: no checkpoints in {ft_cfg['base_run']}")
    print(f"LoRA base: {base_ckpt}")
    load_params(base_ckpt, model)
    scale = float(ft_cfg.get("lora_scale", 1.0))
    adapters = init_lora(model, int(ft_cfg["lora_rank"]), seed + 7)
    print(f"LoRA fine-tune: rank {ft_cfg['lora_rank']}, scale {scale}, "
          f"{num_lora_params(adapters):,} trainable adapter params")
    return LoRA(model, adapters, scale)


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Train as the YAML config at ``config_path`` says."""
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Train a GPT on a token stream (one GPU)")
