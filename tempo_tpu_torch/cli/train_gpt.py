#!/usr/bin/env python3
"""Train a GPT (dense or mixture-of-experts) on a token stream, or LoRA
fine-tune one, on one GPU or sharded over many; counterpart of
tempo_tpu/cli/train_gpt.py.

    python -m tempo_tpu_torch.cli.train_gpt config.yaml [--overwrite] [--debug]
    torchrun --nproc-per-node=N -m tempo_tpu_torch.cli.train_gpt config.yaml

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

``parallel.fsdp: true`` shards the parameters and AdamW's moments with
FSDP2 (parallel/fsdp.py) over the run's processes (torchrun or
``distributed:``, parallel/mesh.py; one process alone is a mesh of one, as
JAX's one-device mesh); several processes without it train under DDP.
``data.batch_size`` is the global batch, as JAX's: every rank draws it
from the shared seed and trains its contiguous slice. Rank 0 writes the
run's files and the generation (from the gathered weights under FSDP2,
tensor, expert or pipeline parallelism). ``parallel.tensor: N`` shards
the parameters' output features over N ranks of a ('data', 'model') mesh
(parallel/tensor.py; ``wte`` and ``wpe`` on ``n_embd``, an MoE block's
expert hidden and output channels), data parallelism over the rest.
``parallel.expert: N`` shards the stacked expert weights over the N
processes of the run (parallel/expert.py), each training its slice of
the batch; ``parallel.pipeline: S`` splits the blocks into S stages over
the S processes of the run, ``parallel.n_micro`` (default 4)
microbatches a step through the GPipe schedule (parallel/pipeline.py),
on the LM loss only and without dropout (a NOTE says so for an MoE or
dropout model), as JAX's. Either axis spans the world (ValueError naming
both numbers otherwise). An MoE model routes over the global batch under
DDP, FSDP2, tensor and expert parallelism (nn/moe.py), JAX's capacity,
Switch loss and slot order. As in JAX, tensor parallelism composes with
data parallelism only, FSDP with no other axis, experts not with the
pipeline, and LoRA with none of them (ValueError).
``training.checkpoint_format: sharded`` writes ``ckpt_step=NNNNNN.shards/``
directories in the JAX package's format (train/sharded_checkpoint.py; a
pipeline's as JAX's (rest, stage_stack) leaves).

Not ported (NotImplementedError from validate_config): ``parallel.*``
context and context_zigzag (M13).
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import (parallel_group, parallel_plan, parallelize,
                                 run_cli, start_run_directory)
from tempo_tpu_torch.data.tokens import TokenLoader, make_token_stream
from tempo_tpu_torch.nn.transformer import (Transformer, TransformerConfig,
                                           generate, make_gpt_optimizer,
                                           num_params)
from tempo_tpu_torch.nn.lora import LoRA, init_lora, num_lora_params
from tempo_tpu_torch.nn.moe import route_globally
from tempo_tpu_torch.parallel import expert as pexpert
from tempo_tpu_torch.parallel import fsdp as pfsdp
from tempo_tpu_torch.parallel import pipeline as ppipeline
from tempo_tpu_torch.parallel import tensor as ptensor
from tempo_tpu_torch.parallel.mesh import (RankSlice, batch_sharding,
                                           is_primary)
from tempo_tpu_torch.parallel.pipeline import make_pp_loss_fn
from tempo_tpu_torch.train.checkpoint import (check_format,
                                              latest_checkpoint, load_params,
                                              resolve_resume_from)
from tempo_tpu_torch.train.schedules import lr_schedule
from tempo_tpu_torch.train.state import create_train_state
from tempo_tpu_torch.train.step import lm_loss_fn, pipeline_lm_loss_fn
from tempo_tpu_torch.train.trainer import Trainer
from tempo_tpu_torch.utils.config import (load_config, require_keys,
                                          save_json_yaml, save_yaml)

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
    parallel = dict(config.get("parallel") or {})
    stages = int(parallel.get("pipeline", 1))
    n_layer = int(config["model"].get("n_layer", 12))
    if stages > 1 and n_layer % stages != 0:
        raise ValueError(f"FATAL: n_layer={n_layer} must divide by "
                         f"parallel.pipeline={stages}")
    n_expert = int(parallel.get("expert", 1))
    n_experts = int(config["model"].get("n_experts", 0))
    if n_expert > 1 and stages <= 1 and (n_experts == 0
                                         or n_experts % n_expert != 0):
        raise ValueError(f"FATAL: model.n_experts={n_experts} must be a "
                         f"positive multiple of parallel.expert={n_expert}")
    plan = parallel_plan(config, "train_gpt")
    if plan.n_pipe > 1:
        batch = int(data.get("batch_size", 16))
        if batch % plan.n_micro:
            raise ValueError(f"FATAL: data.batch_size={batch} must divide "
                             f"by parallel.n_micro={plan.n_micro}")
    ft = dict(config.get("finetune", {}))
    if int(ft.get("lora_rank", 0)) > 0:
        if "base_checkpoint" not in ft and "base_run" not in ft:
            raise ValueError("FATAL: finetune.lora_rank needs "
                             "finetune.base_checkpoint (ckpt path) or "
                             "finetune.base_run (train_gpt output dir)")
        if plan.single:
            raise ValueError("FATAL: finetune.lora_rank is the dense "
                             "data-parallel path — adapters are tiny, "
                             "model-sharding them buys nothing")
    check_format(config["training"].get("checkpoint_format", "msgpack"))


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None):
    """Train as the config dict says, on ``device`` (None: CUDA, raising
    without it); returns the Trainer and its throughput stats.
    ``config_path`` is copied into the run as config.yaml; without it the
    dict is written there, and training_info.yaml too, as JSON."""
    validate_config(config)
    plan = parallel_plan(config, "train_gpt")
    with parallel_group(config, device, plan) as mesh:
        return _run(config, overwrite, debug, device, config_path, mesh,
                    plan)


def _run(config, overwrite, debug, device, config_path, mesh, plan):
    output_dir = start_run_directory(config, overwrite, config_path,
                                     subdirs=("checkpoints",))

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
    shard = batch_sharding(mesh)  # the stages of a pipeline read it whole
    shard.local_size(batch_size)  # the global batch divides over the ranks
    train_loader = RankSlice(TokenLoader(stream, batch_size,
                                         tconfig.block_size, seed=seed + 1),
                             shard)
    val_loader = RankSlice(TokenLoader(stream, batch_size,
                                       tconfig.block_size, seed=seed + 2),
                           shard)

    opt_cfg = dict(config.get("optimizer", {}))
    train_cfg = config["training"]
    tx = make_gpt_optimizer(
        trained, weight_decay=float(opt_cfg.get("weight_decay", 0.1)),
        learning_rate=lr_schedule(opt_cfg, int(train_cfg.get("n_steps",
                                                             10_000))),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.95))),
        moments_dtype=opt_cfg.get("moments_dtype"))
    state = parallelize(create_train_state(trained, tx, seed + 3), tx, mesh,
                        plan)
    aux_weight = float(train_cfg.get("moe_aux_weight", 0.01))
    loss_fn = lm_loss_fn(model, aux_weight)
    if plan.n_pipe > 1:
        if tconfig.n_experts > 0:
            print("NOTE: pipeline path trains with the LM loss only "
                  "(the MoE aux loss is not collected through the "
                  "pipeline)")
        if tconfig.dropout > 0.0:
            print("NOTE: pipeline path trains deterministically "
                  "(dropout is not threaded through the pipeline)")
        loss_fn = pipeline_lm_loss_fn(make_pp_loss_fn(
            tconfig, plan.n_pipe, plan.n_micro, mesh))
    trainer = Trainer(
        loss_fn=loss_fn, tx=tx, state=state,
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
    if plan.single:
        # every rank gathers; rank 0 generates from a plain copy
        gathered = (pfsdp.full_state_dict(model) if plan.fsdp
                    else ppipeline.full_state_dict(model) if plan.n_pipe > 1
                    else pexpert.full_state_dict(model) if plan.n_expert > 1
                    else ptensor.full_state_dict(model))
        if is_primary():
            model = trained = Transformer(tconfig, device=device)
            model.load_state_dict(gathered)
    if not is_primary():
        return trainer, stats
    write = save_yaml if config_path is not None else save_json_yaml
    write({
        "seed": seed,
        "vocab_size": vocab,
        "n_params_non_embedding": int(n_params),
        "n_experts": tconfig.n_experts,
        "pipeline_stages": plan.n_pipe,
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
        route_globally(model, None)  # rank 0 generates alone
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
