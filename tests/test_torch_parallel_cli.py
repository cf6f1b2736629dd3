"""The port's four trainers over 2 gloo ranks on the CPU
(tests/torch_parallel_workers.py ``cli_run``): each rank calls the CLI's
``run`` with a ``distributed:`` section (a file store, ``process_id:
auto`` from RANK; gloo, the CPU's backend) and two processes on the host
(LOCAL_WORLD_SIZE 2). train_vae trains under DDP with the device buffer
(``partition`` replicate and process) and the host loader, train_vae_l2
and train_diffusion under DDP, train_gpt with ``parallel.fsdp``. Rank 0
alone writes the run's files (rank 1 records every write it makes under
the output directory: none), training_info.yaml says ``n_devices: 2``,
both ranks end with the same parameters, and the last checkpoint has the
one-device keys and loads on one device through ``load_params`` bit for
bit."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tempo_tpu_torch.data.synthetic import make_tile_shards
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.train.checkpoint import (checkpoint_step,
                                              list_checkpoints, load_params)

torch.set_num_threads(1)

PRODUCTS = ["NO2", "O3TOT", "HCHO", "CLDO4"]
MODEL = {"shape": [8, 16, 16], "embed_dim": 4, "chs": [16, 12, 8],
         "z_channels": 4, "n_attention_heads": 2, "norm_groups": 4,
         "compute_dtype": "float32"}
ENV = {"LOCAL_WORLD_SIZE": "2"}


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles")
    for split, seed in (("train", 1), ("val", 2)):
        make_tile_shards(root / split, n_files=4, tiles_per_file=8, tile=16,
                         n_spectral=8, l2_products=PRODUCTS, seed=seed)
    return root


def _distributed(tmp_path: Path) -> dict:
    return {"enabled": True, "coordinator_address":
            f"file://{tmp_path}/store", "num_processes": 2,
            "process_id": "auto"}


def _training(**extra) -> dict:
    return {"n_steps": 4, "save_every": 2, "val_every": 2, "log_every": 1,
            "plot_every": 2, **extra}


def _run(tmp_path, module, cfg, n_devices=True):
    """The CLI on 2 ranks; ``n_devices``: its training_info has the key
    (train_gpt's, as JAX's, has none)."""
    results = workers.launch(workers.cli_run, 2, tmp_path / "work", module,
                             cfg, ENV, join=False)
    assert results[1]["written"] == [], results[1]["written"]
    assert results[0]["step"] == results[1]["step"] == cfg["training"][
        "n_steps"]
    out = Path(cfg["output_dir"])
    info = json.loads((out / "training_info.yaml").read_text())
    assert info.get("n_devices") == (2 if n_devices else None)
    steps = [checkpoint_step(p) for p in list_checkpoints(out / "checkpoints")]
    assert steps == [2, 4]
    return results, out


def _same_replicas(results) -> dict:
    a, b = (r["params"] for r in results)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
    return a


def _loads_on_one_device(out: Path, model, want=None) -> None:
    raw = torch.load(out / "checkpoints" / "ckpt_step=000004.pt",
                     weights_only=True)
    assert list(raw["model"]) == list(model.state_dict())
    load_params(out / "checkpoints" / "ckpt_step=000004.pt", model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, raw["model"][k]), k
        if want is not None:
            assert torch.equal(v, want[k]), k


@pytest.mark.parametrize("loader, partition", [
    ("device", "replicate"), ("device", "process"), ("host", "replicate")],
    ids=["device_replicate", "device_process", "host"])
def test_train_vae_under_two_ranks(tmp_path, tiles, loader, partition):
    cfg = {"output_dir": str(tmp_path / "run"), "seed": 3,
           "distributed": _distributed(tmp_path),
           "data": {"train_dir": str(tiles / "train"),
                    "val_dir": str(tiles / "val"), "batch_size": 4,
                    "loader": loader, "partition": partition,
                    "buffer_slots": 2, "swap_every": 2,
                    "min_buffer_size": 8, "val_min_buffer_size": 8},
           "model": dict(MODEL), "optimizer": {"lr": 1e-3},
           "training": _training(metrics_jsonl=True)}
    results, out = _run(tmp_path, "train_vae", cfg)
    want = _same_replicas(results)
    _loads_on_one_device(out, build_vae(MODEL, device="cpu")[0], want)
    lines = (out / "logs" / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 + 2  # every train and val record, once
    hist = json.loads((out / "metrics.json").read_text())
    assert [m["step"] for m in hist["val"]] == [2, 4]


def test_train_vae_l2_under_two_ranks(tmp_path, tiles):
    from tempo_tpu_torch.models.vae_l2 import build_vae_l2

    cfg = {"output_dir": str(tmp_path / "run"), "seed": 3,
           "distributed": _distributed(tmp_path),
           "data": {"data_dir": str(tiles), "batch_size": 4,
                    "loader": "device", "buffer_slots": 2, "swap_every": 2,
                    "val_min_buffer_size": 8},
           "model": dict(MODEL),
           "l2": {"components": PRODUCTS, "mlp_hidden": [16, 16]},
           "optimizer": {"lr": 1e-3}, "training": _training()}
    results, out = _run(tmp_path, "train_vae_l2", cfg)
    want = _same_replicas(results)
    _loads_on_one_device(out, build_vae_l2(MODEL, (16, 16), device="cpu")[0],
                         want)
    hist = json.loads((out / "metrics.json").read_text())
    assert all(np.isfinite(m["NO2_loss"]) for m in hist["train"])


def test_train_diffusion_under_two_ranks(tmp_path, tiles):
    from tempo_tpu_torch.cli.train_diffusion import _build_generative

    cfg = {"output_dir": str(tmp_path / "run"), "seed": 1,
           "distributed": _distributed(tmp_path),
           "data": {"train_dir": str(tiles / "train"),
                    "val_dir": str(tiles / "val"), "batch_size": 4,
                    "min_buffer_size": 8, "val_min_buffer_size": 8},
           "score_model": {"chs": [8, 12], "norm_groups": 4,
                           "n_attention_heads": 2, "t_embedding_dim": 8},
           "optimizer": {"lr": 1e-3}, "training": _training(),
           "sampling": {"n_samples": 2, "n_steps": 2}}
    results, out = _run(tmp_path, "train_diffusion", cfg)
    want = _same_replicas(results)
    model, _ = _build_generative(cfg, (16, 16, 8), torch.device("cpu"))
    _loads_on_one_device(out, model, want)
    assert np.load(out / "figures" / "samples_final.npy").shape == (
        2, 16, 16, 8)


def test_train_gpt_fsdp_under_two_ranks(tmp_path):
    model_cfg = {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 32,
                 "in_size": 17}
    cfg = {"output_dir": str(tmp_path / "run"), "seed": 7,
           "distributed": _distributed(tmp_path),
           "parallel": {"fsdp": True},
           "data": {"synthetic": {"vocab_size": 17, "length": 4000},
                    "batch_size": 8},
           "model": dict(model_cfg), "optimizer": {"lr": 3e-3},
           "training": _training(), "generation": {"n_tokens": 4}}
    results, out = _run(tmp_path, "train_gpt", cfg, n_devices=False)
    assert results[0]["params"] is None  # sharded to the end
    _loads_on_one_device(out, pt.Transformer(
        pt.TransformerConfig(**model_cfg), device="cpu"))
    assert np.load(out / "generation_final.npy").shape == (1, 12)


def test_train_gpt_refuses_moe_over_two_ranks_without_fsdp(tmp_path):
    """Two ranks without parallel.fsdp train under DDP, where each rank's
    expert capacity and Switch loss would be over its own batch, not the
    global one: an MoE model raises on both ranks, before any file."""
    cfg = {"output_dir": str(tmp_path / "run"), "seed": 7,
           "distributed": _distributed(tmp_path),
           "data": {"synthetic": {"vocab_size": 17, "length": 4000},
                    "batch_size": 8},
           "model": {"n_layer": 1, "n_head": 2, "n_embd": 32,
                     "block_size": 32, "in_size": 17, "n_experts": 1},
           "training": _training()}
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] of 2 failed"
                       r"(.|\n)*NotImplementedError(.|\n)*expert-parallel"):
        workers.launch(workers.cli_run, 2, tmp_path / "work", "train_gpt",
                       cfg, ENV, join=False)
    assert not (tmp_path / "run").exists()
