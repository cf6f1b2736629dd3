"""The port's GPT training CLI (tempo_tpu_torch/cli/train_gpt.py) on the CPU,
on the config of tests/test_train_gpt.py's dense case: it learns the
synthetic affine stream and writes the same artifacts; the config checks
and the unported options raise; the async checkpoint format is accepted
and writes what the sync one does."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tempo_tpu_torch.cli import train_gpt
from tempo_tpu_torch.data.tokens import TokenLoader, make_token_stream
from tempo_tpu_torch.nn.transformer import (Transformer, TransformerConfig,
                                            make_gpt_optimizer)
from tempo_tpu_torch.train.checkpoint import list_checkpoints
from tempo_tpu_torch.train.state import create_train_state
from tempo_tpu_torch.train.step import lm_loss_fn
from tempo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BASE_MODEL = {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 32,
              "dropout": 0.0}


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _base_cfg(out: Path, **model_extra) -> dict:
    return {
        "output_dir": str(out),
        "seed": 7,
        "data": {"synthetic": {"vocab_size": 17, "length": 20000,
                               "noise": 0.05},
                 "batch_size": 16},
        "model": {**BASE_MODEL, **model_extra},
        "optimizer": {"lr": 3.0e-3, "weight_decay": 0.1},
        "training": {"n_steps": 60, "log_every": 5, "save_every": 30,
                     "val_every": 30, "plot_every": 1000},
        "generation": {"n_tokens": 8},
    }


def test_train_gpt_learns_synthetic_stream(tmp_path):
    """Train NLL drops well below the log(V) no-learning floor; the
    checkpoints, metrics, run info and greedy continuation exist."""
    out = tmp_path / "run"
    train_gpt.main(_write(tmp_path / "cfg.yaml", _base_cfg(out)),
                   device="cpu")
    metrics = json.loads((out / "metrics.json").read_text())
    losses = [m["loss"] for m in metrics["train"]]
    floor = np.log(17)
    assert losses[-1] < 0.75 * floor, (losses[0], losses[-1])
    assert losses[-1] < losses[0]
    assert [m["step"] for m in metrics["val"]] == [30, 60]
    for step in (30, 60):
        assert (out / "checkpoints" / f"ckpt_step={step:06d}.pt").exists()
    assert (out / "config.yaml").exists()
    gen = np.load(out / "generation_final.npy")
    assert gen.shape == (1, 16) and gen.dtype == np.int32
    info = yaml.safe_load((out / "training_info.yaml").read_text())
    assert info["vocab_size"] == 17 and info["pipeline_stages"] == 1
    assert info["n_params_non_embedding"] > 0 and info["samples_per_sec"] > 0
    # an existing output dir is refused without --overwrite
    with pytest.raises(SystemExit):
        train_gpt.main(str(out / "config.yaml"), device="cpu")


def test_train_gpt_resumes_and_plots(tmp_path):
    """resume_from: auto re-enters the run and continues from its latest
    checkpoint; plot_every writes the loss curve."""
    out = tmp_path / "run"
    cfg = _base_cfg(out)
    cfg["training"].update(n_steps=10, save_every=5, val_every=5,
                           plot_every=10, log_every=2)
    cfg["model"]["attn_impl"] = "flash"
    path = _write(tmp_path / "cfg.yaml", cfg)
    train_gpt.main(path, device="cpu")
    assert (out / "summary" / "loss.png").exists()
    cfg["training"].update(n_steps=14, resume_from="auto")
    train_gpt.main(_write(tmp_path / "cfg2.yaml", cfg), device="cpu")
    steps = [m["step"] for m in json.loads(
        (out / "metrics.json").read_text())["train"]]
    assert steps == [2, 4, 6, 8, 10, 12, 14]
    assert (out / "checkpoints" / "ckpt_step=000014.pt").exists()


@pytest.mark.parametrize("mutate, error, match", [
    (lambda c: c.pop("model"), ValueError, "model"),
    (lambda c: c["data"].pop("synthetic"), ValueError, "tokens"),
    (lambda c: c["data"].update(tokens="/nonexistent/stream.npy"),
     ValueError, "doesn't exist"),
    (lambda c: c.update(parallel={"bogus": 2}), ValueError, "bogus"),
    (lambda c: c.update(parallel={"pipeline": 2}), NotImplementedError,
     "pipeline"),
    (lambda c: c.update(parallel={"context": 2}), NotImplementedError,
     "context"),
    (lambda c: c.update(parallel={"fsdp": True}) or c["model"].update(
        n_experts=2), NotImplementedError, "expert-parallel"),
    (lambda c: c.update(parallel={"fsdp": True}) or c["model"].update(
        n_experts=1), NotImplementedError, "expert-parallel"),
    (lambda c: c.update(parallel={"fsdp": True}, finetune={
        "lora_rank": 2, "base_checkpoint": "ckpt.pt"}), ValueError,
     "lora_rank"),
    (lambda c: c.update(finetune={"lora_rank": 8}), ValueError,
     "base_checkpoint"),
    (lambda c: c["training"].update(checkpoint_format="sharded"),
     NotImplementedError, "sharded"),
    (lambda c: c["training"].update(checkpoint_format="zip"), ValueError,
     "checkpoint_format"),
], ids=["no_model", "no_data", "missing_stream", "unknown_parallel",
        "pipeline", "context", "moe_fsdp", "moe1_fsdp", "lora_fsdp",
        "lora_without_base",
        "sharded", "unknown_format"])
def test_validate_config_refuses(tmp_path, mutate, error, match):
    cfg = _base_cfg(tmp_path / "run")
    mutate(cfg)
    with pytest.raises(error, match=match):
        train_gpt.validate_config(cfg)
    # serial parallel settings pass
    ok = _base_cfg(tmp_path / "run")
    ok["parallel"] = {"pipeline": 1, "tensor": 1, "fsdp": False,
                      "n_micro": 4}
    ok["training"]["checkpoint_format"] = "msgpack"
    train_gpt.validate_config(ok)


def test_unported_run_options_raise(tmp_path):
    """optimizer.moments_dtype and model.dropout, which the port now runs,
    run (tests/test_torch_lm_options.py holds what they compute); an
    unknown moments type raises."""
    cfg = _base_cfg(tmp_path / "run_mu")
    cfg["optimizer"]["moments_dtype"] = "bfloat16"
    cfg["training"].update(n_steps=4, save_every=4, val_every=4)
    train_gpt.main(_write(tmp_path / "mu.yaml", cfg), device="cpu")
    ckpt = torch.load(tmp_path / "run_mu" / "checkpoints"
                      / "ckpt_step=000004.pt", weights_only=True)
    assert {s["exp_avg"].dtype for s in ckpt["optimizer"]["state"].values()
            } == {torch.bfloat16}
    cfg = _base_cfg(tmp_path / "run_drop")
    cfg["model"]["dropout"] = 0.1
    cfg["training"].update(n_steps=4, save_every=4, val_every=4)
    train_gpt.main(_write(tmp_path / "drop.yaml", cfg), device="cpu")
    assert (tmp_path / "run_drop" / "checkpoints"
            / "ckpt_step=000004.pt").exists()
    cfg = _base_cfg(tmp_path / "run_bad")
    cfg["optimizer"]["moments_dtype"] = "float16"
    with pytest.raises(ValueError, match="moments_dtype"):
        train_gpt.main(_write(tmp_path / "bad.yaml", cfg), device="cpu")


@pytest.mark.parametrize("option", ["moe", "lora"])
def test_validate_config_accepts_lifted_options(tmp_path, option):
    """MoE and LoRA, which validate_config refused until the port ran
    them, validate and run: a 4-step MoE run logs its aux loss; a LoRA
    fine-tune over that run's checkpoint trains only the adapters and
    writes merged_final.pt (tests/test_torch_lora.py holds the math)."""
    base = _base_cfg(tmp_path / "base", n_experts=2)
    base["training"].update(n_steps=4, save_every=4, val_every=4,
                            log_every=2)
    base["generation"]["n_tokens"] = 4
    train_gpt.validate_config(base)
    train_gpt.run(base, device="cpu")
    metrics = json.loads((tmp_path / "base" / "metrics.json").read_text())
    assert "moe_aux" in metrics["train"][-1]
    if option == "lora":
        cfg = _base_cfg(tmp_path / "ft", n_experts=2)
        cfg["training"].update(n_steps=4, save_every=4, val_every=4)
        cfg["finetune"] = {"lora_rank": 2, "lora_scale": 0.5,
                           "base_run": str(tmp_path / "base")}
        train_gpt.validate_config(cfg)
        train_gpt.run(cfg, device="cpu")
        ckpts = tmp_path / "ft" / "checkpoints"
        adapters = torch.load(ckpts / "ckpt_step=000004.pt",
                              weights_only=True)["model"]
        assert adapters and all(k.startswith("adapters.") for k in adapters)
        merged = torch.load(ckpts / "merged_final.pt", weights_only=True)
        assert merged["step"] == 4
        assert "transformer.h.0.moe.w1" in merged["model"]


def test_trainer_saves_at_save_steps(tmp_path):
    """An explicit save_steps schedule replaces save_every; the last step
    always saves; metrics.json holds the EMA history."""
    cfg = TransformerConfig(in_size=17, block_size=16, n_layer=1, n_head=2,
                            n_embd=32)
    model = Transformer(cfg, device="cpu")
    tx = make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95))
    trainer = Trainer(lm_loss_fn(model), tx, create_train_state(model, tx),
                      tmp_path, save_every=1, log_every=2, save_steps=[2],
                      device="cpu", verbose=False)
    loader = iter(TokenLoader(make_token_stream(17, 500), 2, 16))
    stats = trainer.train(loader, n_steps=5)
    assert stats["steps"] == 5 and stats["samples"] == 10
    assert [p.name for p in list_checkpoints(tmp_path / "checkpoints")] == [
        "ckpt_step=000002.pt", "ckpt_step=000005.pt"]
    hist = json.loads((tmp_path / "metrics.json").read_text())
    assert [m["step"] for m in hist["train"]] == [2, 4]
    assert set(hist["train"][0]) == {"step", "loss", "nll", "grad_norm"}


def _same_checkpoints(a: Path, b: Path) -> None:
    """The same checkpoint files, and in each the same tensors bitwise."""
    names = [p.name for p in list_checkpoints(a / "checkpoints")]
    assert names == [p.name for p in list_checkpoints(b / "checkpoints")]
    for name in names:
        x = torch.load(a / "checkpoints" / name, weights_only=True)
        y = torch.load(b / "checkpoints" / name, weights_only=True)
        assert x["step"] == y["step"]
        assert x["model"].keys() == y["model"].keys()
        assert all(torch.equal(x["model"][k], y["model"][k])
                   for k in x["model"])
        for i, st in x["optimizer"]["state"].items():
            assert all(torch.equal(v, y["optimizer"]["state"][i][k])
                       for k, v in st.items())


def test_fsdp_runs_in_one_process(tmp_path):
    """parallel.fsdp in one process: FSDP2 over a group of one (JAX's
    one-device mesh), the checkpoints with the one-device keys and the
    same numbers as the unsharded run, the generation from the gathered
    weights, and no group left behind (2 ranks:
    tests/test_torch_parallel_cli.py)."""
    from tempo_tpu_torch.parallel.mesh import is_active

    cfgs = {}
    for name, fsdp in (("plain", False), ("fsdp", True)):
        cfgs[name] = _base_cfg(tmp_path / name)
        cfgs[name]["parallel"] = {"fsdp": fsdp}
        cfgs[name]["training"].update(n_steps=4, save_every=4, val_every=4)
        cfgs[name]["generation"]["n_tokens"] = 4
        train_gpt.validate_config(cfgs[name])
        train_gpt.run(cfgs[name], device="cpu")
    assert not is_active()
    a, b = (torch.load(tmp_path / n / "checkpoints" / "ckpt_step=000004.pt",
                       weights_only=True) for n in ("plain", "fsdp"))
    assert list(a["model"]) == list(b["model"])
    for k, v in a["model"].items():
        torch.testing.assert_close(b["model"][k], v, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(
        np.load(tmp_path / "fsdp" / "generation_final.npy").shape, (1, 12))


@pytest.mark.parametrize("fmt", ["async"])
def test_validate_config_accepts(tmp_path, fmt):
    """checkpoint_format: async validates, and ``run`` from a dict writes
    the checkpoints the sync format writes, tensor for tensor."""
    cfgs = {}
    for name, f in (("sync", "msgpack"), ("async", fmt)):
        cfgs[name] = _base_cfg(tmp_path / name)
        cfgs[name]["training"].update(n_steps=6, save_every=3, val_every=3,
                                      checkpoint_format=f)
        cfgs[name]["generation"]["n_tokens"] = 2
    train_gpt.validate_config(cfgs["async"])
    train_gpt.main(_write(tmp_path / "sync.yaml", cfgs["sync"]),
                   device="cpu")
    trainer, stats = train_gpt.run(cfgs["async"], device="cpu")
    assert trainer._async_ckpt is not None and stats["steps"] == 6
    _same_checkpoints(tmp_path / "async", tmp_path / "sync")
    assert json.loads((tmp_path / "async" / "config.yaml").read_text())[
        "training"]["checkpoint_format"] == "async"
