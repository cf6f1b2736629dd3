"""The port's L2-supervised training CLI (tempo_tpu_torch/cli/
train_vae_l2.py) on the CPU, mirroring tests/test_e2e.py
test_train_l2_supervised on tile shards with L2 fields from
make_tile_shards: per-product losses in metrics.json, summary/
l2_losses.png and figures written, with the host loader and with
``data.loader: device`` (the DeviceTileBuffer on the CPU); ``run`` from a
dict; the warm start from a train_vae checkpoint and from a JAX .msgpack
one; metrics_jsonl and async checkpoints; --debug, auto resume and
grad_accum; the figures drawn without matplotlib; train_vae with the
device loader and the NO2 probe."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tempo_tpu.interop.torch_ckpt import params_from_torch_state_dict
from tempo_tpu.train import checkpoint as jckpt
from tempo_tpu.train import state as jstate
from tempo_tpu_torch.cli import train_vae, train_vae_l2
from tempo_tpu_torch.data.synthetic import make_tile_shards
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.train.checkpoint import checkpoint_step, list_checkpoints

torch.set_num_threads(1)

PRODUCTS = ["NO2", "O3TOT", "HCHO", "CLDO4"]
MODEL_CFG = {"shape": [8, 16, 16], "embed_dim": 4, "chs": [16, 12, 8],
             "mid_attn": True, "num_res_blocks": 1, "z_channels": 4,
             "double_z": True, "n_attention_heads": 2, "norm_groups": 4,
             "kl_weight": 1e-6, "nll_loss_type": "l1",
             "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def tiles_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles")
    make_tile_shards(root / "train", n_files=3, tiles_per_file=8, tile=16,
                     n_spectral=8, l2_products=PRODUCTS, seed=1)
    make_tile_shards(root / "val", n_files=1, tiles_per_file=8, tile=16,
                     n_spectral=8, l2_products=PRODUCTS, seed=2)
    return root


def _cfg(out: Path, tiles: Path, loader: str = "host", **training) -> dict:
    return {
        "output_dir": str(out),
        "seed": 42,
        "data": {"data_dir": str(tiles), "batch_size": 8,
                 "min_buffer_size": 16, "val_min_buffer_size": 8,
                 "loader": loader, "buffer_slots": 2, "swap_every": 4,
                 "buffer_dtype": "float16"},
        "model": dict(MODEL_CFG),
        "l2": {"components": PRODUCTS, "mlp_hidden": [16, 16],
               "weights": {"NO2": 0.2}},
        "optimizer": {"lr": 1e-3},
        "training": {"n_steps": 20, "save_every": 10, "val_every": 10,
                     "log_every": 5, "plot_every": 10, **training},
    }


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _history(out: Path) -> dict:
    return json.loads((out / "metrics.json").read_text())


def _steps(out: Path) -> list:
    return [checkpoint_step(p) for p in list_checkpoints(out / "checkpoints")]


@pytest.mark.parametrize("loader", ["host", "device"])
def test_train_l2_supervised(tmp_path, tiles_dir, loader):
    out = tmp_path / "run_l2"
    train_vae_l2.main(_write(tmp_path / "cfg.yaml",
                             _cfg(out, tiles_dir, loader)), device="cpu")
    hist = _history(out)
    last = hist["train"][-1]
    for p in PRODUCTS:
        assert f"{p}_loss" in last and np.isfinite(last[f"{p}_loss"])
        assert f"val_{p}_loss" in hist["val"][-1]
    assert [m["step"] for m in hist["train"]] == [5, 10, 15, 20]
    assert (out / "summary" / "l2_losses.png").exists()
    for step in (10, 20):
        assert (out / "figures" / f"reconstructions_step_{step:06d}.png"
                ).exists()
    assert _steps(out) == [10, 20]
    info = yaml.safe_load((out / "training_info.yaml").read_text())
    assert info["l2_products"] == PRODUCTS
    assert info["l2_weights"] == {"NO2": 0.2, "O3TOT": 0.1, "HCHO": 0.1,
                                  "CLDO4": 0.1}
    assert info["loader"] == loader and info["device"] == "cpu"
    assert info["samples_per_sec"] > 0 and info["n_params"] > 0
    assert yaml.safe_load((out / "config.yaml").read_text())["l2"][
        "mlp_hidden"] == [16, 16]
    with pytest.raises(SystemExit):  # an existing output dir is refused
        train_vae_l2.main(str(out / "config.yaml"), device="cpu")


def test_run_from_a_dict_warm_starts_from_train_vae(tmp_path, tiles_dir):
    """A train_vae checkpoint warm-starts vae.*; the head and the optimizer
    start fresh. run() writes the dict as config.yaml (JSON)."""
    base = tmp_path / "base"
    train_vae.main(_write(tmp_path / "base.yaml", {
        "output_dir": str(base), "seed": 3,
        "data": {"train_dir": str(tiles_dir / "train"), "batch_size": 4,
                 "min_buffer_size": 8},
        "model": dict(MODEL_CFG), "optimizer": {"lr": 1e-3},
        "training": {"n_steps": 4, "save_every": 4, "log_every": 2,
                     "val_every": 100, "plot_every": 100}}), device="cpu")
    ckpt = base / "checkpoints" / "ckpt_step=000004.pt"
    cfg = _cfg(tmp_path / "warm", tiles_dir, "device", n_steps=2,
               save_every=2, val_every=100, plot_every=100, log_every=1)
    cfg["model"]["init_from_vae_checkpoint"] = str(ckpt)
    seen = {}
    real = train_vae_l2.warm_start_vae

    def spy(model, path):
        real(model, path)
        seen.update({k: v.clone() for k, v in model.vae.state_dict().items()})

    train_vae_l2.warm_start_vae = spy
    try:
        trainer, stats = train_vae_l2.run(cfg, device="cpu")
    finally:
        train_vae_l2.warm_start_vae = real
    want = torch.load(ckpt, weights_only=True)["model"]
    assert set(seen) == set(want)
    assert all(torch.equal(seen[k], want[k]) for k in want)
    assert trainer.state.step == 2 and stats["steps"] == 2
    written = json.loads((tmp_path / "warm" / "config.yaml").read_text())
    assert written["model"]["init_from_vae_checkpoint"] == str(ckpt)


def test_debug_auto_resume_and_grad_accum(tmp_path, tiles_dir, monkeypatch):
    seen = []
    real = train_vae_l2.make_train_loader

    def loader(data_cfg, *args, **kwargs):
        seen.append(data_cfg["min_buffer_size"])
        return real(data_cfg, *args, **kwargs)

    monkeypatch.setattr(train_vae_l2, "make_train_loader", loader)
    out = tmp_path / "run"
    cfg = _cfg(out, tiles_dir, n_steps=4, save_every=2, log_every=2,
               val_every=100, plot_every=100, grad_accum=2,
               resume_from="auto")
    train_vae_l2.run(cfg, debug=True, device="cpu")
    assert seen == [10] and _steps(out) == [4]  # save_every became 50
    cfg = _cfg(out, tiles_dir, n_steps=6, save_every=2, log_every=2,
               val_every=100, plot_every=100, resume_from="auto")
    train_vae_l2.run(cfg, device="cpu")
    assert _steps(out) == [4, 6]
    assert [m["step"] for m in _history(out)["train"]] == [2, 4, 6]


def test_figures_without_matplotlib(tmp_path, tiles_dir, monkeypatch):
    """Where matplotlib is absent (the GPU machine), every summary plot and
    figure is still written, as a PNG drawn by train/png.py."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "run"
    train_vae_l2.run(_cfg(out, tiles_dir, "device", n_steps=10,
                          save_every=10, val_every=10, plot_every=10),
                     device="cpu")
    monkeypatch.delitem(sys.modules, "matplotlib")
    import matplotlib.pyplot as plt

    for name in ("summary/l2_losses.png", "summary/loss.png",
                 "summary/kl.png", "figures/reconstructions_step_000010.png"):
        img = plt.imread(out / name)
        assert img.ndim == 3 and img.shape[2] == 3, name
        assert img.min() < 1.0  # something was drawn


@pytest.mark.parametrize("mutate, error, match", [
    (lambda c: c["data"].pop("data_dir"), ValueError, "data_dir"),
    (lambda c: c["data"].update(data_dir="/nonexistent/tiles"), ValueError,
     "doesn't exist"),
    (lambda c: c.update(parallel={"tensor": 2}), NotImplementedError,
     "tensor"),
    (lambda c: c["data"].update(partition="shard"), ValueError,
     "partition"),
    (lambda c: c["training"].update(checkpoint_format="sharded"),
     NotImplementedError, "sharded"),
    (lambda c: c["data"].update(loader="disk"), ValueError, "loader"),
], ids=["no_data_dir", "missing_data_dir", "tensor", "unknown_partition",
        "sharded", "unknown_loader"])
def test_validate_config_refuses(tmp_path, tiles_dir, mutate, error, match):
    cfg = _cfg(tmp_path / "run", tiles_dir, "device")
    mutate(cfg)
    with pytest.raises(error, match=match):
        train_vae_l2.validate_config(cfg)
    train_vae_l2.validate_config(_cfg(tmp_path / "run", tiles_dir, "device"))


def _jax_vae_checkpoint(tmp_path: Path):
    """A JAX package checkpoint (.msgpack) of a seeded MODEL_CFG VAE, and
    that VAE's state_dict."""
    base, _ = build_vae(MODEL_CFG, device="cpu", seed=11)
    params = params_from_torch_state_dict(base.state_dict(), n_levels=3)
    tx = jstate.make_optimizer()
    path = jckpt.save_checkpoint(tmp_path / "jax_run" / "checkpoints",
                                 jstate.create_train_state(
                                     params, tx, jax.random.PRNGKey(0)))
    return path, base.state_dict()


def _honours_msgpack_warm_start(tmp_path, cfg, monkeypatch):
    path, want = _jax_vae_checkpoint(tmp_path)
    cfg["model"]["init_from_vae_checkpoint"] = str(path)
    seen = {}
    real = train_vae_l2.warm_start_vae

    def spy(model, p):
        real(model, p)
        seen.update({k: v.clone() for k, v in model.vae.state_dict().items()})

    monkeypatch.setattr(train_vae_l2, "warm_start_vae", spy)
    yield
    assert seen.keys() == want.keys()
    assert all(torch.equal(seen[k], want[k]) for k in want)


def _honours_metrics_jsonl(tmp_path, cfg, monkeypatch):
    cfg["training"]["metrics_jsonl"] = True
    yield
    out = Path(cfg["output_dir"])
    lines = [json.loads(line) for line in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    for kind in ("train", "val"):
        assert [{k: v for k, v in r.items() if k != "kind"} for r in lines
                if r["kind"] == kind] == _history(out)[kind]
    assert [r["step"] for r in lines if r["kind"] == "val"] == [2]
    keys = list(lines[0])
    assert keys[:2] == ["step", "kind"] and keys[2:] == sorted(keys[2:])
    assert "NO2_loss" in keys


def _honours_async(tmp_path, cfg, monkeypatch):
    cfg["training"]["checkpoint_format"] = "async"
    yield
    out = Path(cfg["output_dir"])
    assert _steps(out) == [1, 2]
    raw = torch.load(out / "checkpoints" / "ckpt_step=000002.pt",
                     weights_only=True)
    assert raw["step"] == 2 and any(k.startswith("l2_head.")
                                    for k in raw["model"])


def _profile_steps_not_read(tmp_path, cfg, monkeypatch):
    cfg["training"]["profile_steps"] = [0, 1]  # the JAX L2 CLI reads none
    yield
    assert not (Path(cfg["output_dir"]) / "profile").exists()


def _honours_process_partition(tmp_path, cfg, monkeypatch):
    cfg["data"]["partition"] = "process"  # one process: the whole buffer
    yield
    out = Path(cfg["output_dir"])
    assert _steps(out) == [1, 2]
    info = json.loads((out / "training_info.yaml").read_text())
    assert (info["n_devices"], info["loader"]) == (1, "device")


@pytest.mark.parametrize("option", [
    _honours_msgpack_warm_start, _honours_metrics_jsonl, _honours_async,
    _profile_steps_not_read, _honours_process_partition],
    ids=["msgpack_warm_start", "metrics_jsonl", "async",
         "profile_steps_not_read", "process_partition"])
def test_validate_config_accepts(tmp_path, tiles_dir, monkeypatch, option):
    """What the L2 CLI now takes: the config validates, and a 2-step run
    honours it."""
    cfg = _cfg(tmp_path / "run", tiles_dir, "device", n_steps=2,
               save_every=1, val_every=2, log_every=1, plot_every=100)
    check = option(tmp_path, cfg, monkeypatch)
    next(check)
    train_vae_l2.validate_config(cfg)
    trainer, stats = train_vae_l2.run(cfg, device="cpu")
    assert stats["steps"] == 2
    next(check, None)


def test_train_vae_takes_the_device_loader_and_the_no2_probe(tmp_path,
                                                             tiles_dir):
    out = tmp_path / "run"
    model = dict(MODEL_CFG, no2_mlp_hidden=[8], no2_weight=0.1)
    train_vae.main(_write(tmp_path / "cfg.yaml", {
        "output_dir": str(out), "seed": 1,
        "data": {"train_dir": str(tiles_dir / "train"), "batch_size": 4,
                 "loader": "device", "buffer_slots": 2, "swap_every": 2,
                 "buffer_dtype": "float16"},
        "model": model, "optimizer": {"lr": 1e-3},
        "training": {"n_steps": 6, "save_every": 6, "log_every": 2,
                     "val_every": 100, "plot_every": 100}}), device="cpu")
    losses = [m["loss"] for m in _history(out)["train"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    sd = torch.load(out / "checkpoints" / "ckpt_step=000006.pt",
                    weights_only=True)["model"]
    assert "no2_probe.0.weight" in sd and "no2_probe.1.bias" in sd
