"""The port's VAE training CLI (tempo_tpu_torch/cli/train_vae.py) on the CPU,
mirroring the train_vae cases of tests/test_e2e.py on tile shards from
make_tile_shards: it learns and writes checkpoints, figures, summary
plots, metrics.json and training_info.yaml; --debug reduces as JAX's does;
resume_from (auto and explicit), save_schedule: sqrt and grad_accum work;
metrics_jsonl, profile_steps, the async checkpoint format, distributed,
parallel.fsdp and the process partition are accepted and honoured (in one
process here; over several: tests/test_torch_parallel*.py); the unported
options raise (the device loader and the NO2 probe run:
tests/test_torch_train_vae_l2.py)."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch
import yaml

from tempo_tpu_torch.cli import train_vae
from tempo_tpu_torch.data.synthetic import make_tile_shards
from tempo_tpu_torch.train.checkpoint import checkpoint_step, list_checkpoints

torch.set_num_threads(1)

MODEL_CFG = {"shape": [8, 16, 16], "embed_dim": 4, "chs": [16, 12, 8],
             "mid_attn": True, "num_res_blocks": 1, "z_channels": 4,
             "double_z": True, "n_attention_heads": 2, "norm_groups": 4,
             "kl_weight": 1e-6, "nll_loss_type": "l1",
             "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def tiles_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles")
    make_tile_shards(root / "train", n_files=3, tiles_per_file=8, tile=16,
                     n_spectral=8, seed=1)
    make_tile_shards(root / "val", n_files=1, tiles_per_file=8, tile=16,
                     n_spectral=8, seed=2)
    return root


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _cfg(out: Path, tiles: Path, **training) -> dict:
    return {
        "output_dir": str(out),
        "seed": 42,
        "data": {"train_dir": str(tiles / "train"),
                 "val_dir": str(tiles / "val"), "batch_size": 4,
                 "min_buffer_size": 8, "val_min_buffer_size": 8},
        "model": dict(MODEL_CFG),
        "optimizer": {"lr": 1e-3, "betas": [0.9, 0.95],
                      "weight_decay": 0.05},
        "training": {"n_steps": 30, "save_every": 15, "val_every": 10,
                     "log_every": 5, "plot_every": 15, **training},
    }


def _steps(out: Path) -> list:
    return [checkpoint_step(p) for p in list_checkpoints(out / "checkpoints")]


def _history(out: Path) -> dict:
    return json.loads((out / "metrics.json").read_text())


def test_train_vae_learns_and_writes_the_artifacts(tmp_path, tiles_dir):
    out = tmp_path / "run"
    train_vae.main(_write(tmp_path / "cfg.yaml", _cfg(out, tiles_dir)),
                   device="cpu")
    hist = _history(out)
    losses = [m["loss"] for m in hist["train"]]
    assert losses[-1] < losses[0]
    assert [m["step"] for m in hist["train"]] == [5, 10, 15, 20, 25, 30]
    assert [m["step"] for m in hist["val"]] == [10, 20, 30]
    assert set(hist["train"][0]) == {"step", "loss", "nll_loss", "kl_loss",
                                     "pixel_mse", "grad_norm"}
    assert _steps(out) == [15, 30]
    for step in (15, 30):
        assert (out / "figures" / f"reconstructions_step_{step:06d}.png"
                ).exists()
    for name in ("loss.png", "recons_err.png", "kl.png"):
        assert (out / "summary" / name).exists()
    assert (out / "logs").is_dir() and (out / "config.yaml").exists()
    info = yaml.safe_load((out / "training_info.yaml").read_text())
    assert info["samples_per_sec"] > 0 and info["n_params"] > 0
    assert info["compute_dtype"] == "float32" and info["device"] == "cpu"
    assert info["n_devices"] == 1 and info["seed"] == 42
    with pytest.raises(SystemExit):  # an existing output dir is refused
        train_vae.main(str(out / "config.yaml"), device="cpu")


def test_debug_reduces_as_jax(tmp_path, tiles_dir, monkeypatch):
    """--debug: at most 200 steps, a buffer of at most 10 tiles, saves every
    50, validates every 25, plots every 20."""
    seen = []
    real = train_vae.TileLoader

    def loader(**kwargs):
        seen.append(kwargs["min_buffer_size"])
        return real(**kwargs)

    monkeypatch.setattr(train_vae, "TileLoader", loader)
    out = tmp_path / "run"
    cfg = _cfg(out, tiles_dir, n_steps=12, save_every=4, val_every=4,
               plot_every=4)
    cfg["data"]["min_buffer_size"] = 16
    train_vae.main(_write(tmp_path / "cfg.yaml", cfg), debug=True,
                   device="cpu")
    assert seen == [10, 8]  # train buffer reduced; val keeps its own
    assert _steps(out) == [12]  # the last step only: save_every became 50
    assert _history(out)["val"] == []  # val_every became 25
    assert not (out / "summary" / "loss.png").exists()  # plot_every 20


def test_resume_auto_continues_the_history(tmp_path, tiles_dir):
    out = tmp_path / "run"
    cfg = _cfg(out, tiles_dir, n_steps=10, save_every=5, log_every=5,
               val_every=100, plot_every=1000, resume_from="auto")
    train_vae.main(_write(tmp_path / "a.yaml", cfg), device="cpu")
    assert _steps(out) == [5, 10]
    cfg["training"]["n_steps"] = 20
    train_vae.main(_write(tmp_path / "b.yaml", cfg), device="cpu")
    assert _steps(out) == [5, 10, 15, 20]
    assert [m["step"] for m in _history(out)["train"]] == [5, 10, 15, 20]
    # an explicit checkpoint starts a new run from it
    fresh = tmp_path / "fresh"
    cfg = _cfg(fresh, tiles_dir, n_steps=12, save_every=100, log_every=2,
               val_every=100, plot_every=1000,
               resume_from=str(out / "checkpoints" / "ckpt_step=000010.pt"))
    train_vae.main(_write(tmp_path / "c.yaml", cfg), device="cpu")
    assert _steps(fresh) == [12]
    assert [m["step"] for m in _history(fresh)["train"]] == [5, 10, 12]


def test_sqrt_schedule_and_grad_accum(tmp_path, tiles_dir):
    out = tmp_path / "run"
    cfg = _cfg(out, tiles_dir, n_steps=10, save_schedule="sqrt", n_saves=4,
               grad_accum=2, log_every=5, val_every=100, plot_every=1000)
    train_vae.main(_write(tmp_path / "cfg.yaml", cfg), device="cpu")
    assert _steps(out) == [5, 8, 10]  # sqrt(linspace(0, 1, 4)) * 10
    assert all(m["loss"] == m["loss"] for m in _history(out)["train"])


@pytest.mark.parametrize("mutate, error, match", [
    (lambda c: c.pop("model"), ValueError, "model"),
    (lambda c: c["data"].pop("train_dir"), ValueError, "train_dir"),
    (lambda c: c["data"].update(train_dir="/nonexistent/tiles"),
     ValueError, "doesn't exist"),
    (lambda c: c["data"].update(val_dir="/nonexistent/val"), ValueError,
     "doesn't exist"),
    (lambda c: c.update(parallel={"tensor": 2}), None, None),
    (lambda c: c.update(parallel={"tensor": 2, "fsdp": True}),
     ValueError, "tensor"),
    (lambda c: c["data"].update(loader="disk"), ValueError, "loader"),
    (lambda c: c["training"].update(checkpoint_format="sharded"), None,
     None),
    (lambda c: c["training"].update(checkpoint_format="zip"), ValueError,
     "checkpoint_format"),
], ids=["no_model", "no_train_dir", "missing_train_dir", "missing_val_dir",
        "tensor", "tensor_with_fsdp", "unknown_loader", "sharded",
        "unknown_format"])
def test_validate_config_refuses(tmp_path, tiles_dir, mutate, error, match):
    """The refusals; ``tensor`` and ``sharded`` (error None), which the
    port now runs, validate (tensor with FSDP raises ValueError, as
    JAX's CLI does)."""
    cfg = _cfg(tmp_path / "run", tiles_dir)
    mutate(cfg)
    if error is None:
        train_vae.validate_config(cfg)
    else:
        with pytest.raises(error, match=match):
            train_vae.validate_config(cfg)
    ok = _cfg(tmp_path / "run", tiles_dir)
    ok["parallel"] = {"tensor": 1, "fsdp": False}
    ok["distributed"] = {"enabled": False}
    ok["data"]["loader"] = "host"
    ok["training"].update(checkpoint_format="msgpack", metrics_jsonl=False)
    train_vae.validate_config(ok)


def _honours_async(out: Path) -> None:
    assert _steps(out) == [3, 6]
    raw = torch.load(out / "checkpoints" / "ckpt_step=000006.pt",
                     weights_only=True)
    assert raw["step"] == 6 and raw["model"] and raw["optimizer"]["state"]
    assert not list((out / "checkpoints").glob("*.tmp"))


def _honours_metrics_jsonl(out: Path) -> None:
    lines = [json.loads(line) for line in
             (out / "logs" / "metrics.jsonl").read_text().splitlines()]
    hist = _history(out)
    assert [{k: v for k, v in r.items() if k != "kind"} for r in lines
            if r["kind"] == "train"] == hist["train"]
    assert [{k: v for k, v in r.items() if k != "kind"} for r in lines
            if r["kind"] == "val"] == hist["val"]


def _honours_profile_steps(out: Path) -> None:
    trace = out / "profile" / "trace_steps_2-4.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def _honours_one_process_group(out: Path) -> None:
    """A run that joined a group of one (distributed: enabled, or FSDP2's
    mesh of one) trained, wrote the one-device checkpoint keys and left
    no group behind."""
    from tempo_tpu_torch.models.vae import build_vae
    from tempo_tpu_torch.parallel.mesh import is_active

    assert _steps(out) == [3, 6] and not is_active()
    info = yaml.safe_load((out / "training_info.yaml").read_text())
    assert (info["n_devices"], info["n_processes"]) == (1, 1)
    raw = torch.load(out / "checkpoints" / "ckpt_step=000006.pt",
                     weights_only=True)
    assert list(raw["model"]) == list(
        build_vae(MODEL_CFG, device="cpu")[0].state_dict())


def _honours_process_partition(out: Path) -> None:
    """One process's buffer under partition: process is the one-device
    buffer (JAX partitions only a multi-process mesh)."""
    assert _steps(out) == [3, 6]
    assert len(_history(out)["train"]) == 6


@pytest.mark.parametrize("option, honoured", [
    ({"training": {"checkpoint_format": "async"}}, _honours_async),
    ({"training": {"metrics_jsonl": True}}, _honours_metrics_jsonl),
    ({"training": {"profile_steps": [2, 4]}}, _honours_profile_steps),
    ({"distributed": {"enabled": True, "num_processes": 1, "process_id": 0,
                      "coordinator_address": "tcp://127.0.0.1:0"}},
     _honours_one_process_group),
    ({"parallel": {"fsdp": True}}, _honours_one_process_group),
    ({"data": {"loader": "device", "partition": "process",
               "buffer_slots": 2}}, _honours_process_partition),
], ids=["async", "metrics_jsonl", "profile_steps", "distributed", "fsdp",
        "device_loader"])
def test_validate_config_accepts(tmp_path, tiles_dir, option, honoured):
    """The options the JAX CLI has and the port now runs (each section of
    ``option`` merged into the config): the config validates, and a short
    run honours the option (tests/test_torch_parallel*.py run them over
    several processes)."""
    out = tmp_path / "run"
    cfg = _cfg(out, tiles_dir, n_steps=6, save_every=3, val_every=3,
               log_every=1, plot_every=100)
    for section, values in option.items():
        cfg[section] = dict(cfg.get(section, {}), **values)
    train_vae.validate_config(cfg)
    train_vae.main(_write(tmp_path / "cfg.yaml", cfg), device="cpu")
    honoured(out)
