"""The trainers' options of the port (tempo_tpu_torch/train/{metrics,
checkpoint,trainer}.py, cli/train_vae.py) on the CPU, against the JAX
package where it has a counterpart:

- ``RunningMetrics`` and ``JsonlSink`` give JAX's values and lines;
- train_vae's logs/metrics.jsonl has the (step, kind, keys) sequence of the
  JAX CLI's on the same tiles; with bridged weights, fixed batches and
  JAX's posterior draws, the Trainer's records equal JAX's Trainer's within
  LOSS_REL (test_torch_vae_train.py::test_train_steps_match_jax's);
- the profile window writes a Chrome trace and changes no loss or weight;
- an async checkpoint is the sync one byte for byte, holds the state of
  the step it was taken at when a step runs while it is written, and a
  failed write re-raises on the next save() or wait().
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.train import metrics as jmetrics
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu.train.trainer import Trainer as JaxTrainer
from tempo_tpu_torch.cli import train_vae
from tempo_tpu_torch.data.synthetic import make_tile_shards
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.train import checkpoint as ckpt_lib
from tempo_tpu_torch.train import metrics as pmetrics
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep
from tempo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
LOSS_REL = 1e-3
CLI_MODEL = {"shape": [8, 16, 16], "embed_dim": 4, "chs": [16, 12, 8],
             "mid_attn": True, "num_res_blocks": 1, "z_channels": 4,
             "double_z": True, "n_attention_heads": 2, "norm_groups": 4,
             "kl_weight": 1e-6, "nll_loss_type": "l1",
             "compute_dtype": "float32"}


def _batch(seed, n=2):
    c, h, w = TINY["shape"]
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, c)).astype(np.float32)


def _port(seed=0):
    """A tiny port VAE, its optimizer and train state."""
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=seed)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    return model, tx, pstate.create_train_state(model, tx, 3)


def _trainer(out: Path, seed=0, **kw) -> Trainer:
    model, tx, state = _port(seed)
    return Trainer(pstep.vae_loss_fn(model), tx, state, out,
                   save_every=kw.pop("save_every", 100), log_every=1,
                   plot_every=1000, verbose=False, device="cpu", **kw)


def _records(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


# ------------------------------------------------------------ sinks

def test_running_metrics_matches_jax():
    ours, theirs = pmetrics.RunningMetrics(0.9), jmetrics.RunningMetrics(0.9)
    rng = np.random.default_rng(0)
    for _ in range(5):
        m = {"loss": float(rng.standard_normal()),
             "kl": np.float32(rng.random())}
        assert ours.update(m) == theirs.update(m)
    assert ours.snapshot() == theirs.snapshot()


def test_jsonl_sink_writes_jax_lines(tmp_path):
    calls = [(1, {"loss": 0.5, "grad_norm": 2.25}, "train"),
             (2, {"val_loss": 0.25}, "val"),
             (3, {"b": 1e-7, "a": -3.0}, "train")]
    ours = pmetrics.JsonlSink(tmp_path / "port" / "logs" / "m.jsonl")
    theirs = jmetrics.JsonlSink(tmp_path / "jax" / "logs" / "m.jsonl")
    for call in calls:
        ours(*call)
        theirs(*call)
    assert ours.path.read_bytes() == theirs.path.read_bytes()
    assert _records(ours.path)[0] == {"step": 1, "kind": "train",
                                      "loss": 0.5, "grad_norm": 2.25}


def test_train_vae_jsonl_has_the_jax_cli_records(tmp_path):
    """The JAX CLI and the port's on the same tiles and config: the same
    (step, kind, keys) records, in order, each key order JAX's; the
    records are the metrics.json history. (Batch 8: the tests' JAX runs on
    8 CPU devices and shards the batch over them.)"""
    from tempo_tpu.cli.train_vae import main as jax_main

    make_tile_shards(tmp_path / "train", n_files=2, tiles_per_file=8,
                     tile=16, n_spectral=8, seed=1)
    make_tile_shards(tmp_path / "val", n_files=1, tiles_per_file=8, tile=16,
                     n_spectral=8, seed=2)
    runs = {}
    for pkg, main in (("jax", jax_main),
                      ("port", lambda p: train_vae.main(p, device="cpu"))):
        runs[pkg] = tmp_path / pkg
        cfg = {"output_dir": str(runs[pkg]), "seed": 42,
               "data": {"train_dir": str(tmp_path / "train"),
                        "val_dir": str(tmp_path / "val"), "batch_size": 8,
                        "min_buffer_size": 8, "val_min_buffer_size": 8},
               "model": CLI_MODEL, "optimizer": {"lr": 1e-3},
               "training": {"n_steps": 4, "save_every": 100, "val_every": 2,
                            "log_every": 1, "plot_every": 100,
                            "metrics_jsonl": True}}
        path = tmp_path / f"{pkg}.yaml"
        path.write_text(yaml.safe_dump(cfg))
        main(str(path))
    got, want = (_records(runs[p] / "logs" / "metrics.jsonl")
                 for p in ("port", "jax"))
    assert [(r["step"], r["kind"], list(r)) for r in got] == [
        (r["step"], r["kind"], list(r)) for r in want]
    assert [r["step"] for r in got if r["kind"] == "val"] == [2, 4]
    hist = json.loads((runs["port"] / "metrics.json").read_text())
    for kind in ("train", "val"):
        assert [{k: v for k, v in r.items() if k != "kind"} for r in got
                if r["kind"] == kind] == hist[kind]


def _jax_noise(key, batch):
    h, w = batch.shape[1] // 4, batch.shape[2] // 4
    return np.asarray(jax.random.normal(
        key, (batch.shape[0], h, w, TINY["embed_dim"]), jnp.float32))


def test_trainer_records_match_jax_trainer(tmp_path, monkeypatch):
    """Bridged weights, the same 4 train batches and 2 validation batches,
    JAX's posterior draws fed to the port in its order of drawing: the
    JsonlSink records of both Trainers agree within LOSS_REL."""
    jm = JaxVAE(JaxConfig(**TINY))
    c, h, w = TINY["shape"]
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, c)),
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    batches = [_batch(10 + i) for i in range(4)]
    val = [_batch(20 + i) for i in range(2)]
    key = jax.random.PRNGKey(3)

    j_tx = jstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    j_trainer = JaxTrainer(
        jstep.vae_loss_fn(jm), j_tx,
        jstate.create_train_state(params, j_tx, key), tmp_path / "jax",
        save_every=100, val_every=2, log_every=1, plot_every=1000,
        verbose=False, metric_sinks=[jmetrics.JsonlSink(
            tmp_path / "jax" / "m.jsonl")])
    j_trainer.train(iter([jnp.asarray(b) for b in batches]),
                    lambda: iter([jnp.asarray(b) for b in val]), 4)

    draws, key = [], jax.random.PRNGKey(3)  # the Trainer donated its key
    for i, b in enumerate(batches):  # the port draws in this order
        draws.append(_jax_noise(jax.random.fold_in(key, i), b))
        if (i + 1) % 2 == 0:
            draws += [_jax_noise(jax.random.fold_in(jax.random.PRNGKey(0),
                                                    j), v)
                      for j, v in enumerate(val)]
    it = iter(draws)
    monkeypatch.setattr(
        DiagonalGaussian, "sample", lambda self, generator=None:
        self.mean + self.std * torch.from_numpy(np.array(next(it))))
    model, tx, state = _port(seed=5)
    model.load_state_dict(state_dict_from_jax_params(params))
    trainer = Trainer(pstep.vae_loss_fn(model), tx, state, tmp_path / "port",
                      save_every=100, val_every=2, log_every=1,
                      plot_every=1000, verbose=False, device="cpu",
                      metric_sinks=[pmetrics.JsonlSink(
                          tmp_path / "port" / "m.jsonl")])
    trainer.train(iter([torch.from_numpy(b) for b in batches]),
                  lambda: iter([torch.from_numpy(v) for v in val]), 4)
    assert next(it, None) is None  # every draw used

    got = _records(tmp_path / "port" / "m.jsonl")
    want = _records(tmp_path / "jax" / "m.jsonl")
    assert [(r["step"], r["kind"], list(r)) for r in got] == [
        (r["step"], r["kind"], list(r)) for r in want]
    for g, w in zip(got, want):
        for k, v in w.items():
            if k not in ("step", "kind"):
                assert abs(g[k] - v) <= LOSS_REL * abs(v), (g["step"], k,
                                                            g[k], v)


# --------------------------------------------------------- profile window

def test_profile_window_writes_a_trace_and_changes_nothing(tmp_path,
                                                           capsys):
    batches = [torch.from_numpy(_batch(30 + i)) for i in range(5)]
    runs = {}
    for name, window in (("plain", None), ("profiled", (1, 3))):
        trainer = _trainer(tmp_path / name, profile_steps=window)
        trainer.verbose = window is not None
        trainer.train(iter(batches), None, 5)
        runs[name] = trainer
    assert "Saved profiler trace to" in capsys.readouterr().out
    trace = tmp_path / "profiled" / "profile" / "trace_steps_1-3.json"
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not (tmp_path / "plain" / "profile").exists()
    assert runs["plain"].train_metrics == runs["profiled"].train_metrics
    for a, b in zip(runs["plain"].state.model.parameters(),
                    runs["profiled"].state.model.parameters()):
        assert torch.equal(a, b)


def test_profile_window_closes_at_the_end_of_a_short_run(tmp_path):
    trainer = _trainer(tmp_path, profile_steps=(1, 10))
    trainer.train(iter([torch.from_numpy(_batch(1))] * 2), None, 2)
    assert (tmp_path / "profile" / "trace_steps_1-10.json").exists()
    assert trainer._profiler is None


# ------------------------------------------------------ async checkpoints

def _stepped_state(seed=0):
    model, tx, state = _port(seed)
    step = pstep.make_train_step(pstep.vae_loss_fn(model), tx)
    state.ema = {}
    step(state, torch.from_numpy(_batch(1)))
    return state, step


def test_async_checkpoint_is_the_sync_one(tmp_path):
    state, _ = _stepped_state()
    hist = [{"step": 1, "loss": 1.5}]
    sync = ckpt_lib.save_checkpoint(tmp_path / "sync", state, hist, [])
    saver = ckpt_lib.AsyncCheckpointer()
    path = saver.save(tmp_path / "async", state, hist, [])
    assert saver.wait() == path and path.name == sync.name
    saver.close()
    assert path.read_bytes() == sync.read_bytes()
    _, _, fresh = _port(seed=9)
    fresh, train_hist, _ = ckpt_lib.load_checkpoint(path, fresh)
    for a, b in zip(fresh.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    assert train_hist == hist and fresh.step == 1


def test_async_save_holds_the_state_of_its_step(tmp_path, monkeypatch):
    """save, a train step while the write is held back (AdamW updates the
    parameters and moments in place), then wait: the file holds the state
    of the step the save was taken at."""
    state, step = _stepped_state()
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = {i: {k: v.clone() for k, v in s.items()}
               for i, s in state.optimizer.state_dict()["state"].items()}
    release = threading.Event()
    real = ckpt_lib._write_payload

    def held(ckpt_dir, payload):
        assert release.wait(60)
        return real(ckpt_dir, payload)

    monkeypatch.setattr(ckpt_lib, "_write_payload", held)
    saver = ckpt_lib.AsyncCheckpointer()
    path = saver.save(tmp_path, state)
    step(state, torch.from_numpy(_batch(2)))
    release.set()
    saver.close()
    raw = torch.load(path, weights_only=True)
    assert raw["step"] == 1
    after = state.model.state_dict()
    assert all(torch.equal(raw["model"][k], v) for k, v in before.items())
    assert not all(torch.equal(raw["model"][k], after[k]) for k in after)
    for i, s in moments.items():
        assert all(torch.equal(raw["optimizer"]["state"][i][k], v)
                   for k, v in s.items())


@pytest.mark.parametrize("then", ["save", "wait"])
def test_a_failed_async_write_reraises(tmp_path, monkeypatch, then):
    def broken(ckpt_dir, payload):
        raise OSError("disk full")

    state, _ = _stepped_state()
    saver = ckpt_lib.AsyncCheckpointer()
    monkeypatch.setattr(ckpt_lib, "_write_payload", broken)
    saver.save(tmp_path, state)  # returns; the write fails behind it
    with pytest.raises(OSError, match="disk full"):
        getattr(saver, then)(*((tmp_path, state) if then == "save" else ()))
    assert saver.wait() is None  # the error is raised once
    saver.close()


def test_trainer_async_writes_the_sync_checkpoints(tmp_path):
    batches = [torch.from_numpy(_batch(40 + i)) for i in range(4)]
    for fmt in ("msgpack", "async"):
        trainer = _trainer(tmp_path / fmt, save_every=2,
                           checkpoint_format=fmt)
        trainer.train(iter(batches), None, 4)
        assert (trainer._async_ckpt is None) == (fmt == "msgpack")
    names = sorted(p.name for p in (tmp_path / "async" / "checkpoints")
                   .iterdir())
    assert names == ["ckpt_step=000002.pt", "ckpt_step=000004.pt"]
    for name in names:
        assert ((tmp_path / "async" / "checkpoints" / name).read_bytes()
                == (tmp_path / "msgpack" / "checkpoints" / name).read_bytes())
    resumed = _trainer(tmp_path / "resumed", seed=4, checkpoint_format="async")
    resumed.load_checkpoint(tmp_path / "async" / "checkpoints" / names[-1])
    assert resumed.step == 4


@pytest.mark.parametrize("fmt, error, match", [
    ("sharded", None, None),
    ("zip", ValueError, "checkpoint_format"),
], ids=["sharded-NotImplementedError-M13",
        "zip-ValueError-checkpoint_format"])
def test_trainer_refuses_other_formats(tmp_path, fmt, error, match):
    """An unknown format raises; 'sharded' (error None; the id is the one
    it had while it raised) writes a .shards directory that loads back."""
    if error is not None:
        with pytest.raises(error, match=match):
            _trainer(tmp_path, checkpoint_format=fmt)
        return
    trainer = _trainer(tmp_path, checkpoint_format=fmt)
    path = trainer.save_checkpoint()
    assert path.name == "ckpt_step=000000.shards"
    assert (path / "index.json").exists()
    trainer.load_checkpoint(path)
    assert trainer.step == 0
