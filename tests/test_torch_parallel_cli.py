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
bit. train_vae, train_vae_l2 and train_gpt also run with ``parallel.tensor:
2`` over the 2 ranks (tensor_parallel, a data axis of one): rank 1 writes
only its bytes of sharded leaves (the sharded format's), and the last
checkpoint, loaded on one device, equals a one-process run's at JAX's
parameter tolerances. train_gpt also trains an MoE model over the 2 ranks
under DDP, experts over them (``parallel.expert``), an MoE model under
tensor parallelism and FSDP2, and a 2-stage pipeline (``parallel.pipeline``,
``n_micro``), each against one process; export_lm merges the pipeline's
``.shards`` directory and a JAX pipeline run's ``.msgpack``; and
train_gpt raises JAX's validation errors of the axes."""

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
    """Two ranks without parallel.fsdp train an MoE model under DDP, each
    rank routing its rows over the global batch (JAX's expert capacity,
    Switch loss and slot order), where it was refused before global
    routing: the last checkpoint, loaded on one device, equals a
    one-process run's, with routes dropped (capacity factor 0.5)."""
    model_cfg = {"n_layer": 1, "n_head": 2, "n_embd": 32, "block_size": 32,
                 "in_size": 17, "n_experts": 2,
                 "expert_capacity_factor": 0.5}
    base = {"seed": 7,
            "data": {"synthetic": {"vocab_size": 17, "length": 4000},
                     "batch_size": 8},
            "model": dict(model_cfg), "optimizer": {"lr": 3e-3},
            "training": _training(n_steps=2, val_every=100),
            "generation": {"n_tokens": 4}}
    ddp = dict(base, output_dir=str(tmp_path / "ddp"),
               distributed=_distributed(tmp_path))
    one = json.loads(json.dumps(dict(base, output_dir=str(tmp_path / "one"))))
    a, b = _tp_run(tmp_path, "train_gpt", ddp, one)
    assert a.suffix == ".pt"

    def model(seed):
        return pt.Transformer(pt.TransformerConfig(**model_cfg),
                              device="cpu", seed=seed)

    _close_runs(a, b, model(8), model(9))


# ------------------------------------------------- tensor parallelism

def _tp_run(tmp_path, module, cfg, one_cfg):
    """The CLI with ``parallel.tensor: 2`` on 2 ranks and the same config
    on one process (no group): both runs' last checkpoints, loaded on one
    device. Rank 1 writes nothing but its own bytes of sharded leaves."""
    results = workers.launch(workers.cli_run, 2, tmp_path / "work", module,
                             cfg, ENV, join=False)
    assert all(Path(w).name.startswith("leaf_") and ".shards" in w
               for w in results[1]["written"]), results[1]["written"]
    assert results[0]["step"] == results[1]["step"]
    import importlib

    importlib.import_module(f"tempo_tpu_torch.cli.{module}").run(
        one_cfg, device="cpu")
    return [list_checkpoints(Path(c["output_dir"]) / "checkpoints")[-1]
            for c in (cfg, one_cfg)]


def _close_runs(tp_path, one_path, model_a, model_b) -> None:
    """The TP run's last checkpoint against the one-process run's, loaded
    on one device: JAX's parameter tolerances (atol 1e-5, rtol 1e-4); the
    attention's key biases, of exact gradient 0, within the steps' lr."""
    got = load_params(tp_path, model_a).state_dict()
    want = load_params(one_path, model_b).state_dict()
    for k, v in want.items():
        if k.endswith("k.bias"):
            assert float((got[k] - v).abs().max()) <= 2 * 2 * 1e-3, k
            continue
        np.testing.assert_allclose(got[k], v, atol=1e-5, rtol=1e-4,
                                   err_msg=k)


def _tp_cfgs(tmp_path, base: dict) -> tuple:
    tp = dict(base, output_dir=str(tmp_path / "tp"),
              distributed=_distributed(tmp_path), parallel={"tensor": 2})
    one = dict(base, output_dir=str(tmp_path / "one"))
    return tp, json.loads(json.dumps(one))


def test_train_vae_tensor_parallel_matches_one_process(tmp_path, tiles):
    """train_vae with parallel.tensor 2 over 2 ranks (the device buffer's
    draws the same on both, a data axis of one) against one process: the
    .pt checkpoint, gathered under TP, loads on one device and equals the
    one-process run's."""
    base = {"seed": 3,
            "data": {"train_dir": str(tiles / "train"), "batch_size": 4,
                     "loader": "device", "buffer_slots": 2,
                     "swap_every": 2},
            "model": dict(MODEL), "optimizer": {"lr": 1e-3},
            "training": _training(n_steps=2, val_every=100)}
    tp, one = _tp_cfgs(tmp_path, base)
    a, b = _tp_run(tmp_path, "train_vae", tp, one)
    assert a.suffix == ".pt"
    _close_runs(a, b, build_vae(MODEL, device="cpu", seed=8)[0],
                build_vae(MODEL, device="cpu", seed=9)[0])


def test_train_vae_l2_tensor_parallel_matches_one_process(tmp_path, tiles):
    from tempo_tpu_torch.models.vae_l2 import build_vae_l2

    base = {"seed": 3,
            "data": {"data_dir": str(tiles), "batch_size": 4,
                     "loader": "device", "buffer_slots": 2, "swap_every": 2,
                     "val_min_buffer_size": 8},
            "model": dict(MODEL),
            "l2": {"components": PRODUCTS, "mlp_hidden": [16, 16]},
            "optimizer": {"lr": 1e-3},
            "training": _training(n_steps=2, val_every=100,
                                  checkpoint_format="sharded")}
    tp, one = _tp_cfgs(tmp_path, base)
    a, b = _tp_run(tmp_path, "train_vae_l2", tp, one)
    assert a.name == "ckpt_step=000002.shards"
    _close_runs(a, b, build_vae_l2(MODEL, (16, 16), device="cpu", seed=8)[0],
                build_vae_l2(MODEL, (16, 16), device="cpu", seed=9)[0])


def test_train_gpt_tensor_parallel_matches_one_process(tmp_path):
    """train_gpt with parallel.tensor 2 and the sharded format: rank 1
    writes only its bytes of the leaves, and the last directory loads on
    one device equal to the one-process run's."""
    model_cfg = {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 32,
                 "in_size": 17}
    base = {"seed": 7,
            "data": {"synthetic": {"vocab_size": 17, "length": 4000},
                     "batch_size": 8},
            "model": dict(model_cfg), "optimizer": {"lr": 3e-3},
            "training": _training(n_steps=2, val_every=100,
                                  checkpoint_format="sharded"),
            "generation": {"n_tokens": 4}}
    tp, one = _tp_cfgs(tmp_path, base)
    a, b = _tp_run(tmp_path, "train_gpt", tp, one)
    assert a.name == "ckpt_step=000002.shards"

    def model(seed):
        return pt.Transformer(pt.TransformerConfig(**model_cfg),
                              device="cpu", seed=seed)

    _close_runs(a, b, model(8), model(9))
    assert np.load(Path(tp["output_dir"]) / "generation_final.npy").shape \
        == (1, 12)


# ------------------------------------- pipeline and expert parallelism

GPT_CLI = {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 32,
           "in_size": 17}


def _gpt_base(model_cfg: dict, **training) -> dict:
    return {"seed": 7,
            "data": {"synthetic": {"vocab_size": 17, "length": 4000},
                     "batch_size": 8},
            "model": dict(model_cfg), "optimizer": {"lr": 3e-3},
            "training": _training(n_steps=2, val_every=100, **training),
            "generation": {"n_tokens": 4}}


def _on(tmp_path, name: str, base: dict, parallel: dict) -> tuple:
    """(the run on 2 ranks under ``parallel``, the same on one process)."""
    dist_cfg = dict(_distributed(tmp_path),
                    coordinator_address=f"file://{tmp_path}/store_{name}")
    two = dict(base, output_dir=str(tmp_path / name), distributed=dist_cfg,
               parallel=parallel)
    one = dict(base, output_dir=str(tmp_path / f"{name}_one"))
    return two, json.loads(json.dumps(one))


def test_train_gpt_pipeline_expert_and_moe_over_two_ranks(tmp_path):
    """One launch of 2 ranks runs train_gpt four times: a 2-stage pipeline
    (n_micro 2, the sharded format: JAX's (rest, stage_stack) leaves),
    experts over the 2 ranks (.pt), and an MoE model under tensor
    parallelism and under FSDP2; each last checkpoint, loaded on one
    device, equals a one-process run's (the pipeline's: the dense model's
    LM loss, as JAX's pipeline trains). Then export_lm merges the
    pipeline's directory and serves its greedy decode on one process."""
    import yaml

    from tempo_tpu_torch.cli import export_lm, train_gpt

    moe_cfg = dict(GPT_CLI, n_experts=2, expert_capacity_factor=0.5)
    runs = {
        "pipe": (GPT_CLI, _gpt_base(GPT_CLI, checkpoint_format="sharded"),
                 {"pipeline": 2, "n_micro": 2}),
        "expert": (moe_cfg, _gpt_base(moe_cfg), {"expert": 2}),
        "tensor": (moe_cfg, _gpt_base(moe_cfg), {"tensor": 2}),
        "fsdp": (moe_cfg, _gpt_base(moe_cfg), {"fsdp": True})}
    cfgs = {name: _on(tmp_path, name, base, parallel)
            for name, (_, base, parallel) in runs.items()}
    results = workers.launch(
        workers.cli_runs, 2, tmp_path / "work",
        [("train_gpt", two) for two, _ in cfgs.values()], ENV, join=False)
    for i, name in enumerate(cfgs):
        assert results[0][i]["step"] == results[1][i]["step"] == 2, name
        two, one = cfgs[name]
        train_gpt.run(one, device="cpu")
        a, b = (list_checkpoints(Path(c["output_dir"]) / "checkpoints")[-1]
                for c in (two, one))
        assert a.suffix == (".shards" if name == "pipe" else ".pt"), name
        model_cfg = pt.TransformerConfig(**runs[name][0])
        _close_runs(a, b, pt.Transformer(model_cfg, device="cpu", seed=8),
                    pt.Transformer(model_cfg, device="cpu", seed=9))
    info = json.loads((tmp_path / "pipe" / "training_info.yaml").read_text())
    assert info["pipeline_stages"] == 2
    assert np.load(tmp_path / "pipe" / "generation_final.npy").shape == (
        1, 12)
    (tmp_path / "pipe" / "config.yaml").write_text(yaml.safe_dump(
        json.loads((tmp_path / "pipe" / "config.yaml").read_text())))
    export = tmp_path / "export.yaml"
    export.write_text(yaml.safe_dump({
        "run_dir": str(tmp_path / "pipe"),
        "output_dir": str(tmp_path / "exported"), "max_seq": 16}))
    export_lm.main(str(export), device="cpu")
    out = yaml.safe_load((tmp_path / "exported" / "export_info.yaml")
                         .read_text())
    assert out["pipeline_stages_merged"] == 2
    assert out["checkpoint"].endswith("ckpt_step=000002.shards")


def test_export_lm_merges_a_jax_pipeline_msgpack(tmp_path):
    """A JAX pipeline run (its checkpoint's params (rest, stage_stack)):
    export_lm on one process merges the .msgpack, exports it and checks
    the programs' greedy decode against the live model; load_params reads
    it bitwise the merged parameters."""
    import jax
    import yaml

    from tempo_tpu.nn import transformer as jt
    from tempo_tpu.parallel.pipeline import (merge_pipeline_params,
                                             split_pipeline_params)
    from tempo_tpu.train.checkpoint import save_checkpoint
    from tempo_tpu.train.state import create_train_state
    from tempo_tpu_torch.cli import export_lm
    from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax

    cfg = jt.TransformerConfig(**GPT_CLI)
    params = jt.Transformer(cfg).init(jax.random.PRNGKey(0), np.zeros(
        (2, 8), np.int32))["params"]
    split = split_pipeline_params(params, 2)
    tx = jt.make_gpt_optimizer(split, weight_decay=0.1, learning_rate=1e-3,
                               betas=(0.9, 0.95))
    run = tmp_path / "jax_run"
    path = save_checkpoint(run / "checkpoints", create_train_state(
        split, tx, jax.random.PRNGKey(3)))
    (run / "config.yaml").write_text(yaml.safe_dump(
        {"model": dict(GPT_CLI), "parallel": {"pipeline": 2}}))
    export = tmp_path / "export.yaml"
    export.write_text(yaml.safe_dump({"run_dir": str(run),
                                      "output_dir": str(tmp_path / "out"),
                                      "max_seq": 16}))
    export_lm.main(str(export), device="cpu")
    info = yaml.safe_load((tmp_path / "out" / "export_info.yaml").read_text())
    assert info["pipeline_stages_merged"] == 2
    model = load_params(path, pt.Transformer(pt.TransformerConfig(**GPT_CLI),
                                             device="cpu", seed=9))
    want = gpt_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, merge_pipeline_params(*split)), cfg)
    for name, v in model.state_dict().items():
        assert torch.equal(v, want[name]), name


def _gpt_cfg(tmp_path, model=None, parallel=None, **data) -> dict:
    return {"output_dir": str(tmp_path / "run"),
            "data": {"synthetic": {"vocab_size": 17, "length": 4000},
                     "batch_size": 8, **data},
            "model": dict(GPT_CLI, **(model or {})),
            "parallel": dict(parallel or {}), "training": {"n_steps": 1}}


@pytest.mark.parametrize("model, parallel, data, match", [
    ({"n_layer": 3}, {"pipeline": 2}, {}, "n_layer=3 must divide"),
    ({"n_experts": 3}, {"expert": 2}, {}, "n_experts=3 must be a positive"),
    ({}, {"expert": 2}, {}, "n_experts=0 must be a positive"),
    ({"n_experts": 2}, {"expert": 2, "pipeline": 2}, {},
     "expert with parallel.pipeline"),
    ({}, {"tensor": 2, "pipeline": 2}, {}, "parallel.pipeline"),
    ({"n_experts": 2}, {"tensor": 2, "expert": 2}, {}, "parallel.expert"),
    ({}, {"fsdp": True, "pipeline": 2}, {}, "parallel.fsdp"),
    ({"n_experts": 2}, {"fsdp": True, "expert": 2}, {}, "parallel.fsdp"),
    ({}, {"pipeline": 2, "n_micro": 3}, {}, "n_micro=3"),
], ids=["n_layer", "n_experts", "no_experts", "expert_pipeline",
        "tensor_pipeline", "tensor_expert", "fsdp_pipeline", "fsdp_expert",
        "n_micro"])
def test_train_gpt_raises_jax_s_validation_errors(tmp_path, model, parallel,
                                                  data, match):
    from tempo_tpu_torch.cli import train_gpt

    with pytest.raises(ValueError, match=match):
        train_gpt.validate_config(_gpt_cfg(tmp_path, model, parallel, **data))


def test_context_stays_unported_and_lora_composes_with_no_axis(tmp_path):
    from tempo_tpu_torch.cli import UNPORTED, train_gpt

    assert UNPORTED == ("context", "context_zigzag")
    with pytest.raises(NotImplementedError, match="context"):
        train_gpt.validate_config(_gpt_cfg(tmp_path, parallel={
            "context": 2}))
    for parallel in ({"pipeline": 2}, {"expert": 2}):
        cfg = _gpt_cfg(tmp_path, {"n_experts": 2}, parallel)
        cfg["finetune"] = {"lora_rank": 2, "base_checkpoint": "x.pt"}
        with pytest.raises(ValueError, match="lora_rank"):
            train_gpt.validate_config(cfg)


@pytest.mark.parametrize("parallel", [{"pipeline": 2}, {"expert": 2}],
                         ids=["pipeline", "expert"])
def test_an_axis_over_another_world_names_both_numbers(tmp_path, parallel):
    """The pipe and expert axes span the world: one process asked for 2
    raises ValueError naming 2 and 1, before any file."""
    from tempo_tpu_torch.cli import train_gpt

    with pytest.raises(ValueError, match=r"world of 2 processes, the run "
                                         r"has 1"):
        train_gpt.run(_gpt_cfg(tmp_path, {"n_experts": 2}, parallel),
                      device="cpu")
    assert not (tmp_path / "run").exists()
