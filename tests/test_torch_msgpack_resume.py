"""The full-state resume of a JAX run in the port
(tempo_tpu_torch/interop/optax_state.py through train/checkpoint.py
``load_checkpoint``) on the CPU: checkpoints written by the JAX package's
own ``save_checkpoint`` after two JAX train steps, for each optimizer
layout its CLIs build (the VAE recipe's ``chain(clip_by_global_norm,
adamw)`` at a constant and a scheduled lr; GPT's masked ``adamw`` with fp32
and bf16 first moments; a LoRA run's adapter-only tree), resumed into the
port's state. The parameters, both moments, the count, the EMA and the
metric histories are JAX's (bit for bit through the layout maps; a bf16
mu bit for bit as bf16); then one deterministic step from the file on
each side agrees by the tolerances of test_train_steps_match_jax
(tests/test_torch_lm_train.py, tests/test_torch_vae_train.py). Last, the
train_gpt and train_vae CLIs resume a run from such a file through
``training.resume_from``."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tempo_tpu.cli.train_gpt import _lm_loss_fn
from tempo_tpu.data import tokens as jtokens
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.nn import lora as jlora
from tempo_tpu.nn import transformer as jt
from tempo_tpu.train import checkpoint as jckpt
from tempo_tpu.train import schedules as jsched
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.interop.jax_params import (gpt_state_dict_from_jax,
                                                lora_state_dict_from_jax,
                                                state_dict_from_jax_params)
from tempo_tpu_torch.interop.optax_state import adam_state, generator_seed
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.nn.lora import LoRA
from tempo_tpu_torch.train import checkpoint as pckpt
from tempo_tpu_torch.train import schedules as psched
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

torch.set_num_threads(1)

GPT_REL = 1e-4           # tests/test_torch_lm_train.py
VAE_REL = 1e-4           # tests/test_torch_vae_train.py STEP_REL
MU_BF16_REL = 2e-3       # tests/test_torch_lm_options.py, on the updates
VOCAB, BLOCK, BATCH = 17, 16, 4
TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
HISTORY = ([{"step": 1, "loss": 2.5}, {"step": 2, "loss": 2.25}],
           [{"step": 2, "val_loss": 2.0}])


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                    1e-30))


def _write(tmp_path, j_state):
    return jckpt.save_checkpoint(tmp_path / "checkpoints", j_state, *HISTORY)


def _jax_steps(loss_fn, tx, params, batches):
    step = jstep.make_train_step(loss_fn, tx, donate=False)
    state = jstep.init_ema(jstate.create_train_state(
        params, tx, jax.random.PRNGKey(7)), ["loss"])
    for b in batches:
        state, _ = step(state, jnp.asarray(b))
    return state, step


def _check_restored(state, j_state, to_port, mu_dtype=torch.float32):
    """The port's state is the JAX state written: parameters and moments
    bit for bit through ``to_port`` (a JAX tree -> port names map), the
    count as every parameter's step, the EMA, the generator's seed."""
    model, opt = state.model, state.optimizer
    want = to_port(_np(j_state.params))
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), want[name]), name
    adam = adam_state(_np(serialization.to_state_dict(j_state.opt_state)))
    mu = to_port(jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32), adam["mu"]))
    nu = to_port(adam["nu"])
    count = int(adam["count"])
    assert state.step == int(j_state.step) == count
    for name, p in model.named_parameters():
        st = opt.state[p]
        assert st["exp_avg"].dtype == mu_dtype, name
        assert torch.equal(st["exp_avg"].float(), mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert float(st["step"]) == count
    assert set(state.ema) == set(j_state.ema)
    for k, v in j_state.ema.items():
        assert state.ema[k].item() == float(v)
    probe = torch.Generator().manual_seed(generator_seed(
        np.asarray(j_state.rng)))
    assert torch.equal(state.generator.get_state(), probe.get_state())


# --------------------------------------------------------------- the GPT

def _gpt_configs(**kw):
    base = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=32)
    base.update(kw)
    return (pt.TransformerConfig(attn_impl="xla", **base),
            jt.TransformerConfig(attn_impl="xla", **base))


def _batches(n, seed):
    stream = jtokens.make_token_stream(VOCAB, 2000, seed=0, noise=0.1)
    loader = iter(jtokens.TokenLoader(stream, BATCH, BLOCK, seed=seed))
    return [next(loader) for _ in range(n)]


def _gpt_params(jcfg, seed=0):
    params = jt.Transformer(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros(
        (1, BLOCK), jnp.int32))["params"]
    return _np(params)


def _params_close(model, want_sd, pcfg=None, before=None, rel=GPT_REL):
    """Every parameter within ``rel`` relative L2 of JAX's; with
    ``before`` (the state dict the step started from), the updates
    instead."""
    got_sd = dict(model.named_parameters())
    for name, want in want_sd.items():
        got = got_sd[name].detach()
        if before is not None:
            got, want = got - before[name], want - before[name]
        if pcfg is not None and name.endswith("attn.c_attn.bias"):
            # the key bias's exact gradient is 0 (test_torch_lm_train.py)
            c, kv = pcfg.n_embd, pcfg.kv_heads * pcfg.head_dim
            key = slice(c, c + kv)
            keep = torch.ones(got.shape[0], dtype=torch.bool)
            keep[key] = False
            got, want = got[keep], want[keep]
        assert _rel_l2(got, want) <= rel, name


@pytest.mark.parametrize("case", [
    dict(), dict(moments_dtype="bfloat16"),
    dict(opt={"lr": 3e-3, "schedule": "cosine", "warmup_steps": 1,
              "min_lr": 3e-4})], ids=["fp32_moments", "bf16_moments",
                                      "cosine"])
def test_gpt_masked_adamw_resume(tmp_path, case):
    mdt = case.get("moments_dtype")
    opt = case.get("opt", {"lr": 3e-3})
    pcfg, jcfg = _gpt_configs()
    jmodel = jt.Transformer(jcfg)
    params = _gpt_params(jcfg)
    j_tx = jt.make_gpt_optimizer(params, 0.1, jsched.lr_schedule(opt, 10),
                                 (0.9, 0.95), moments_dtype=mdt)
    batches = _batches(3, seed=1)
    j_state, j_step = _jax_steps(_lm_loss_fn(jmodel, 0.01), j_tx, params,
                                 batches[:2])
    path = _write(tmp_path, j_state)

    model = pt.Transformer(pcfg, device="cpu", seed=5)
    tx = pt.make_gpt_optimizer(model, 0.1, psched.lr_schedule(opt, 10),
                               (0.9, 0.95), moments_dtype=mdt)
    state = pstate.create_train_state(model, tx, 0)
    state, train_m, val_m = pckpt.load_checkpoint(path, state)
    assert train_m == HISTORY[0] and val_m == HISTORY[1]

    def to_port(tree):
        return gpt_state_dict_from_jax(tree, pcfg)

    _check_restored(state, j_state, to_port,
                    torch.bfloat16 if mdt else torch.float32)

    # one more step from the file on each side
    template = jstep.init_ema(jstate.create_train_state(
        params, j_tx, jax.random.PRNGKey(0)), ["loss"])
    j_loaded, _, _ = jckpt.load_checkpoint(path, template)
    j_next, j_m = j_step(j_loaded, jnp.asarray(batches[2]))
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    state, m = step(state, torch.from_numpy(batches[2]))
    assert abs(m["loss"].item() - float(j_m["loss"])) <= GPT_REL * abs(
        float(j_m["loss"]))
    assert state.step == 3
    if mdt:
        # bf16 first moments: the updates within the 2e-3 relative L2 of
        # tests/test_torch_lm_options.py test_mu_bf16_adamw_matches_optax
        _params_close(model, to_port(_np(j_next.params)), pcfg,
                      before=to_port(_np(j_state.params)), rel=MU_BF16_REL)
    else:
        _params_close(model, to_port(_np(j_next.params)), pcfg)


def test_lora_adapter_tree_resume(tmp_path):
    pcfg, jcfg = _gpt_configs()
    jmodel = jt.Transformer(jcfg)
    base = _gpt_params(jcfg)
    lora = _np(jlora.init_lora(base, 2, jax.random.PRNGKey(3)))
    j_tx = jt.make_gpt_optimizer(lora, 0.1, 3e-3, (0.9, 0.95))
    loss_fn = jlora.lora_loss_fn(_lm_loss_fn(jmodel, 0.01), base, 0.5)
    batches = _batches(3, seed=2)
    j_state, j_step = _jax_steps(loss_fn, j_tx, lora, batches[:2])
    path = _write(tmp_path, j_state)

    model = pt.Transformer(pcfg, device="cpu", seed=1)
    model.load_state_dict(gpt_state_dict_from_jax(base, pcfg))
    adapters = lora_state_dict_from_jax(
        jax.tree_util.tree_map(np.zeros_like, lora), pcfg)
    trained = LoRA(model, adapters, 0.5)
    tx = pt.make_gpt_optimizer(trained, 0.1, 3e-3, (0.9, 0.95))
    state = pstate.create_train_state(trained, tx, 0)
    state, _, _ = pckpt.load_checkpoint(path, state)

    def to_port(tree):
        return {f"adapters.{n.replace('.', '/')}.{k}": v
                for n, ab in lora_state_dict_from_jax(tree, pcfg).items()
                for k, v in ab.items()}

    _check_restored(state, j_state, to_port)
    template = jstep.init_ema(jstate.create_train_state(
        lora, j_tx, jax.random.PRNGKey(0)), ["loss"])
    j_loaded, _, _ = jckpt.load_checkpoint(path, template)
    j_next, j_m = j_step(j_loaded, jnp.asarray(batches[2]))
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    state, m = step(state, torch.from_numpy(batches[2]))
    assert abs(m["loss"].item() - float(j_m["loss"])) <= GPT_REL * abs(
        float(j_m["loss"]))
    _params_close(trained, to_port(_np(j_next.params)))


# --------------------------------------------------------------- the VAE

def _vae_batch(seed, n=2):
    c, h, w = TINY["shape"]
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, c)).astype(np.float32)


def _j_mode_loss(model):
    def loss_fn(params, batch, rng):
        recon, _ = model.apply({"params": params}, batch,
                               sample_posterior=False)
        loss = jnp.mean(jnp.square(recon - batch))
        return loss, {"loss": loss}

    return loss_fn


def _p_mode_loss(model, batch, generator):
    recon, _ = model(batch, sample_posterior=False)
    loss = (recon - batch).square().mean()
    return loss, {"loss": loss}


@pytest.mark.parametrize("opt", [
    {"lr": 1e-3}, {"lr": 1e-3, "schedule": "cosine", "warmup_steps": 1,
                   "min_lr": 1e-4}], ids=["constant", "cosine"])
def test_vae_chain_clip_adamw_resume(tmp_path, opt):
    """The VAE recipe (clip at 1.0, AdamW over all parameters, weight
    decay 0.05) with a mode-based (draw-free) loss."""
    jm = JaxVAE(JaxConfig(**TINY))
    c, h, w = TINY["shape"]
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, c)),
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p))).astype(np.float32), params)
    full = dict(opt, weight_decay=0.05)
    j_tx = jstate.make_optimizer_from_config(full, n_steps=10)
    batches = [_vae_batch(10 + i) for i in range(3)]
    j_state, j_step = _jax_steps(_j_mode_loss(jm), j_tx, params,
                                 batches[:2])
    path = _write(tmp_path, j_state)

    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=4)
    tx = pstate.make_optimizer_from_config(full, n_steps=10)
    state = pstate.create_train_state(model, tx, 0)
    state, _, _ = pckpt.load_checkpoint(path, state)
    _check_restored(state, j_state, state_dict_from_jax_params)

    template = jstep.init_ema(jstate.create_train_state(
        params, j_tx, jax.random.PRNGKey(0)), ["loss"])
    j_loaded, _, _ = jckpt.load_checkpoint(path, template)
    j_next, j_m = j_step(j_loaded, jnp.asarray(batches[2]))
    state, m = pstep.make_train_step(_p_mode_loss, tx)(
        state, torch.from_numpy(batches[2]))
    for k in ("loss", "grad_norm"):
        assert abs(m[k].item() - float(j_m[k])) <= VAE_REL * abs(
            float(j_m[k])), k
    want = state_dict_from_jax_params(_np(j_next.params))
    moved = [n for n, p in model.named_parameters()
             if not torch.equal(p.detach(), state_dict_from_jax_params(
                 _np(j_loaded.params))[n])]
    assert moved
    for name, p in model.named_parameters():
        if name.endswith("mid_attn1.k.bias"):
            continue  # exact gradient 0 (test_torch_vae_train.py)
        assert _rel_l2(p.detach(), want[name]) <= VAE_REL, name


def test_the_optax_map_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="one optax AdamW"):
        adam_state({"0": {}, "1": {"inner_state": {}}})
    two = {"count": 1, "mu": {}, "nu": {}}
    with pytest.raises(ValueError, match="found 2"):
        adam_state({"0": two, "1": dict(two)})
    assert generator_seed(np.array([1, 2], np.uint32)) == 1 + (2 << 32)


# -------------------------------------------------------------- the CLIs

def test_train_gpt_resumes_a_jax_run(tmp_path):
    """train_gpt.run with training.resume_from at a JAX .msgpack of step 2
    (written by JAX's save_checkpoint over JAX's train_gpt layout) trains
    steps 3 and 4 from it; ``auto`` picks the JAX file in the run's own
    directory."""
    from tempo_tpu_torch.cli import train_gpt

    pcfg, jcfg = _gpt_configs()
    params = _gpt_params(jcfg)
    j_tx = jt.make_gpt_optimizer(params, 0.1, 3e-3, (0.9, 0.95))
    j_state, _ = _jax_steps(_lm_loss_fn(jt.Transformer(jcfg), 0.01), j_tx,
                            params, _batches(2, seed=4))
    run = tmp_path / "run"
    path = jckpt.save_checkpoint(run / "checkpoints", j_state, *HISTORY)
    model_cfg = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                     n_embd=32)
    cfg = {"output_dir": str(run), "seed": 0,
           "data": {"synthetic": {"vocab_size": VOCAB, "length": 2000},
                    "batch_size": BATCH},
           "model": model_cfg, "optimizer": {"lr": 3e-3},
           "training": {"n_steps": 4, "save_every": 2, "val_every": 100,
                        "log_every": 1, "plot_every": 100,
                        "resume_from": "auto"},
           "generation": {"n_tokens": 0}}
    trainer, _ = train_gpt.run(cfg, device="cpu")
    assert trainer.state.step == 4
    assert trainer.train_metrics[:2] == HISTORY[0]
    assert [m["step"] for m in trainer.train_metrics[2:]] == [3, 4]
    assert (run / "checkpoints" / "ckpt_step=000004.pt").exists()
    opt_steps = {float(s["step"]) for s in
                 trainer.state.optimizer.state.values()}
    assert opt_steps == {4.0}
    assert path.exists()


def test_train_vae_resumes_a_jax_run(tmp_path, monkeypatch):
    """train_vae.main with training.resume_from at a JAX full state of
    step 1: the run starts from the file's parameters and trains steps 2
    and 3."""
    import yaml

    from tempo_tpu_torch.cli import train_vae
    from tempo_tpu_torch.data.synthetic import make_tile_shards

    model_cfg = {"shape": [8, 16, 16], "embed_dim": 4, "chs": [16, 12, 8],
                 "z_channels": 4, "n_attention_heads": 2, "norm_groups": 4,
                 "compute_dtype": "float32"}
    jm = JaxVAE(JaxConfig(**dict(model_cfg, shape=(8, 16, 16),
                                 chs=(16, 12, 8))))
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 8)),
                         rng=jax.random.PRNGKey(1))["params"])
    j_tx = jstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    batch = np.random.default_rng(3).standard_normal(
        (2, 16, 16, 8)).astype(np.float32)
    j_state, _ = _jax_steps(_j_mode_loss(jm), j_tx, params, [batch])
    path = jckpt.save_checkpoint(tmp_path / "jax" / "checkpoints", j_state)
    tiles = tmp_path / "tiles"
    make_tile_shards(tiles / "train", n_files=2, tiles_per_file=8, tile=16,
                     n_spectral=8, seed=1)
    make_tile_shards(tiles / "val", n_files=1, tiles_per_file=8, tile=16,
                     n_spectral=8, seed=2)
    run = tmp_path / "run"
    cfg = {"output_dir": str(run), "seed": 42,
           "data": {"train_dir": str(tiles / "train"),
                    "val_dir": str(tiles / "val"), "batch_size": 2,
                    "min_buffer_size": 8, "val_min_buffer_size": 8},
           "model": model_cfg,
           "optimizer": {"lr": 1e-3, "betas": [0.9, 0.95],
                         "weight_decay": 0.05},
           "training": {"n_steps": 3, "save_every": 100, "val_every": 100,
                        "log_every": 1, "plot_every": 1000,
                        "resume_from": str(path)}}
    (tmp_path / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    loaded = {}
    real = pckpt.load_checkpoint

    def spy(p, state):
        out = real(p, state)
        loaded.update({k: v.detach().clone() for k, v in
                       out[0].model.state_dict().items()})
        loaded["step"] = out[0].step
        return out

    monkeypatch.setattr(pckpt, "load_checkpoint", spy)
    train_vae.main(str(tmp_path / "cfg.yaml"), device="cpu")
    assert loaded.pop("step") == 1
    want = state_dict_from_jax_params(_np(j_state.params))
    assert set(want) <= set(loaded)
    for k, v in want.items():
        assert torch.equal(loaded[k], v), k
    assert [pckpt.checkpoint_step(p) for p in
            pckpt.list_checkpoints(run / "checkpoints")] == [3]
    hist = json.loads((run / "metrics.json").read_text())
    assert [m["step"] for m in hist["train"]] == [2, 3]


# ------------------------------------- the other trainers' model layouts

def _nudged(model, seed=0):
    gen = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _l2_case():
    from tempo_tpu.interop.torch_ckpt import l2_params_from_torch_state_dict
    from tempo_tpu_torch.interop.jax_params import l2_state_dict_from_jax
    from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head

    def make(seed):
        return VAEWithL2Head(VAEConfig(**TINY), (16, 16), device="cpu",
                             seed=seed)

    params = l2_params_from_torch_state_dict(
        _nudged(make(0)).state_dict(), mlp_hidden=(16, 16), n_levels=3)
    return make(5), params, lambda t: l2_state_dict_from_jax(t, (16, 16))


def _vdm_case():
    from tempo_tpu.interop.unet_ckpt import params_from_torch_vdm
    from tempo_tpu_torch.interop.jax_params import vdm_state_dict_from_jax
    from tempo_tpu_torch.models.diffusion import VDM
    from tempo_tpu_torch.nn.unet import CUNet

    score = dict(chs=(8, 12), norm_groups=4, n_attention_heads=2,
                 dropout_prob=0.0, t_conditioning=True, t_embedding_dim=8)

    def make(seed):
        return VDM(CUNet(shape=(8, 8, 3), device="cpu", seed=seed, **score),
                   "learned_nn", seed=seed)

    params = params_from_torch_vdm(_nudged(make(0)).state_dict(),
                                   n_levels=2)
    return make(5), params, vdm_state_dict_from_jax


@pytest.mark.parametrize("case", [_l2_case, _vdm_case], ids=["vae_l2", "vdm"])
def test_layouts_of_the_l2_and_diffusion_trainers(tmp_path, case):
    """The VAE-L2 and diffusion trainers' chain(clip, adamw) over their
    models' trees (moments drawn at random, count 3): parameters and
    moments bit for bit through the models' own layout maps."""
    model, params, to_port = case()
    params = _np(params)
    tx = jstate.make_optimizer_from_config({"lr": 1e-3}, n_steps=10)
    j_state = jstep.init_ema(jstate.create_train_state(
        params, tx, jax.random.PRNGKey(2)), ["loss"])
    rng = np.random.default_rng(0)

    def draw(x):
        return rng.standard_normal(np.shape(x)).astype(np.float32)

    def fill(node):
        if hasattr(node, "mu") and hasattr(node, "count"):
            return node._replace(
                count=jnp.asarray(3, jnp.int32),
                mu=jax.tree_util.tree_map(draw, node.mu),
                nu=jax.tree_util.tree_map(lambda x: np.abs(draw(x)),
                                          node.nu))
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(fill(n) for n in node)
        return node

    j_state = j_state.replace(opt_state=fill(j_state.opt_state),
                              step=jnp.asarray(3, jnp.int32))
    path = _write(tmp_path, j_state)
    ptx = pstate.make_optimizer_from_config({"lr": 1e-3}, n_steps=10)
    state = pstate.create_train_state(model, ptx, 0)
    state, _, _ = pckpt.load_checkpoint(path, state)
    _check_restored(state, j_state, to_port)


# ------------------- the JAX-layout writer of chip_smoke.py's phase 14d

def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("mdt", [None, "bfloat16"], ids=["fp32", "bf16"])
def test_chip_smoke_writes_what_jax_restores_gpt(tmp_path, mdt):
    """Phase 14d's file (chip_smoke.py's own writer, no JAX) is a JAX
    checkpoint: JAX's load_checkpoint restores it into a masked-adamw
    TrainState holding the port state's parameters and moments, and the
    port resumes it bit for bit."""
    cs = _chip_smoke()
    pcfg, jcfg = _gpt_configs()
    model = pt.Transformer(pcfg, device="cpu", seed=2)
    tx = pt.make_gpt_optimizer(model, 0.1, 3e-3, (0.9, 0.95),
                               moments_dtype=mdt)
    state = pstate.create_train_state(model, tx, 0)
    state.ema = {}
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    for b in _batches(2, seed=6):
        step(state, torch.from_numpy(b))
    path = tmp_path / "ckpt_step=000002.msgpack"
    path.write_bytes(cs.pack_flax(cs.jax_full_state(
        state, cs.gpt_jax_tree, "gpt", (3, 4), *HISTORY)))

    params = _gpt_params(jcfg)
    j_tx = jt.make_gpt_optimizer(params, 0.1, 3e-3, (0.9, 0.95),
                                 moments_dtype=mdt)
    template = jstep.init_ema(jstate.create_train_state(
        params, j_tx, jax.random.PRNGKey(0)), ["loss", "nll", "grad_norm"])
    j_state, train_m, _ = jckpt.load_checkpoint(path, template)
    assert train_m == HISTORY[0] and int(j_state.step) == 2
    to_port = lambda tree: gpt_state_dict_from_jax(tree, pcfg)  # noqa: E731
    twin = pt.Transformer(pcfg, device="cpu", seed=8)
    twin_state = pstate.create_train_state(twin, pt.make_gpt_optimizer(
        twin, 0.1, 3e-3, (0.9, 0.95), moments_dtype=mdt), 0)
    twin_state, _, _ = pckpt.load_checkpoint(path, twin_state)
    _check_restored(twin_state, j_state, to_port,
                    torch.bfloat16 if mdt else torch.float32)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), dict(twin.named_parameters())[name])
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(state.optimizer.state[p][m],
                               twin_state.optimizer.state[
                                   dict(twin.named_parameters())[name]][m])


def test_chip_smoke_writes_what_jax_restores_vae(tmp_path):
    cs = _chip_smoke()
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=3)
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    back = state_dict_from_jax_params(cs.vae_jax_tree(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], torch.from_numpy(sd[k])) for k in sd)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = pstate.create_train_state(model, tx, 0)
    state.ema = {}
    pstep.make_train_step(_p_mode_loss, tx)(state,
                                            torch.from_numpy(_vae_batch(1)))
    path = tmp_path / "ckpt_step=000001.msgpack"
    path.write_bytes(cs.pack_flax(cs.jax_full_state(
        state, cs.vae_jax_tree, "vae", (3, 4), [], [])))
    jm = JaxVAE(JaxConfig(**TINY))
    c, h, w = TINY["shape"]
    params = _np(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, h, w, c)),
                         rng=jax.random.PRNGKey(1))["params"])
    j_tx = jstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    template = jstep.init_ema(jstate.create_train_state(
        params, j_tx, jax.random.PRNGKey(0)), ["loss", "grad_norm"])
    j_state, _, _ = jckpt.load_checkpoint(path, template)
    twin = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=9)
    twin_state = pckpt.load_checkpoint(path, pstate.create_train_state(
        twin, tx, 0))[0]
    _check_restored(twin_state, j_state, state_dict_from_jax_params)
