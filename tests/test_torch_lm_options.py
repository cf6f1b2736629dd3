"""The GPT family's training options in the port on the CPU: dropout
(nn/transformer.py, JAX's five sites), the bf16 first AdamW moment
(train/state.py MuAdamW against optax.adamw(mu_dtype=bfloat16)),
train_gpt runs with MoE, dropout and ``moments_dtype``, and load_params of
the JAX package's MoE and int8 ``.msgpack`` checkpoints.

Dropout: off (rate 0 or ``deterministic``) the model is the plain one bit
for bit; live, it is reproducible from a generator seed, drops at about
the rate asked, and takes the materialized attention (never K5), as
JAX's does. JAX's threefry draws cannot be reproduced, so live dropout is
not compared with JAX's.

MuAdamW against optax over 3 steps, both in fp32 with a bf16 first moment:
the second moment within 1e-6 relative, the first within two bf16 steps of
the tensor's largest element (XLA's CPU code contracts a*b + c into fused
multiply-adds, which moves the fp32 moment by an ulp; the bf16 rounding
can then flip by a step, which the next steps carry), the parameters'
updates within 2e-3 relative L2.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from tempo_tpu.nn import quant as jquant
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.cli import train_gpt
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.ops import flash_attention
from tempo_tpu_torch.train import checkpoint as pckpt
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

from test_torch_moe import perturbed

torch.set_num_threads(1)

VOCAB, BLOCK = 29, 16


def _cfg(**kw):
    base = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=32, attn_impl="flash")
    base.update(kw)
    return pt.TransformerConfig(**base)


def _tokens(b=3, t=BLOCK, seed=1):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, VOCAB, (b, t)))


@pytest.mark.parametrize("kw", [{}, dict(n_experts=2), dict(n_kv_head=1)],
                         ids=["dense", "moe", "gqa"])
def test_dropout_off_is_the_plain_model(kw):
    plain = pt.Transformer(_cfg(**kw), device="cpu", seed=3)
    drop = pt.Transformer(_cfg(dropout=0.2, **kw), device="cpu", seed=3)
    toks = _tokens()
    with torch.no_grad():
        want = plain(toks)
        assert torch.equal(drop(toks), want)
        assert torch.equal(drop(toks, deterministic=True), want)
        # rate 0 with deterministic=False draws nothing
        gen = torch.Generator().manual_seed(0)
        assert torch.equal(plain(toks, deterministic=False, generator=gen),
                           want)
        assert gen.get_state().equal(torch.Generator().manual_seed(
            0).get_state())


def test_live_dropout_is_reproducible_and_drops_at_the_rate():
    model = pt.Transformer(_cfg(dropout=0.25), device="cpu", seed=3)
    toks = _tokens()

    def run(seed):
        with torch.no_grad():
            return model(toks, deterministic=False,
                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(5), run(5))
    assert not torch.equal(run(5), run(6))
    assert not torch.equal(run(5), model(toks))
    x = torch.ones(200_000)
    y = pt.Dropout(0.25, torch.Generator().manual_seed(1))(x)
    assert abs((y == 0).float().mean().item() - 0.25) < 0.005
    assert torch.equal(torch.unique(y), torch.tensor([0.0, 1 / 0.75]))


def test_live_dropout_takes_the_materialized_attention(monkeypatch):
    calls = []
    real = flash_attention.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(flash_attention, "flash_attention", counting)
    model = pt.Transformer(_cfg(dropout=0.1), device="cpu", seed=3)
    batch = torch.cat([_tokens(), _tokens()[:, :1]], dim=1)
    loss_fn = pstep.lm_loss_fn(model)
    loss, metrics = loss_fn(model, batch, torch.Generator().manual_seed(0))
    loss.backward()
    assert calls == [] and torch.isfinite(loss)
    assert set(metrics) == {"loss", "nll"}
    with torch.no_grad():
        model(_tokens())
    assert len(calls) == 2  # deterministic: K5 (its plain version here)


def test_remat_with_live_dropout_recomputes_the_same_draws():
    cfg = _cfg(dropout=0.2, n_experts=2)
    model = pt.Transformer(cfg, device="cpu", seed=3)
    remat = pt.Transformer(dataclasses.replace(cfg, remat=True),
                           device="cpu")
    remat.load_state_dict(model.state_dict())
    batch = torch.cat([_tokens(), _tokens()[:, :1]], dim=1)
    gens = []
    for m in (model, remat):
        gen = torch.Generator().manual_seed(11)
        loss, _ = pstep.lm_loss_fn(m)(m, batch, gen)
        loss.backward()
        gens.append(gen.get_state())
    assert gens[0].equal(gens[1])
    for (name, p), q in zip(model.named_parameters(), remat.parameters()):
        torch.testing.assert_close(q.grad, p.grad, rtol=1e-6, atol=1e-9,
                                   msg=name)


def test_mu_bf16_adamw_matches_optax():
    rng = np.random.default_rng(0)
    shapes = [(16, 24), (24,), (3, 8, 5)]
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    decays = [True, False, True]
    lr, wd = 3e-3, 0.1
    tx = optax.adamw(lr, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd,
                     mu_dtype=jnp.bfloat16, mask=decays)
    params = [jnp.asarray(p) for p in p0]
    st = tx.init(params)

    @jax.jit
    def update(g, st, params):
        u, st = tx.update(g, st, params)
        return optax.apply_updates(params, u), st

    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = pstate.MuAdamW(
        [{"params": [p for p, d in zip(ps, decays) if d],
          "weight_decay": wd},
         {"params": [p for p, d in zip(ps, decays) if not d],
          "weight_decay": 0.0}], lr=lr, betas=(0.9, 0.95), eps=1e-8)
    for g in grads:
        params, st = update([jnp.asarray(x) for x in g], st, params)
        for p, x in zip(ps, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()
    adam = st[0]
    for i, p in enumerate(ps):
        s = opt.state[p]
        assert s["exp_avg"].dtype == torch.bfloat16
        assert s["exp_avg_sq"].dtype == torch.float32
        mu = np.asarray(adam.mu[i], np.float32)
        np.testing.assert_allclose(s["exp_avg"].float().numpy(), mu,
                                   rtol=0, atol=2 ** -6 * np.abs(mu).max())
        np.testing.assert_allclose(s["exp_avg_sq"].numpy(),
                                   np.asarray(adam.nu[i]), rtol=1e-6)
        want = np.asarray(params[i]) - p0[i]
        got = p.detach().numpy() - p0[i]
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-3
    # the state survives a save and a load in its types
    again = pstate.MuAdamW([dict(g, params=list(g["params"]))
                            for g in opt.param_groups], lr=lr)
    again.load_state_dict(opt.state_dict())
    for p in ps:
        for key in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(again.state[p][key], opt.state[p][key])


def test_make_gpt_optimizer_moments_dtype():
    model = pt.Transformer(_cfg(), device="cpu")
    tx = pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95),
                               moments_dtype="bfloat16")
    assert isinstance(tx.build(model), pstate.MuAdamW)
    tx = pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95),
                               moments_dtype="float32")
    assert type(tx.build(model)) is torch.optim.AdamW
    with pytest.raises(ValueError, match="moments_dtype"):
        pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95),
                              moments_dtype="float16")


def _run_cfg(out: Path, **model_extra) -> dict:
    return {
        "output_dir": str(out), "seed": 7,
        "data": {"synthetic": {"vocab_size": 17, "length": 4000,
                               "noise": 0.05}, "batch_size": 4},
        "model": {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 32,
                  **model_extra},
        "optimizer": {"lr": 3.0e-3, "weight_decay": 0.1},
        "training": {"n_steps": 6, "log_every": 2, "save_every": 3,
                     "val_every": 3, "plot_every": 1000},
        "generation": {"n_tokens": 4},
    }


def _mu_tx(model):
    return pt.make_gpt_optimizer(model, 0.1, 3e-3, (0.9, 0.95),
                                 moments_dtype="bfloat16")


def _mu_state():
    model = pt.Transformer(pt.TransformerConfig(
        in_size=17, block_size=32, n_layer=2, n_head=2, n_embd=32),
        device="cpu", seed=1)
    return pstate.create_train_state(model, _mu_tx(model), 0)


@pytest.mark.parametrize("model_extra, opt_extra, train_extra", [
    (dict(n_experts=4, expert_top_k=2), {}, dict(moe_aux_weight=0.05)),
    (dict(dropout=0.1), {}, {}),
    ({}, dict(moments_dtype="bfloat16"), {})],
    ids=["moe", "dropout", "moments_dtype"])
def test_train_gpt_runs_with_the_option(tmp_path, model_extra, opt_extra,
                                        train_extra):
    cfg = _run_cfg(tmp_path / "run", **model_extra)
    cfg["optimizer"].update(opt_extra)
    cfg["training"].update(train_extra)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_gpt.main(str(path), device="cpu")
    out = tmp_path / "run"
    metrics = json.loads((out / "metrics.json").read_text())["train"]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    info = yaml.safe_load((out / "training_info.yaml").read_text())
    assert info["n_experts"] == model_extra.get("n_experts", 0)
    ckpt = torch.load(out / "checkpoints" / "ckpt_step=000006.pt",
                      weights_only=True)
    if "n_experts" in model_extra:
        assert {"moe_aux", "nll"} <= set(metrics[-1])
        assert "transformer.h.1.moe.w1" in ckpt["model"]
    if opt_extra:
        states = ckpt["optimizer"]["state"].values()
        assert {s["exp_avg"].dtype for s in states} == {torch.bfloat16}
        # one step from the reloaded step-6 checkpoint equals one from
        # the live state, bit for bit
        live, resumed = _mu_state(), _mu_state()
        pckpt.load_checkpoint(out / "checkpoints" / "ckpt_step=000006.pt",
                              live)
        path = pckpt.save_checkpoint(tmp_path / "again", live)
        pckpt.load_checkpoint(path, resumed)
        batch = torch.from_numpy(np.random.default_rng(0).integers(
            0, 17, (4, 33)))
        for st in (live, resumed):
            step = pstep.make_train_step(pstep.lm_loss_fn(st.model),
                                         _mu_tx(st.model))
            step(st, batch)
        for a, b in zip(live.model.parameters(), resumed.model.parameters()):
            assert torch.equal(a, b)
        for a, b in zip(live.optimizer.state.values(),
                        resumed.optimizer.state.values()):
            assert a["exp_avg"].dtype == torch.bfloat16
            assert torch.equal(a["exp_avg"], b["exp_avg"])
    assert np.load(out / "generation_final.npy").shape == (1, 12)


@pytest.mark.parametrize("quantize", [False, True], ids=["moe", "int8_moe"])
def test_load_params_reads_jax_moe_and_int8_msgpack(tmp_path, quantize):
    pcfg = _cfg(n_experts=2, attn_impl="xla")
    jcfg = jt.TransformerConfig(in_size=VOCAB, block_size=BLOCK, n_layer=2,
                                n_head=2, n_embd=32, n_experts=2)
    params = jt.Transformer(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))["params"]
    params = perturbed(jax.tree_util.tree_map(np.asarray, params), 1)
    if quantize:
        params = jax.tree_util.tree_map(np.asarray,
                                        jquant.quantize_lm_params(params))
        pcfg = dataclasses.replace(pcfg, quantize="int8")
    path = tmp_path / "ckpt_step=000004.msgpack"
    path.write_bytes(serialization.msgpack_serialize(
        {"step": 4, "params": serialization.to_state_dict(params)}))
    model = pckpt.load_params(path, pt.Transformer(pcfg, device="cpu",
                                                   seed=9))
    want = gpt_state_dict_from_jax(params, pcfg)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
