"""GPT training in the port against the JAX package on the CPU in fp32:
the LM cross-entropy and its gradient, the decay mask, the learning-rate
schedules, the optimizers, token batches, the EMA seeding, and 5 train
steps of a tiny GPT bridged from JAX parameters (the port through K5's
plain version, JAX through its XLA attention) on the same TokenLoader
batches. Both sides compute in fp32 and differ in sum order only: the loss
at every step within 1e-4 relative, every parameter after step 5 within
1e-4 relative L2 (the key part of c_attn's bias, whose exact gradient is 0,
is only bounded: see test_train_steps_match_jax)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tempo_tpu.cli.train_gpt import _lm_loss_fn
from tempo_tpu.data import tokens as jtokens
from tempo_tpu.nn import transformer as jt
from tempo_tpu.ops.losses import lm_cross_entropy as j_ce
from tempo_tpu.train import schedules as jsched
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.data import tokens as ptokens
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.ops.losses import lm_cross_entropy as p_ce
from tempo_tpu_torch.train import checkpoint as pckpt
from tempo_tpu_torch.train import schedules as psched
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

torch.set_num_threads(1)

REL = 1e-4
VOCAB, BLOCK, BATCH = 17, 32, 4


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _configs(**kw):
    base = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=32)
    base.update(kw)
    return (pt.TransformerConfig(attn_impl="flash", **base),
            jt.TransformerConfig(attn_impl="xla", **base))


def _bridged(pcfg, jcfg, seed=0):
    """A JAX model with its parameters and the port model holding the
    same weights."""
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, BLOCK), jnp.int32))["params"]
    model = pt.Transformer(pcfg, device="cpu", seed=seed + 1)
    model.load_state_dict(gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, params), pcfg))
    return jmodel, params, model


def _stream():
    return jtokens.make_token_stream(VOCAB, 3000, seed=0, noise=0.1)


def test_token_stream_and_batches_match_jax():
    np.testing.assert_array_equal(
        ptokens.make_token_stream(VOCAB, 3000, seed=0, noise=0.1), _stream())
    a = iter(ptokens.TokenLoader(_stream(), BATCH, BLOCK, seed=5))
    b = iter(jtokens.TokenLoader(_stream(), BATCH, BLOCK, seed=5))
    for _ in range(3):
        x, y = next(a), next(b)
        assert x.dtype == np.int32 and x.shape == (BATCH, BLOCK + 1)
        np.testing.assert_array_equal(x, y)


def test_lm_cross_entropy_value_and_gradient_match_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, VOCAB))).astype(np.float32)
    targets = rng.integers(0, VOCAB, (3, 7)).astype(np.int32)
    want, want_g = jax.value_and_grad(j_ce)(jnp.asarray(logits),
                                            jnp.asarray(targets))
    x = torch.from_numpy(logits).requires_grad_()
    got = p_ce(x, torch.from_numpy(targets))
    (2.0 * got).backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), 2.0 * np.asarray(want_g),
                               rtol=1e-5, atol=1e-8)
    # bf16 logits: fp32 reductions, the gradient in the logits' type
    xb = torch.from_numpy(logits).bfloat16().requires_grad_()
    lb = p_ce(xb, torch.from_numpy(targets))
    lb.backward()
    assert lb.dtype == torch.float32 and xb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(
        lb.item(), float(j_ce(jnp.asarray(xb.detach().float().numpy()),
                              jnp.asarray(targets))), rtol=1e-6)


def test_decay_mask_matches_jax_through_the_bridge_names():
    for kw in ({}, dict(tie_emb=False, bias=False),
               dict(rope=True, pos_embed=False, n_kv_head=1)):
        pcfg, jcfg = _configs(**kw)
        _, params, model = _bridged(pcfg, jcfg)
        jmask = jt.gpt_decay_mask(params)
        as_leaves = jax.tree_util.tree_map(
            lambda leaf, m: np.full(np.shape(leaf), float(m), np.float32),
            params, jmask)
        want = {k: bool(v.reshape(-1)[0])
                for k, v in gpt_state_dict_from_jax(as_leaves, pcfg).items()}
        assert pt.gpt_decay_mask(model) == want
        assert not pt.gpt_decay_mask(model)["transformer.ln_f.weight"]


@pytest.mark.parametrize("cfg", [
    {}, {"lr": 2e-3, "schedule": "cosine", "warmup_steps": 3, "min_lr": 1e-4,
         "decay_steps": 15},
    {"lr": 2e-3, "schedule": "cosine", "min_lr": 1e-4},
    {"lr": 1e-3, "schedule": "linear", "warmup_steps": 4, "min_lr": 0.0},
    {"lr": 1e-3, "schedule": "linear"}], ids=["constant", "cosine_warmup",
                                              "cosine", "linear_warmup",
                                              "linear"])
def test_lr_schedule_matches_optax_at_every_count(cfg):
    want = jsched.lr_schedule(cfg, 12)
    got = psched.lr_schedule(cfg, 12)
    for count in range(0, 20):
        w = float(want(count)) if callable(want) else want
        np.testing.assert_allclose(got(count), w, rtol=1e-6, atol=1e-12)
    if cfg.get("warmup_steps"):
        assert got(0) == 0.0
    assert psched.sqrt_save_steps(1000, 30) == jsched.sqrt_save_steps(1000,
                                                                       30)


def test_schedule_refusals():
    with pytest.raises(ValueError, match="warmup_steps"):
        psched.lr_schedule({"schedule": "cosine", "warmup_steps": 20}, 10)
    with pytest.raises(ValueError, match="schedule"):
        psched.lr_schedule({"schedule": "step"}, 10)
    with pytest.raises(ValueError, match="n_steps"):
        pstate.make_optimizer_from_config({"schedule": "cosine"})


def _jax_run(jmodel, params, tx, batches, grad_accum):
    step = jstep.make_train_step(_lm_loss_fn(jmodel, 0.01), tx, donate=False,
                                 grad_accum=grad_accum)
    state = jstate.create_train_state(params, tx, jax.random.PRNGKey(3))
    losses = []
    for batch in batches:
        state, m = step(state, jnp.asarray(batch))
        losses.append(float(m["loss"]))
    return losses, state.params


@pytest.mark.parametrize("case", [
    dict(), dict(n_kv_head=1), dict(grad_accum=2),
    dict(opt={"lr": 3e-3, "schedule": "cosine", "warmup_steps": 2,
              "min_lr": 3e-4})], ids=["mha", "gqa", "grad_accum2", "cosine"])
def test_train_steps_match_jax(case):
    """5 steps of AdamW (two decay groups, no clip) on the same batches:
    the port through attn_impl='flash' (K5's plain version and its
    recomputing backward), JAX through its XLA attention."""
    case = dict(case)
    grad_accum = case.pop("grad_accum", 1)
    opt = case.pop("opt", {"lr": 3e-3})
    pcfg, jcfg = _configs(**case)
    jmodel, params, model = _bridged(pcfg, jcfg)
    p_loader = iter(ptokens.TokenLoader(_stream(), BATCH, BLOCK, seed=1))
    batches = [next(p_loader) for _ in range(5)]
    j_tx = jt.make_gpt_optimizer(params, 0.1, jsched.lr_schedule(opt, 10),
                                 (0.9, 0.95))
    want_losses, want_params = _jax_run(jmodel, params, j_tx, batches,
                                        grad_accum)

    tx = pt.make_gpt_optimizer(model, 0.1, psched.lr_schedule(opt, 10),
                               (0.9, 0.95))
    state = pstate.create_train_state(model, tx, 3)
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx,
                                 grad_accum=grad_accum)
    for batch, want in zip(batches, want_losses):
        state, m = step(state, torch.from_numpy(batch))
        assert abs(m["loss"].item() - want) <= REL * abs(want)
    assert state.step == 5
    want_sd = gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, want_params), pcfg)
    got_sd = model.state_dict()
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        got = got_sd[name]
        if name.endswith("attn.c_attn.bias"):
            # the key bias moves every score of a row by one constant, so
            # its exact gradient is 0; Adam rescales the rounding noise to
            # steps of ~lr, which differ between any two implementations
            c, kv = pcfg.n_embd, pcfg.kv_heads * pcfg.head_dim
            key = slice(c, c + kv)
            assert got[key].abs().max() <= 5 * max(opt["lr"], 3e-3)
            keep = torch.ones(got.shape[0], dtype=torch.bool)
            keep[key] = False
            got, want = got[keep], want[keep]
        assert _rel_l2(got, want) <= REL, name


def test_ema_is_seeded_with_the_first_metrics_as_jax():
    pcfg, jcfg = _configs()
    jmodel, params, model = _bridged(pcfg, jcfg)
    loader = iter(ptokens.TokenLoader(_stream(), BATCH, BLOCK, seed=2))
    batches = [next(loader) for _ in range(3)]
    keys = ["loss", "nll", "grad_norm"]
    j_tx = jt.make_gpt_optimizer(params, 0.1, 1e-3, (0.9, 0.95))
    j_state = jstep.init_ema(jstate.create_train_state(
        params, j_tx, jax.random.PRNGKey(3)), keys)
    j_step = jstep.make_train_step(_lm_loss_fn(jmodel, 0.01), j_tx,
                                   donate=False)
    tx = pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95))
    state = pstate.create_train_state(model, tx, 3)
    state.ema = {}
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    for i, batch in enumerate(batches):
        j_state, j_m = j_step(j_state, jnp.asarray(batch))
        state, m = step(state, torch.from_numpy(batch))
        for k in keys:
            np.testing.assert_allclose(state.ema[k].item(),
                                       float(j_state.ema[k]), rtol=REL)
            if i == 0:  # seeded with the raw metrics, not 0.01 of them
                assert torch.equal(state.ema[k], m[k])


def test_vae_recipe_optimizer_matches_optax():
    """make_optimizer: global-norm clip at 1.0 then AdamW over all
    parameters (optax.chain(clip_by_global_norm, adamw)), on gradients
    large enough to clip, then small enough not to."""
    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 3)).astype(np.float32)
    b0 = rng.standard_normal(3).astype(np.float32)
    targets = [4.0, 0.01, 3.0]
    j_tx = jstate.make_optimizer(lr=1e-2, weight_decay=0.05)
    j_params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    j_opt = j_tx.init(j_params)
    module = torch.nn.Linear(5, 3)
    with torch.no_grad():
        module.weight.copy_(torch.from_numpy(w0.T))
        module.bias.copy_(torch.from_numpy(b0))
    tx = pstate.make_optimizer(lr=1e-2, weight_decay=0.05)
    state = pstate.create_train_state(module, tx, 0)
    x = rng.standard_normal((4, 5)).astype(np.float32)

    def j_loss(p, scale):
        return scale * jnp.sum((jnp.asarray(x) @ p["w"] + p["b"]) ** 2)

    def p_loss(model, batch, generator):
        loss = batch[0, 0] * (model(torch.from_numpy(x)) ** 2).sum()
        return loss, {"loss": loss}

    step = pstep.make_train_step(p_loss, tx)
    for scale in targets:
        g = jax.grad(j_loss)(j_params, scale)
        updates, j_opt = j_tx.update(g, j_opt, j_params)
        j_params = optax.apply_updates(j_params, updates)
        state, m = step(state, torch.full((1, 1), scale))
        np.testing.assert_allclose(m["grad_norm"].item(),
                                   float(optax.global_norm(g)), rtol=1e-5)
    np.testing.assert_allclose(module.weight.detach().numpy().T,
                               np.asarray(j_params["w"]), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(module.bias.detach().numpy(),
                               np.asarray(j_params["b"]), rtol=1e-5,
                               atol=1e-7)


def test_checkpoint_round_trip(tmp_path):
    """A state saved after 2 steps and loaded into a fresh one continues
    exactly as the live state does."""
    pcfg, _ = _configs()
    loader = iter(ptokens.TokenLoader(_stream(), BATCH, BLOCK, seed=4))
    batches = [torch.from_numpy(next(loader)) for _ in range(3)]

    def fresh(seed):
        model = pt.Transformer(pcfg, device="cpu", seed=seed)
        tx = pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95))
        return tx, pstate.create_train_state(model, tx, 3)

    tx, live = fresh(0)
    live.ema = {}
    step = pstep.make_train_step(pstep.lm_loss_fn(live.model), tx)
    for batch in batches[:2]:
        live, _ = step(live, batch)
    path = pckpt.save_checkpoint(tmp_path / "checkpoints", live,
                                 [{"step": 2, "loss": 1.0}], [])
    assert path.name == "ckpt_step=000002.pt"
    assert not list(path.parent.glob("*.tmp"))
    tx2, loaded = fresh(5)
    loaded, train_hist, val_hist = pckpt.load_checkpoint(path, loaded)
    assert loaded.step == 2 and train_hist == [{"step": 2, "loss": 1.0}]
    assert val_hist == []
    step2 = pstep.make_train_step(pstep.lm_loss_fn(loaded.model), tx2)
    live, _ = step(live, batches[2])
    loaded, _ = step2(loaded, batches[2])
    for (name, a), b in zip(live.model.named_parameters(),
                            loaded.model.parameters()):
        assert torch.equal(a, b), name
    assert all(torch.equal(live.ema[k], loaded.ema[k]) for k in live.ema)
    assert torch.equal(live.generator.get_state(),
                       loaded.generator.get_state())
    # enumeration and the resume contract
    pckpt.save_checkpoint(tmp_path / "checkpoints", live)
    ckpts = pckpt.list_checkpoints(tmp_path / "checkpoints")
    assert [pckpt.checkpoint_step(p) for p in ckpts] == [2, 3]
    assert pckpt.latest_checkpoint(tmp_path / "checkpoints") == ckpts[-1]
    assert pckpt.resolve_resume_from({"resume_from": "auto"},
                                     tmp_path) == ckpts[-1]
    assert pckpt.resolve_resume_from({"resume_from": "auto"},
                                     tmp_path / "none") is None
    assert pckpt.resolve_resume_from({"resume_from": "x.pt"},
                                     tmp_path) == "x.pt"
    assert pckpt.wants_auto_resume({"resume_from": "auto"})
    assert not pckpt.wants_auto_resume({})
    # a directory loads as a sharded checkpoint; one without an
    # index.json is none
    with pytest.raises(FileNotFoundError, match="index.json"):
        pckpt.load_checkpoint(tmp_path, loaded)


def test_remat_gives_the_same_gradients():
    pcfg, _ = _configs()
    toks = torch.from_numpy(next(iter(ptokens.TokenLoader(
        _stream(), BATCH, BLOCK, seed=6))))
    grads = []
    for remat in (False, True):
        model = pt.Transformer(dataclasses.replace(pcfg, remat=remat),
                               device="cpu", seed=0)
        p_ce(model(toks[:, :-1]), toks[:, 1:]).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-8)


def test_estimate_mfu_matches_jax_with_the_peak_given():
    pcfg, jcfg = _configs()
    got = pt.estimate_mfu(pcfg, 123_456, 8, 0.05, 989e12)
    want = jt.estimate_mfu(jcfg, 123_456, 8, 0.05, peak_flops=989e12)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    with pytest.raises(TypeError):
        pt.estimate_mfu(pcfg, 123_456, 8, 0.05)  # no TPU default peak


def test_unported_training_options_raise():
    """bf16 first moments and dropout, which the port now runs, run; an
    unknown moments type and grad_accum 0 raise."""
    pcfg, _ = _configs()
    model = pt.Transformer(pcfg, device="cpu")
    tx = pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95),
                               moments_dtype="bfloat16")
    assert isinstance(tx.build(model), pstate.MuAdamW)
    with pytest.raises(ValueError, match="moments_dtype"):
        pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95),
                              moments_dtype="int8")
    dropout = pt.Transformer(dataclasses.replace(pcfg, dropout=0.1),
                             device="cpu")
    batch = torch.from_numpy(_stream()[:2 * (BLOCK + 1)].reshape(
        2, BLOCK + 1).astype(np.int64))
    loss, _ = pstep.lm_loss_fn(dropout)(dropout, batch,
                                        torch.Generator().manual_seed(0))
    assert torch.isfinite(loss)
    with pytest.raises(ValueError, match="grad_accum"):
        pstep.make_train_step(pstep.lm_loss_fn(model), None, grad_accum=0)
