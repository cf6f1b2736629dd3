"""The port's mixture-of-experts FFN (tempo_tpu_torch/nn/moe.py and the MoE
swap in nn/transformer.py) against tempo_tpu's on the CPU in fp32, JAX's
parameters bridged through interop/jax_params.py: MoEBlock top-1 and top-2
with and without capacity drops (rank-major overflow), the Switch aux
loss, the MoE Transformer's logits and gradients, ``moe_lm_loss_fn``'s
loss and metrics, the decay mask's names and greedy ``generate``. Both
sides compute in fp32 and differ in sum order only: outputs within 1e-5
relative, gradients within 1e-4 relative L2. The export of an MoE model
is refused by both packages (the capacity needs the batch, which the
programs keep symbolic)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.infer import export_lm as jexport
from tempo_tpu.nn import moe as jmoe
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.infer import export_lm as pexport
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import moe as pmoe
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

REL, GRAD_REL = 1e-5, 1e-4
VOCAB, BLOCK = 61, 16


def _rel_close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _configs(**kw):
    base = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=32, n_experts=4)
    base.update(kw)
    return (pt.TransformerConfig(attn_impl="xla", **base),
            jt.TransformerConfig(attn_impl="xla", **base))


def perturbed(params, seed: int, scale: float = 0.05):
    """Every float leaf moved by scale * N(0, 1) (numpy draws): the zero
    biases and unit norms of the init then test something."""
    rng = np.random.default_rng(seed)

    def move(x):
        x = np.asarray(x)
        if x.dtype != np.float32:
            return x
        return (x + scale * rng.standard_normal(x.shape)).astype(np.float32)

    return jax.tree_util.tree_map(move, params)


def bridged(pcfg, jcfg, seed=0):
    """(JAX model, its numpy params, the port model holding them)."""
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, BLOCK), jnp.int32))["params"]
    params = perturbed(jax.tree_util.tree_map(np.asarray, params), seed + 1)
    model = pt.Transformer(pcfg, device="cpu", seed=seed)
    model.load_state_dict(gpt_state_dict_from_jax(params, pcfg))
    return jmodel, params, model


def _tokens(b, t, seed=3):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _block_pair(top_k, cf, seed=0):
    """A JAX MoEBlock with perturbed params (the router scaled up so that
    the routes spread) and the port's MoEBlock holding them."""
    pcfg, jcfg = _configs(expert_top_k=top_k, expert_capacity_factor=cf)
    jblock = jmoe.MoEBlock(jcfg)
    x0 = jnp.zeros((2, 8, pcfg.n_embd))
    params = jax.tree_util.tree_map(
        np.asarray, jblock.init(jax.random.PRNGKey(seed), x0)["params"])
    params = perturbed(params, seed + 1)
    params["router"]["kernel"] = params["router"]["kernel"] * 20.0
    block = pmoe.MoEBlock(pcfg)
    block.load_state_dict({
        "router.weight": torch.from_numpy(params["router"]["kernel"].T
                                          .copy()),
        **{k: torch.from_numpy(params[k]) for k in ("w1", "w2", "b1",
                                                    "b2")}})
    return jblock, params, block


@pytest.mark.parametrize("top_k, cf, drops", [
    (1, 4.0, False), (2, 4.0, False), (1, 0.5, True), (2, 0.75, True)],
    ids=["top1", "top2", "top1_capacity_drops", "top2_rank_major_overflow"])
def test_moe_block_and_aux_match_jax(top_k, cf, drops):
    jblock, params, block = _block_pair(top_k, cf)
    x = np.random.default_rng(4).standard_normal((2, 8, 32)).astype(
        np.float32)
    want, state = jblock.apply({"params": params}, jnp.asarray(x),
                               mutable=["losses"])
    want_aux = jax.tree_util.tree_leaves(state["losses"])[0]
    with torch.no_grad():
        got, aux = block(torch.from_numpy(x))
    _rel_close(got.numpy(), want)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=REL)
    # a token dropped on every route gets exactly 0 (it rides the residual)
    dropped = (got.reshape(-1, 32).abs().sum(-1) == 0).sum().item()
    np.testing.assert_array_equal(
        got.reshape(-1, 32).numpy() == 0,
        np.asarray(want).reshape(-1, 32) == 0)
    assert (dropped > 0) == (drops and top_k == 1)
    if drops and top_k == 2:
        # rank-major: secondary routes overflow first, so with capacity
        # for the primaries every token keeps its first choice
        n, e = 16, 4
        cap = pmoe.expert_capacity(n, e, top_k, cf)
        probs = torch.softmax(block.router(torch.from_numpy(x).reshape(
            n, 32)), -1)
        first = probs.argmax(-1)
        assert torch.bincount(first, minlength=e).max() <= cap
        assert dropped == 0
        full, _ = _block_pair(top_k, 4.0)[2](torch.from_numpy(x))
        assert not torch.allclose(full, got)


def test_top_k_routes_take_the_lowest_index_among_ties():
    """Routing and beam search pick JAX's among ties (nn/transformer.py
    top_k)."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.1, 0.4, 0.1, 0.4],
                          [0.3, 0.2, 0.3, 0.2]])
    for k in (1, 2, 3):
        vals, idx = pt.top_k(probs, k)
        jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_transformer_forward_loss_and_gradients_match_jax(top_k):
    pcfg, jcfg = _configs(expert_top_k=top_k, expert_capacity_factor=1.0)
    jmodel, params, model = bridged(pcfg, jcfg)
    toks = _tokens(3, BLOCK + 1)
    tokens, targets = toks[:, :-1], toks[:, 1:]
    with torch.no_grad():
        _rel_close(model(torch.from_numpy(tokens)).numpy(),
                   jmodel.apply({"params": params}, jnp.asarray(tokens)))

    jloss = jmoe.moe_lm_loss_fn(jmodel, aux_weight=0.3)
    (want, wm), grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(tokens),
        jnp.asarray(targets))
    ploss = pmoe.moe_lm_loss_fn(model, aux_weight=0.3)
    got, gm = ploss(model, torch.from_numpy(tokens).long(),
                    torch.from_numpy(targets).long())
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=REL)
    np.testing.assert_allclose(gm["nll"].item(), float(wm["nll"]), rtol=REL)
    np.testing.assert_allclose(gm["moe_aux"].item(), float(wm["moe_aux"]),
                               rtol=REL)
    want_g = gpt_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, grads), pcfg)
    for name, p in model.named_parameters():
        assert _rel_l2(p.grad.numpy(), want_g[name]) <= GRAD_REL, name
    # the aux term is the mean over the blocks, each block's value JAX's
    _, aux = model(torch.from_numpy(tokens), with_aux=True)
    np.testing.assert_allclose(aux.item(), float(wm["moe_aux"]), rtol=REL)


def test_moe_loss_under_remat_counts_each_block_once():
    pcfg, jcfg = _configs()
    _, params, model = bridged(pcfg, jcfg)
    remat = pt.Transformer(dataclasses.replace(pcfg, remat=True),
                           device="cpu")
    remat.load_state_dict(model.state_dict())
    toks = torch.from_numpy(_tokens(2, BLOCK + 1)).long()
    losses = []
    for m in (model, remat):
        loss, metrics = pmoe.moe_lm_loss_fn(m)(m, toks[:, :-1], toks[:, 1:])
        loss.backward()
        losses.append((loss.item(), metrics["moe_aux"].item()))
    assert losses[0] == losses[1]
    for (name, p), q in zip(model.named_parameters(), remat.parameters()):
        assert _rel_l2(q.grad.numpy(), p.grad.numpy()) <= 1e-6, name


def test_decay_mask_names_match_jax():
    for kw in ({}, dict(tie_emb=False, bias=False)):
        pcfg, jcfg = _configs(**kw)
        jmodel, params, model = bridged(pcfg, jcfg)
        want = gpt_state_dict_from_jax(jax.tree_util.tree_map(
            lambda m, p: np.full(np.shape(p), m, np.float32),
            jt.gpt_decay_mask(params), params), pcfg)
        got = pt.gpt_decay_mask(model)
        assert set(got) == set(want)
        for name, decays in got.items():
            assert decays == bool(want[name].reshape(-1)[0]), name
        assert got["transformer.h.0.moe.router.weight"]
        assert got["transformer.h.0.moe.w1"] and got["transformer.h.1.moe.w2"]
        assert not got["transformer.h.0.moe.b1"]


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_generate_greedy_matches_jax(top_k):
    pcfg, jcfg = _configs(expert_top_k=top_k)
    jmodel, params, model = bridged(pcfg, jcfg)
    toks = _tokens(3, 4, seed=5)
    got = pt.generate(model, torch.from_numpy(toks), 8, temperature=0.0)
    want = jt.generate(jmodel, params, jnp.asarray(toks), 8,
                       rng=jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_moe_export_is_refused_by_both_packages(tmp_path):
    """The capacity ceil(k n / E cf) needs the token count, which the
    programs keep symbolic: JAX's export fails to trace it, the port's
    refuses it before tracing."""
    pcfg, jcfg = _configs(n_layer=1)
    jmodel, params, model = bridged(pcfg, jcfg)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jexport.export_lm(params, jcfg, tmp_path / "jax", decode_chunk=0)
    with pytest.raises(NotImplementedError, match="capacity"):
        pexport.export_lm(model.state_dict(), pcfg, tmp_path / "port",
                          decode_chunk=0)
    assert not (tmp_path / "port").exists()
