"""The port's GPT (tempo_tpu_torch/nn/transformer.py) against tempo_tpu's
on the CPU in fp32, with the port's weights bridged to JAX through
tempo_tpu/interop/gpt_ckpt.py: no-cache forward, prefill and per-token
decode logits over a dense and a paged (shuffled table) cache, greedy
generate, parameter counts, and the weight bridge both ways. Logits agree
to 1e-5 relative: both sides compute in fp32 and differ in sum order
only."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.interop.gpt_ckpt import params_from_torch_transformer
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

REL = 1e-5

# the tiny configs of tests/test_paged.py, plus GQA with a learned wpe
CONFIGS = {
    "mha_wpe": dict(n_kv_head=0, rope=False),
    "gqa1_rope": dict(n_kv_head=1, rope=True, pos_embed=False),
    "gqa_wpe": dict(n_head=4, n_kv_head=2, rope=False),
}


def _configs(**kw):
    base = dict(in_size=29, block_size=16, n_layer=2, n_head=2, n_embd=32)
    base.update(kw)
    return pt.TransformerConfig(**base), jt.TransformerConfig(**base)


def _models(name, seed=0):
    pcfg, jcfg = _configs(**CONFIGS[name])
    model = pt.Transformer(pcfg, device="cpu", seed=seed)
    params = params_from_torch_transformer(model.state_dict(), jcfg)
    return model, jt.Transformer(jcfg), params, pcfg, jcfg


def _rel_close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _prompt(b, t, vocab=29, seed=2):
    return np.random.default_rng(seed).integers(0, vocab, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name):
    model, jmodel, params, _, _ = _models(name)
    toks = _prompt(2, 9)
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    want = jmodel.apply({"params": params}, jnp.asarray(toks))
    _rel_close(got.numpy(), want)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_dense_cache_prefill_and_decode_match_jax(name):
    """Prefill into a dense cache, then per-token decode (K3's plain
    version on the CPU) at a scalar and then per-row positions."""
    model, jmodel, params, pcfg, jcfg = _models(name)
    b, t0 = 2, 5
    toks = _prompt(b, t0)
    cache = pt.init_cache(pcfg, b, device="cpu")
    jcache = jt.init_cache(jcfg, b)
    with torch.no_grad():
        lp, cache = model(torch.from_numpy(toks), cache=cache, input_pos=0)
    lj, jcache = jmodel.apply({"params": params}, jnp.asarray(toks),
                              cache=jcache, input_pos=jnp.int32(0))
    _rel_close(lp.numpy(), lj)
    tok = np.array(jnp.argmax(lj[:, -1:], axis=-1), np.int32)
    for step in range(6):
        pos = t0 + step
        ppos = pos if step < 3 else torch.full((b,), pos, dtype=torch.int32)
        jpos = (jnp.int32(pos) if step < 3
                else jnp.full((b,), pos, jnp.int32))
        with torch.no_grad():
            lp, cache = model(torch.from_numpy(tok), cache=cache,
                              input_pos=ppos)
        lj, jcache = jmodel.apply({"params": params}, jnp.asarray(tok),
                                  cache=jcache, input_pos=jpos)
        _rel_close(lp.numpy(), lj)
        tok = np.array(jnp.argmax(lj[:, -1:], axis=-1), np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_paged_cache_matches_jax(name):
    """Prompt ingest (t > 1: scatter + gathered window) and per-token decode
    (K4's plain version) through a shuffled block table, with the second
    row's dead logical pages on the trash page."""
    model, jmodel, params, pcfg, jcfg = _models(name)
    b, t0, page, n_pages = 2, 6, 4, 16
    toks = _prompt(b, t0, seed=3)
    table = np.asarray([[7, 3, 11, 5], [2, 9, 0, 0]], np.int32)
    cache = tuple((pk, pv, torch.from_numpy(table)) for pk, pv, _ in
                  pt.init_paged_cache(pcfg, b, n_pages, page, device="cpu"))
    jcache = tuple((pk, pv, jnp.asarray(table)) for pk, pv, _ in
                   jt.init_paged_cache(jcfg, b, n_pages, page))
    pos0 = np.zeros(b, np.int32)
    with torch.no_grad():
        lp, cache = model(torch.from_numpy(toks), cache=cache,
                          input_pos=torch.from_numpy(pos0))
    lj, jcache = jmodel.apply({"params": params}, jnp.asarray(toks),
                              cache=jcache, input_pos=jnp.asarray(pos0))
    _rel_close(lp.numpy(), lj)
    tok = np.array(jnp.argmax(lj[:, -1:], axis=-1), np.int32)
    pos = np.full(b, t0, np.int32)
    for _ in range(5):
        with torch.no_grad():
            lp, cache = model(torch.from_numpy(tok), cache=cache,
                              input_pos=torch.from_numpy(pos))
        lj, jcache = jmodel.apply({"params": params}, jnp.asarray(tok),
                                  cache=jcache, input_pos=jnp.asarray(pos))
        _rel_close(lp.numpy(), lj)
        tok = np.array(jnp.argmax(lj[:, -1:], axis=-1), np.int32)
        pos = pos + 1
    # the pools hold what JAX's hold, slot for slot, outside the trash page
    for (pk, pv, _), (jpk, jpv, _) in zip(cache, jcache):
        _rel_close(pk[1:].numpy(), np.asarray(jpk)[1:])
        _rel_close(pv[1:].numpy(), np.asarray(jpv)[1:])


@pytest.mark.parametrize("name", ["mha_wpe", "gqa_wpe"])
def test_generate_greedy_matches_jax(name):
    model, jmodel, params, _, _ = _models(name)
    toks = _prompt(2, 4, seed=5)
    got = pt.generate(model, torch.from_numpy(toks), 8, temperature=0.0)
    want = jt.generate(jmodel, params, jnp.asarray(toks), 8,
                       rng=jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_generate_sampled_is_reproducible_and_follows_the_policy():
    model = _models("mha_wpe")[0]
    toks = torch.from_numpy(_prompt(2, 3))
    a = pt.generate(model, toks, 6, seed=4, temperature=0.8, top_k=3)
    b = pt.generate(model, toks, 6, seed=4, temperature=0.8, top_k=3)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, pt.generate(model, toks, 6, seed=5,
                                          temperature=0.8, top_k=3))
    # top_k=1 is greedy whatever the temperature
    torch.testing.assert_close(
        pt.generate(model, toks, 6, seed=9, temperature=1.5, top_k=1),
        pt.generate(model, toks, 6, temperature=0.0), rtol=0, atol=0)


def test_nucleus_mask_matches_jax():
    x = np.random.default_rng(0).standard_normal((3, 29)).astype(np.float32)
    for p in (0.3, 0.9):
        got = pt.nucleus_mask(torch.from_numpy(x), p).numpy()
        want = np.asarray(jt.nucleus_mask(jnp.asarray(x), p))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)],
                                      want[~np.isinf(want)])


def test_rope_matches_jax():
    np.testing.assert_allclose(pt.rope_cache(16, 8).numpy(),
                               np.asarray(jt.rope_cache(16, 8)),
                               rtol=1e-6, atol=1e-6)
    x = np.random.default_rng(0).standard_normal((2, 3, 2, 8)).astype(
        np.float32)
    rows = pt.rope_cache(16, 8)[torch.tensor([[1, 2, 3], [5, 6, 7]])]
    jrows = jt.rope_cache(16, 8)[jnp.asarray([[1, 2, 3], [5, 6, 7]])]
    np.testing.assert_allclose(
        pt.apply_rope(torch.from_numpy(x), rows).numpy(),
        np.asarray(jt.apply_rope(jnp.asarray(x), jrows)),
        rtol=1e-6, atol=1e-6)


def test_num_params_matches_jax_tiny_and_gpt2_small():
    for name in CONFIGS:
        model, jmodel, params, _, _ = _models(name)
        assert pt.num_params(model) == jt.num_params(params)
        assert (pt.num_params(model, non_embedding=False)
                == jt.num_params(params, non_embedding=False))
    # full GPT-2-small width: shapes only on both sides
    full = pt.Transformer(pt.TransformerConfig(), device="meta")
    jshapes = jax.eval_shape(
        lambda: jt.Transformer(jt.TransformerConfig()).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    assert pt.num_params(full) == jt.num_params(jshapes)
    assert pt.num_params(full, non_embedding=False) == 124_475_904


@pytest.mark.parametrize("kw", [{}, dict(tie_emb=False, bias=False),
                                dict(rope=True, pos_embed=False,
                                     n_kv_head=1)])
def test_weight_bridge_round_trips(kw):
    """JAX init -> gpt_state_dict_from_jax -> port -> gpt_ckpt -> the same
    JAX tree, and the port model built from it computes JAX's logits."""
    pcfg, jcfg = _configs(**kw)
    jmodel = jt.Transformer(jcfg)
    toks = jnp.asarray(_prompt(2, 5))
    params = jmodel.init(jax.random.PRNGKey(3), toks)["params"]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    sd = gpt_state_dict_from_jax(params_np, pcfg)
    model = pt.Transformer(pcfg, device="cpu", seed=1)
    model.load_state_dict(sd, strict=True)
    back = params_from_torch_transformer(model.state_dict(), jcfg)
    flat_a = jax.tree_util.tree_leaves_with_path(params_np)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    with torch.no_grad():
        got = model(torch.from_numpy(np.array(toks)))
    _rel_close(got.numpy(), jmodel.apply({"params": params}, toks))


def test_init_follows_jax_distributions():
    cfg = pt.TransformerConfig(in_size=64, block_size=32, n_layer=4,
                               n_head=2, n_embd=64)
    model = pt.Transformer(cfg, device="cpu", seed=0)
    sd = model.state_dict()
    assert torch.equal(sd["transformer.h.0.ln_1.weight"], torch.ones(64))
    assert not sd["transformer.h.1.attn.c_attn.bias"].any()
    std = sd["transformer.h.2.mlp.c_fc.weight"].std().item()
    resid = sd["transformer.h.2.mlp.c_proj.weight"].std().item()
    assert abs(std - 0.02) < 0.002
    assert abs(resid - 0.02 / np.sqrt(8)) < 0.001
    again = pt.Transformer(cfg, device="cpu", seed=0).state_dict()
    assert all(torch.equal(sd[k], again[k]) for k in sd)


def test_unported_options_raise():
    # attn_impl="flash" is ported (K5): its route runs and computes what
    # the plain attention does
    flash = pt.Transformer(pt.TransformerConfig(
        in_size=29, block_size=16, n_layer=1, n_head=2, n_embd=32,
        attn_impl="flash"), device="cpu")
    xla = pt.Transformer(dataclasses.replace(flash.config, attn_impl="xla"),
                         device="cpu")
    toks = torch.from_numpy(_prompt(2, 9))
    with torch.no_grad():
        _rel_close(flash(toks).numpy(), xla(toks).numpy())
    with pytest.raises(ValueError, match="attn_impl"):
        pt.Transformer(dataclasses.replace(pt.TransformerConfig(n_layer=1),
                                           attn_impl="pallas"),
                       device="meta")
    cfg = dataclasses.replace(pt.TransformerConfig(n_layer=1),
                              seq_axis="seq")
    with pytest.raises(NotImplementedError):
        pt.Transformer(cfg, device="meta")
    # untokenized input, the embedder modes and capture are ported
    # (tests/test_torch_{embedders,taps}.py hold them against JAX)
    untok = pt.Transformer(pt.TransformerConfig(
        in_size=5, block_size=16, n_layer=1, n_head=2, n_embd=32,
        tokenized=False), device="cpu")
    with torch.no_grad():
        assert untok(torch.ones(1, 3, 5)).shape == (1, 3, 5)
    emb = pt.Transformer(pt.TransformerConfig(n_layer=1), device="meta",
                         embedders={}, unembedders={})
    assert "transformer.wte.weight" not in emb.state_dict()
    tiny = pt.Transformer(pt.TransformerConfig(
        in_size=29, block_size=16, n_layer=1, n_head=2, n_embd=32),
        device="cpu")
    with torch.no_grad():
        logits, hiddens = tiny(torch.zeros(1, 3, dtype=torch.long),
                               capture=True)
    assert torch.equal(hiddens["x_ln_f"] @ tiny.transformer["wte"].weight.T,
                       logits)
    # decode_attn is accepted and ignored: every value is the same function
    cfg = pt.TransformerConfig(in_size=29, block_size=16, n_layer=1,
                               n_head=2, n_embd=32, decode_attn="pallas")
    pt.Transformer(cfg, device="cpu")
