"""Activation taps, capture and patching of the port's GPT
(tempo_tpu_torch/nn/transformer.py ``forward(taps=, capture=, suffix=)``,
``cached_forward``) against tempo_tpu's on the CPU in fp32, with JAX
parameters (perturbed from JAX's init) bridged by
tempo_tpu_torch/interop/jax_params.py: the captured names are JAX's and
every captured value agrees within 1e-5 relative (learned positions, RoPE,
GQA, an MoE block); patches give JAX's patched logits; a cache step
captures JAX's names; with nothing patched the captured forward's logits
are bitwise the plain ``attn_impl="xla"`` forward's, and a w = 0 patch is
bitwise no patch."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

REL = 1e-5
VOCAB, BLOCK = 29, 16

CONFIGS = {
    "mha_wpe": dict(),
    "rope": dict(rope=True, pos_embed=False),
    "gqa_rope_wpe": dict(n_head=4, n_kv_head=2, rope=True),
    "moe": dict(n_experts=4, expert_capacity_factor=4.0),
}


def _configs(**kw):
    base = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=32, attn_impl="xla")
    base.update(kw)
    return pt.TransformerConfig(**base), jt.TransformerConfig(**base)


def _perturbed(params, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(
            np.shape(x))).astype(np.float32), params)


def bridged(name, seed=0):
    """(port model, JAX model, JAX params, port config, JAX config)."""
    pcfg, jcfg = _configs(**CONFIGS[name])
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, BLOCK), jnp.int32))["params"]
    params = _perturbed(params, seed + 1)
    model = pt.Transformer(pcfg, device="cpu", seed=seed)
    model.load_state_dict(gpt_state_dict_from_jax(params, pcfg))
    return model, jmodel, params, pcfg, jcfg


def _tokens(b, t, seed=2):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_capture_names_and_values_match_jax(name):
    model, jmodel, params, pcfg, _ = bridged(name)
    toks = _tokens(2, 11)
    with torch.no_grad():
        out, hid = pt.cached_forward(model, torch.from_numpy(toks))
        plain = model(torch.from_numpy(toks))
    jout, jhid = jt.cached_forward(jmodel, params, jnp.asarray(toks))
    assert set(hid) == set(jhid)
    assert _rel(out.numpy(), jout) <= REL
    for key in sorted(jhid):
        got, want = hid[key], np.asarray(jhid[key])
        assert tuple(got.shape) == want.shape, key
        if key.startswith("attn^"):  # weights in [0, 1]: absolute
            assert np.abs(got.numpy() - want).max() <= REL, key
        else:
            assert _rel(got.numpy(), want) <= REL, key
    want_names = {"tok_emb", "x_0", "x_ln_f", "attn_um^1", "attn^2",
                  "y_out^1", "y_out_proj^2", "attn_res^1", "x_attn^2",
                  "mlp_res^1", "x_1", "x_2"}
    want_names |= ({"kT^1", "qT^2", "q_rope^1", "k_rope^2", "v^1"}
                   if pcfg.rope else {"q^1", "k^2", "v^1"})
    if pcfg.pos_embed:
        want_names.add("pos_emb")
    assert want_names <= set(hid)
    # the capture's logits are the plain materialized forward's, bitwise
    assert torch.equal(out, plain)


@pytest.mark.parametrize("name", ["mha_wpe", "gqa_rope_wpe"])
def test_patches_match_jax(name):
    model, jmodel, params, pcfg, _ = bridged(name)
    toks = _tokens(2, 10)
    rng = np.random.default_rng(3)
    b, t, e, n = 2, 10, pcfg.n_embd, pcfg.n_head
    weights = np.asarray(jax.nn.softmax(jnp.asarray(
        rng.standard_normal((b, n, t, t)), jnp.float32), axis=-1))
    kv = pcfg.kv_heads
    patches = {
        "x_attn^1": (rng.standard_normal((b, t, e)).astype(np.float32), 0.37),
        "attn^2": (weights, 0.5),
        "mlp_res^2": (rng.standard_normal((b, t, e)).astype(np.float32), 1.0),
        "v^1": (rng.standard_normal((b, kv, t, e // n)).astype(np.float32),
                0.25),
        "x_0": (rng.standard_normal((b, t, e)).astype(np.float32), 0.1),
    }
    with torch.no_grad():
        got = model(torch.from_numpy(toks), taps={
            k: (torch.from_numpy(v), w) for k, (v, w) in patches.items()})
        base = model(torch.from_numpy(toks))
    want = jmodel.apply({"params": params}, jnp.asarray(toks), taps={
        k: (jnp.asarray(v), w) for k, (v, w) in patches.items()})
    assert _rel(got.numpy(), want) <= REL
    assert np.abs(got.numpy() - base.numpy()).max() > 1e-3


@pytest.mark.parametrize("name", ["mha_wpe", "rope"])
def test_full_patch_transplants_and_zero_patch_is_no_patch(name):
    """A w = 1 patch of x_1 from another prompt's capture reproduces that
    prompt's later captures (x + (p - x) is p up to one rounding); a w = 0
    patch is bitwise no patch."""
    model, *_ = bridged(name)
    a = torch.from_numpy(_tokens(2, 9, seed=4))
    b = torch.from_numpy(_tokens(2, 9, seed=5))
    with torch.no_grad():
        out_a, hid_a = pt.cached_forward(model, a)
        out_b, hid_b = pt.cached_forward(model, b)
        moved, hid_m = pt.cached_forward(model, a,
                                         taps={"x_1": (hid_b["x_1"], 1.0)})
        same = model(a, taps={"x_1": (hid_b["x_1"], 0.0)})
    assert torch.equal(same, out_a)
    for key in ("x_2", "x_ln_f", "attn_res^2"):
        assert _rel(hid_m[key].numpy(), hid_b[key].numpy()) <= REL, key
    assert _rel(moved.numpy(), out_b.numpy()) <= REL
    assert _rel(out_a.numpy(), out_b.numpy()) > 1e-2


def test_suffix_names_every_tap():
    model, *_ = bridged("mha_wpe")
    with torch.no_grad():
        _, hid = pt.cached_forward(model, torch.from_numpy(_tokens(1, 5)),
                                   suffix="@s")
    assert "x_0@s" in hid and "attn_res@s^1" in hid and "x_2@s" in hid
    assert all("@s" in k for k in hid)


@pytest.mark.parametrize("name", ["mha_wpe", "gqa_rope_wpe"])
def test_cache_step_captures_jax_names(name):
    """A prefill and one decode step with capture: the cache branch, no
    attn_um/attn; names and values JAX's; the step's logits bitwise the
    uncaptured step's."""
    model, jmodel, params, pcfg, jcfg = bridged(name)
    b, t0 = 2, 6
    toks = _tokens(b, t0)
    nxt = _tokens(b, 1, seed=9)
    cache = pt.init_cache(pcfg, b, device="cpu")
    twin = pt.init_cache(pcfg, b, device="cpu")
    jcache = jt.init_cache(jcfg, b)
    with torch.no_grad():
        model(torch.from_numpy(toks), cache=cache, input_pos=0)
        model(torch.from_numpy(toks), cache=twin, input_pos=0)
        (got, _), hid = pt.cached_forward(model, torch.from_numpy(nxt),
                                          cache=cache, input_pos=t0)
        plain, _ = model(torch.from_numpy(nxt), cache=twin, input_pos=t0)
    _, jcache = jmodel.apply({"params": params}, jnp.asarray(toks),
                             cache=jcache, input_pos=jnp.int32(0))
    (want, _), jhid = jt.cached_forward(
        jmodel, params, jnp.asarray(nxt), cache=jcache,
        input_pos=jnp.int32(t0))
    assert set(hid) == set(jhid)
    assert not any(k.startswith("attn") and not k.startswith("attn_res")
                   for k in hid)
    assert _rel(got.numpy(), want) <= REL
    for key in jhid:
        assert _rel(hid[key].numpy(), jhid[key]) <= REL, key
    assert torch.equal(got, plain)


def test_taps_turn_remat_off_and_keep_gradients():
    """Under remat a capture forward still records each block once, and
    its gradients are the uncaptured forward's."""
    pcfg, _ = _configs(remat=True)
    model = pt.Transformer(pcfg, device="cpu", seed=1)
    toks = torch.from_numpy(_tokens(2, 8))
    out, hid = pt.cached_forward(model, toks)
    out.square().mean().backward()
    g_cap = [p.grad.clone() for p in model.parameters()]
    model.zero_grad()
    model(toks).square().mean().backward()
    for a, b in zip(g_cap, (p.grad for p in model.parameters())):
        assert torch.allclose(a, b, rtol=1e-5, atol=1e-7)
    assert sum(k.startswith("attn_res^") for k in hid) == pcfg.n_layer


def test_captured_dtype_and_layout_bf16():
    """bf16: the residual taps hold compute_dtype, the scores fp32, the
    q/k/v [b, heads, t, hd]."""
    pcfg, _ = _configs(compute_dtype="bfloat16", n_head=4, n_kv_head=2)
    model = pt.Transformer(pcfg, device="cpu", seed=2)
    with torch.no_grad():
        _, hid = pt.cached_forward(model, torch.from_numpy(_tokens(2, 7)))
    assert hid["x_1"].dtype == torch.bfloat16
    assert hid["attn_um^1"].dtype == torch.float32
    assert tuple(hid["attn^2"].shape) == (2, 4, 7, 7)
    assert tuple(hid["q^1"].shape) == (2, 4, 7, 8)
    assert tuple(hid["k^1"].shape) == (2, 2, 7, 8)
