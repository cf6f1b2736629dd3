"""The untokenized and embedder modes of the port's GPT
(tempo_tpu_torch/nn/transformer.py ``TiedLinear``, ``embedders`` /
``unembedders``) against tempo_tpu's on the CPU in fp32, with JAX
parameters (perturbed from JAX's init) bridged by
tempo_tpu_torch/interop/jax_params.py ``gpt_state_dict_from_jax``
(``wte.kernel``, ``embedders_<k>`` / ``unembedders_<k>``): outputs within
1e-5 relative, every parameter's gradient within 1e-4; the decoders
refuse both modes, as JAX asserts."""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

REL, GRAD_REL = 1e-5, 1e-4
BLOCK, EMBD, IN = 16, 32, 12

UNTOKENIZED = {
    "wpe": dict(),
    "rope_gqa": dict(rope=True, pos_embed=False, n_head=4, n_kv_head=2),
    "wpe_untied_no_ln_bias": dict(tie_emb=False, bias=False),
}


def _configs(**kw):
    base = dict(in_size=IN, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=EMBD, tokenized=False, attn_impl="xla")
    base.update(kw)
    return pt.TransformerConfig(**base), jt.TransformerConfig(**base)


def _perturbed(params, seed: int, scale: float = 0.05):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + scale * rng.standard_normal(
            np.shape(x))).astype(np.float32), params)


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _grads_match(model, jgrads, pcfg):
    want = gpt_state_dict_from_jax(jgrads, pcfg)
    got = {k: p.grad for k, p in model.named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        assert _rel(g.numpy(), want[k].numpy()) <= GRAD_REL, k


def _features(b, t, c, seed):
    return np.random.default_rng(seed).standard_normal((b, t, c)).astype(
        np.float32)


@pytest.mark.parametrize("name", list(UNTOKENIZED))
def test_untokenized_forward_and_gradients_match_jax(name):
    pcfg, jcfg = _configs(**UNTOKENIZED[name])
    x = _features(2, 11, IN, 1)
    jmodel = jt.Transformer(jcfg)
    params = _perturbed(jmodel.init(jax.random.PRNGKey(0),
                                    jnp.asarray(x))["params"], 1)
    assert set(params["wte"]) == {"kernel"}
    model = pt.Transformer(pcfg, device="cpu", seed=0)
    model.load_state_dict(gpt_state_dict_from_jax(params, pcfg))
    assert tuple(model.state_dict()["transformer.wte.lin.weight"].shape) \
        == (EMBD, IN)

    out = model(torch.from_numpy(x))
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    assert out.shape == (2, 11, IN)
    assert _rel(out.detach().numpy(), want) <= REL

    target = _features(2, 11, IN, 2)
    (out - torch.from_numpy(target)).square().mean().backward()
    jgrads = jax.grad(lambda p: jnp.mean(jnp.square(
        jmodel.apply({"params": p}, jnp.asarray(x)) - target)))(params)
    _grads_match(model, jax.tree_util.tree_map(np.asarray, jgrads), pcfg)


def _dict_models(pos_embedder: bool, seed=0):
    pcfg, jcfg = _configs(in_size=8)
    jemb = {"x": fnn.Dense(EMBD), "cond": fnn.Dense(EMBD)}
    pemb = {"x": nn.Linear(8, EMBD), "cond": nn.Linear(3, EMBD)}
    if pos_embedder:
        jemb["pos"] = fnn.Embed(BLOCK, EMBD)
        pemb["pos"] = nn.Embedding(BLOCK, EMBD)
    jmodel = jt.Transformer(jcfg, embedders=jemb,
                            unembedders={"x": fnn.Dense(5)})
    x = {"x": _features(2, 9, 8, 3), "cond": _features(2, 9, 3, 4)}
    params = _perturbed(jmodel.init(jax.random.PRNGKey(seed), {
        k: jnp.asarray(v) for k, v in x.items()})["params"], seed + 1)
    model = pt.Transformer(pcfg, device="cpu", seed=seed, embedders=pemb,
                           unembedders={"x": nn.Linear(EMBD, 5)})
    model.load_state_dict(gpt_state_dict_from_jax(params, pcfg))
    return model, jmodel, params, pcfg, x


@pytest.mark.parametrize("pos_embedder", [False, True],
                         ids=["wpe", "pos_embedder"])
def test_dict_mode_forward_and_gradients_match_jax(pos_embedder):
    model, jmodel, params, pcfg, x = _dict_models(pos_embedder)
    assert ("transformer.wpe.weight" in model.state_dict()) != pos_embedder
    assert "transformer.wte.weight" not in model.state_dict()
    out = model({k: torch.from_numpy(v) for k, v in x.items()})
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    want = jmodel.apply({"params": params}, jx)
    assert out.shape == (2, 9, 5)
    assert _rel(out.detach().numpy(), want) <= REL
    out.square().sum().backward()
    jgrads = jax.grad(lambda p: jnp.sum(jnp.square(
        jmodel.apply({"params": p}, jx))))(params)
    _grads_match(model, jax.tree_util.tree_map(np.asarray, jgrads), pcfg)


def test_dict_mode_captures_jax_names():
    model, jmodel, params, _, x = _dict_models(True)
    with torch.no_grad():
        out, hid = pt.cached_forward(
            model, {k: torch.from_numpy(v) for k, v in x.items()})
    jout, jhid = jt.cached_forward(jmodel, params,
                                   {k: jnp.asarray(v) for k, v in x.items()})
    assert set(hid) == set(jhid) and "tok_emb" not in hid
    for key in jhid:
        assert _rel(hid[key].numpy(), jhid[key]) <= REL, key


def test_decoders_refuse_untokenized_models(tmp_path):
    from tempo_tpu_torch.infer.export_lm import export_lm
    from tempo_tpu_torch.nn.beam import beam_search

    pcfg, _ = _configs()
    model = pt.Transformer(pcfg, device="cpu")
    prompt = np.zeros((1, 3), np.int64)
    with pytest.raises(ValueError, match="tokenized"):
        pt.generate(model, prompt, 2)
    with pytest.raises(ValueError, match="tokenized"):
        beam_search(model, prompt, 2, 2)
    with pytest.raises(ValueError, match="tokenized"):
        export_lm(model.state_dict(), pcfg, tmp_path / "art")
    dict_model, *_ = _dict_models(False)
    with pytest.raises(ValueError, match="tokenized"):
        pt.generate(dict_model, prompt, 2)
    with pytest.raises(ValueError, match="go together"):
        pt.Transformer(pcfg, device="cpu", embedders={})


def test_decay_mask_decays_the_tied_linear_and_embedder_weights():
    model, *_ = _dict_models(True)
    mask = pt.gpt_decay_mask(model)
    assert mask["embedders.x.weight"] and mask["embedders.pos.weight"]
    assert not mask["embedders.x.bias"]
    untok = pt.Transformer(_configs()[0], device="cpu")
    assert pt.gpt_decay_mask(untok)["transformer.wte.lin.weight"]
