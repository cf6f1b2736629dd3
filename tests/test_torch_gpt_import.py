"""The torch GPT import of the port (tempo_tpu_torch/interop/gpt_ckpt.py)
against tempo_tpu/interop/gpt_ckpt.py on the CPU: a reference-layout state
dict (tokenized, untied, untokenized) and a locally built HuggingFace
GPT2LMHeadModel (skipped without ``transformers``; nothing is downloaded)
give the port the tensors JAX's import gives flax, bit for bit through
the JAX-params bridge, and logits within the JAX test's tolerances
(atol 3e-5, rtol 1e-4) of HF's and JAX's."""

from __future__ import annotations

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.interop import gpt_ckpt as jgpt
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.interop.gpt_ckpt import (from_hf_gpt2,
                                              state_dict_from_torch_transformer)
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=1e-4)  # tests/test_transformer.py's HF parity

REFERENCE = {
    "tied": dict(),
    "untied_rope": dict(tie_emb=False, rope=True, pos_embed=False),
    "untokenized": dict(tokenized=False, in_size=12),
}


def _cfg(**kw):
    base = dict(in_size=97, block_size=16, n_layer=2, n_head=4, n_embd=32)
    base.update(kw)
    return base


def _input(cfg: dict, seed=4):
    rng = np.random.default_rng(seed)
    if cfg.get("tokenized", True):
        return rng.integers(0, cfg["in_size"], (2, 10)).astype(np.int64)
    return rng.standard_normal((2, 10, cfg["in_size"])).astype(np.float32)


def _same_tensors(got, want):
    assert set(got) == set(want)
    for k in got:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", list(REFERENCE))
def test_reference_layout_matches_jax_import(name):
    kw = _cfg(**REFERENCE[name])
    pcfg, jcfg = pt.TransformerConfig(**kw), jt.TransformerConfig(**kw)
    source = pt.Transformer(pcfg, device="cpu", seed=3)
    sd = dict(source.state_dict())
    sd["transformer.h.0.attn.bias"] = torch.ones(1, 1, 16, 16)  # a buffer
    got = state_dict_from_torch_transformer(sd, pcfg)
    params = jgpt.params_from_torch_transformer(sd, jcfg)
    _same_tensors(got, gpt_state_dict_from_jax(params, pcfg))
    model = pt.Transformer(pcfg, device="cpu", seed=9)
    model.load_state_dict(got)
    x = _input(kw)
    with torch.no_grad():
        logits = model(torch.from_numpy(x))
        assert torch.equal(logits, source(torch.from_numpy(x)))
    want = np.asarray(jt.Transformer(jcfg).apply({"params": params},
                                                 jnp.asarray(x)))
    np.testing.assert_allclose(logits.numpy(), want, **TOL)


def _hf_model():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.GPT2Config(
        vocab_size=211, n_positions=32, n_embd=48, n_layer=2, n_head=4,
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    torch.manual_seed(0)
    return transformers.GPT2LMHeadModel(hf_cfg).eval()


def test_hf_gpt2_matches_hf_and_jax():
    hf = _hf_model()
    config, sd = from_hf_gpt2(hf)
    jcfg, params = jgpt.params_from_hf_gpt2(hf)
    assert (config.in_size, config.block_size, config.n_layer,
            config.n_head, config.n_embd) == (211, 32, 2, 4, 48)
    assert config.tie_emb and config.tokenized and config.bias
    _same_tensors(sd, gpt_state_dict_from_jax(params, config))
    model = pt.Transformer(config, device="cpu")
    model.load_state_dict(sd)
    idx = np.random.default_rng(4).integers(0, 211, size=(2, 10))
    with torch.no_grad():
        ref = hf(torch.from_numpy(idx)).logits.numpy()
        got = model(torch.from_numpy(idx)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    want = np.asarray(jt.Transformer(jcfg).apply({"params": params},
                                                 jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, **TOL)


def test_stand_in_config_object_and_greedy_generate():
    """Any object with GPT-2's config fields and a state_dict() imports;
    greedy generate from the imported weights is the source model's."""
    cfg = pt.TransformerConfig(**_cfg(in_size=53))
    source = pt.Transformer(cfg, device="cpu", seed=5)
    sd = {k: (v.t() if k.endswith(("c_attn.weight", "c_proj.weight",
                                   "c_fc.weight")) else v)
          for k, v in source.state_dict().items()}
    stand_in = types.SimpleNamespace(
        config=types.SimpleNamespace(vocab_size=53, n_positions=16,
                                     n_layer=2, n_head=4, n_embd=32),
        state_dict=lambda: sd)
    config, imported = from_hf_gpt2(stand_in)
    model = pt.Transformer(config, device="cpu")
    model.load_state_dict(imported)
    prompt = _input(dict(in_size=53))[:, :4]
    assert torch.equal(pt.generate(model, prompt, 6, temperature=0.0),
                       pt.generate(source, prompt, 6, temperature=0.0))


def test_missing_tensor_is_named():
    cfg = pt.TransformerConfig(**_cfg())
    sd = dict(pt.Transformer(cfg, device="cpu").state_dict())
    del sd["transformer.h.1.mlp.c_fc.weight"]
    with pytest.raises(KeyError, match="h.1.mlp.c_fc"):
        state_dict_from_torch_transformer(sd, cfg)
