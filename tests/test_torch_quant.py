"""Weight-only int8 serving in the port (tempo_tpu_torch/nn/quant.py and
``quantize="int8"`` in nn/transformer.py and infer/export_lm.py) against
tempo_tpu's on the CPU: ``quantize_kernel`` and ``quantize_expert_kernel``
bitwise (int8 values and fp32 scales), ``quantize_lm_params`` name for name
bitwise through the bridge, the quantized forward (tied and untied heads,
quantized MoE experts) and greedy generate within fp32's sum-order
difference (1e-5 relative), the exported int8 programs against the live
int8 model's calls, and their meta."""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.nn import quant as jquant
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.infer import export_lm as pexp
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import quant as pquant
from tempo_tpu_torch.nn import transformer as pt

from test_torch_moe import perturbed

torch.set_num_threads(1)

REL = 1e-5
VOCAB, BLOCK = 53, 32
CASES = {"tied": {}, "untied": dict(tie_emb=False, bias=False),
         "moe_top2": dict(n_experts=3, expert_top_k=2)}


def _rel_close(got, want, rel=REL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= rel, err


def _configs(**kw):
    base = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
                n_embd=32)
    base.update(kw)
    return pt.TransformerConfig(**base), jt.TransformerConfig(**base)


def _float_params(jcfg, seed=0):
    params = jt.Transformer(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return perturbed(jax.tree_util.tree_map(np.asarray, params), seed + 1)


def _quantized(case, seed=0):
    """(JAX int8 model, its int8 params, the port's int8 model over the
    port's own quantization of the same float weights, configs)."""
    pcfg, jcfg = _configs(**CASES[case])
    params = _float_params(jcfg, seed)
    qparams = jax.tree_util.tree_map(
        np.asarray, jquant.quantize_lm_params(params))
    qp = dataclasses.replace(pcfg, quantize="int8")
    qj = dataclasses.replace(jcfg, quantize="int8")
    model = pt.Transformer(qp, device="cpu")
    model.load_state_dict(pquant.quantize_lm_params(
        gpt_state_dict_from_jax(params, pcfg)))
    return jt.Transformer(qj), qparams, model, qp, qj


def test_quantize_kernels_are_jax_bitwise():
    rng = np.random.default_rng(0)
    kernel = (0.05 * rng.standard_normal((24, 40))).astype(np.float32)
    kernel[:, 3] = 0.0                       # an all-zero channel: scale 1
    kernel[:, 7] = 0.0                       # scale 1: halves round to even
    kernel[:4, 7] = (127.0, 2.5, 3.5, -0.5)
    jq, js = jquant.quantize_kernel(jnp.asarray(kernel))
    pq, ps = pquant.quantize_kernel(torch.from_numpy(kernel.T.copy()))
    assert pq.dtype == torch.int8 and ps.dtype == torch.float32
    np.testing.assert_array_equal(pq.numpy().T, np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    experts = (0.05 * rng.standard_normal((3, 16, 24))).astype(np.float32)
    experts[1, :, 2] = 0.0
    jq, js = jquant.quantize_expert_kernel(jnp.asarray(experts))
    pq, ps = pquant.quantize_expert_kernel(torch.from_numpy(experts))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))


@pytest.mark.parametrize("case", list(CASES))
def test_quantize_lm_params_matches_jax_name_for_name(case):
    pcfg, jcfg = _configs(**CASES[case])
    params = _float_params(jcfg)
    want = gpt_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jquant.quantize_lm_params(params)), pcfg)
    got = pquant.quantize_lm_params(gpt_state_dict_from_jax(params, pcfg))
    assert set(got) == set(want)
    for name, value in got.items():
        assert value.dtype == want[name].dtype, name
        np.testing.assert_array_equal(value.numpy(), want[name].numpy(),
                                      err_msg=name)
    # the int8 model loads it strictly and holds what it expects
    model = pt.Transformer(dataclasses.replace(pcfg, quantize="int8"),
                           device="cpu")
    model.load_state_dict(got)
    assert set(model.state_dict()) == set(got)


@pytest.mark.parametrize("case", list(CASES))
def test_quantized_forward_and_generate_match_jax(case):
    jmodel, qparams, model, _, _ = _quantized(case)
    toks = np.random.default_rng(3).integers(0, VOCAB, (2, 9)).astype(
        np.int32)
    with torch.no_grad():
        got = model(torch.from_numpy(toks))
    _rel_close(got.numpy(), jmodel.apply({"params": qparams},
                                         jnp.asarray(toks)))
    gen = pt.generate(model, torch.from_numpy(toks[:, :4]), 6,
                      temperature=0.0)
    want = jt.generate(jmodel, qparams, jnp.asarray(toks[:, :4]), 6,
                       rng=jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(want))


def test_quantized_forward_is_the_float_model_on_dequantized_weights():
    """int8 x scale, rounded once to the compute type, is the weight the
    float model would read: the two forwards agree to fp32 rounding."""
    _, _, model, qcfg, _ = _quantized("tied")
    sd = model.state_dict()
    deq = {}
    for name, value in sd.items():
        if name.endswith("kernel_q"):
            prefix = name[:-len("kernel_q")]
            deq[prefix + "weight"] = value.float() * sd[prefix + "scale"][
                :, None]
        elif not name.endswith(".scale"):
            deq[name] = value
    dense = pt.Transformer(dataclasses.replace(qcfg, quantize="none"),
                           device="cpu")
    dense.load_state_dict(deq)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, VOCAB, (2, 9)))
    with torch.no_grad():
        _rel_close(model(toks).numpy(), dense(toks).numpy(), 1e-6)


def test_serving_copy_keeps_int8_and_casts_scales():
    _, _, model, qcfg, _ = _quantized("moe_top2")
    bf = dataclasses.replace(qcfg, compute_dtype="bfloat16")
    copy = pt.serving_copy(model.state_dict(), bf)
    types = {n: p.dtype for n, p in copy.named_parameters()}
    assert types["transformer.h.0.attn.c_attn.kernel_q"] == torch.int8
    assert types["transformer.h.0.attn.c_attn.scale"] == torch.bfloat16
    assert types["transformer.wte.kernel_q"] == torch.int8
    assert types["transformer.wte.scale"] == torch.bfloat16
    assert types["transformer.h.1.moe.w2_q"] == torch.int8
    assert types["transformer.h.1.moe.w2_scale"] == torch.bfloat16
    assert types["transformer.h.1.moe.router.weight"] == torch.float32
    assert types["transformer.ln_f.weight"] == torch.float32


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The port's int8 model (tied head) and its export with every
    program."""
    _, _, model, qcfg, _ = _quantized("tied")
    out = pexp.export_lm(model.state_dict(), qcfg,
                         tmp_path_factory.mktemp("q") / "lm",
                         decode_chunk=4, page_size=8)
    return model, out


def test_int8_export_meta_and_weights(exported):
    model, out = exported
    meta = json.loads((out / "meta.json").read_text())
    assert meta["quantize"] == "int8" and meta["n_experts"] == 0
    weights = torch.load(out / "weights.pt", weights_only=True)
    assert weights["transformer.wte.kernel_q"].dtype == torch.int8
    assert weights["transformer.h.0.mlp.c_fc.kernel_q"].dtype == torch.int8
    assert weights["transformer.h.0.mlp.c_fc.scale"].dtype == torch.float32
    assert set(weights) == set(model.state_dict())


def _randomized(inputs, gen):
    """The examples with random caches and tokens (positions and tables
    stay 0, valid for every program)."""
    def one(x):
        if isinstance(x, (tuple, list)):
            return type(x)(one(v) for v in x)
        if x.is_floating_point() and x.ndim >= 3:
            return torch.randn(x.shape, generator=gen)
        if x.dtype == torch.int64 and x.ndim == 2:
            return torch.randint(0, VOCAB, x.shape, generator=gen)
        return x.clone()

    return one(inputs)


def _clone(x):
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x.clone()


@pytest.mark.parametrize("name", pexp.program_names(
    {"decode_chunk": 4, "page_size": 8}))
def test_each_int8_program_matches_the_live_call(exported, name):
    model, out = exported
    meta = json.loads((out / "meta.json").read_text())
    surface = pexp._load(out, "cpu", name)
    live = pexp._live_surface(model, None, 4, 8, "cpu")
    inputs, _ = pexp._examples(name, meta, torch.device("cpu"))
    inputs = _randomized(inputs, torch.Generator().manual_seed(7))
    want_in, got_in = _clone(inputs), _clone(inputs)
    with torch.no_grad():
        want = live.program(name)(*want_in)
        got = surface.program(name)(*got_in)
    # outputs, and the caches the call wrote in place
    for g, w in zip(torch.utils._pytree.tree_leaves((got, got_in)),
                    torch.utils._pytree.tree_leaves((want, want_in))):
        if g.is_floating_point():
            torch.testing.assert_close(g, w, rtol=REL, atol=REL)
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=0)
