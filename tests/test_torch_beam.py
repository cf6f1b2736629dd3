"""Beam search in the port (tempo_tpu_torch/nn/beam.py, infer/serving.py
``LMServer.beam_batch`` and beam ``serve_requests``) against tempo_tpu's
on the CPU in fp32: tokens equal and scores within 1e-5 (both sides sum
the matmuls in another order), with and without RoPE, with eos freezing
and the GNMT length penalty; width 1 equals greedy decode; the servers
over each package's artifact of the same weights."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.infer import export_lm as jexp
from tempo_tpu.infer import serving as jsrv
from tempo_tpu.nn import beam as jbeam
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.infer import export_lm as pexp
from tempo_tpu_torch.infer import serving as psrv
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import beam as pbeam
from tempo_tpu_torch.nn import transformer as pt

from test_torch_moe import perturbed

torch.set_num_threads(1)

VOCAB, BLOCK = 23, 32
TOL = {"rtol": 1e-5, "atol": 1e-5}
CONFIGS = {"wpe": {}, "rope_gqa": dict(rope=True, pos_embed=False,
                                       n_head=4, n_kv_head=2)}


def _bridged(name, seed=0):
    kw = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
              n_embd=32)
    kw.update(CONFIGS[name])
    pcfg, jcfg = pt.TransformerConfig(**kw), jt.TransformerConfig(**kw)
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    # larger weights: peaked next-token distributions, distinct beams
    params = perturbed(jax.tree_util.tree_map(np.asarray, params), seed + 1,
                       scale=0.3)
    model = pt.Transformer(pcfg, device="cpu")
    model.load_state_dict(gpt_state_dict_from_jax(params, pcfg))
    return jmodel, params, model, pcfg, jcfg


def _prompts(b=3, t=4, seed=2):
    return np.random.default_rng(seed).integers(0, VOCAB, (b, t)).astype(
        np.int32)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("eos, alpha", [(None, 0.0), (5, 0.0), (5, 0.8),
                                        (None, 1.2)],
                         ids=["plain", "eos", "eos_penalty", "penalty"])
def test_beam_search_matches_jax(name, eos, alpha):
    jmodel, params, model, _, _ = _bridged(name)
    idx = _prompts()
    want_seq, want_sc = jbeam.beam_search(jmodel, params, jnp.asarray(idx),
                                          9, 4, eos_id=eos,
                                          length_penalty=alpha)
    seq, sc = pbeam.beam_search(model, torch.from_numpy(idx), 9, 4,
                                eos_id=eos, length_penalty=alpha)
    np.testing.assert_array_equal(seq.numpy(), np.asarray(want_seq))
    np.testing.assert_allclose(sc.numpy(), np.asarray(want_sc), **TOL)


def test_eos_freezes_a_finished_beam():
    """With eos the most likely first token, the hypotheses that emit it
    stay eos to the end and keep their score."""
    _, _, model, _, _ = _bridged("wpe")
    idx = torch.from_numpy(_prompts(2, 4))
    with torch.no_grad():
        first = model(idx)[:, -1].argmax(-1)
    eos = int(first[0])
    seq, sc = pbeam.beam_search(model, idx, 7, 3, eos_id=eos)
    for j in range(3):
        cont = seq[0, j, 4:].tolist()
        if eos in cont:
            at = cont.index(eos)
            assert cont[at:] == [eos] * (7 - at)
    raw, raw_sc = pbeam.beam_search(model, idx, 1, 3, eos_id=eos)
    # a beam that finished at step 0 scores what it scored there
    j = seq[0, :, 4].tolist().index(eos)
    assert sc[0, j].item() == pytest.approx(
        raw_sc[0, raw[0, :, 4].tolist().index(eos)].item(), abs=1e-6)


def test_width_one_is_greedy():
    _, _, model, _, _ = _bridged("rope_gqa")
    idx = torch.from_numpy(_prompts())
    seq, _ = pbeam.beam_search(model, idx, 8, 1)
    want = pt.generate(model, idx, 8, temperature=0.0)
    assert torch.equal(seq[:, 0], want)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Both packages' artifacts of the same weights."""
    root = tmp_path_factory.mktemp("beam")
    _, params, model, pcfg, jcfg = _bridged("wpe")
    jdir = jexp.export_lm(params, jcfg, root / "jax", decode_chunk=4)
    pdir = pexp.export_lm(model.state_dict(), pcfg, root / "torch",
                          decode_chunk=4)
    return jdir, pdir, model


@pytest.mark.parametrize("k, eos, alpha", [(1, None, 0.0), (3, None, 0.0),
                                           (4, 5, 0.6)],
                         ids=["width1", "width3", "eos_penalty"])
def test_lm_server_beam_batch_matches_jax(artifacts, k, eos, alpha):
    jdir, pdir, model = artifacts
    prompts = _prompts(3, 5, seed=4)
    want = jsrv.LMServer(jdir).beam_batch(prompts, 8, k, eos_id=eos,
                                          length_penalty=alpha)
    srv = psrv.LMServer(pdir, device="cpu")
    got = srv.beam_batch(prompts, 8, k, eos_id=eos, length_penalty=alpha)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    assert srv.beam_stats["steps"] == 7
    # the live model's beam search gives the same hypotheses
    seq, _ = pbeam.beam_search(model, prompts, 8, k, eos_id=eos,
                               length_penalty=alpha)
    np.testing.assert_array_equal(seq[:, :, 5:].numpy(), got[0])
    if k == 1:
        greedy = srv.generate_batch(prompts, 8)
        np.testing.assert_array_equal(got[0][:, 0], greedy)


def test_beam_requests_match_jax(artifacts):
    jdir, pdir, _ = artifacts
    reqs = [{"tokens": [1, 2, 3], "n_tokens": 6, "beam_width": 3},
            {"tokens": [4, 5, 6], "n_tokens": 6, "beam_width": 3},
            {"tokens": [7, 8], "n_tokens": 5},
            {"tokens": [9, 1], "n_tokens": 5, "beam_width": 2, "eos": 5,
             "length_penalty": 0.5}]
    want = jsrv.LMServer(jdir).serve_requests(reqs)
    got = psrv.LMServer(pdir, device="cpu").serve_requests(reqs)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        assert g["batch"] == w["batch"]
        assert ("beams" in g) == ("beams" in w)
        if "beams" in w:
            assert g["beams"] == w["beams"]
            np.testing.assert_allclose(g["scores"], w["scores"], **TOL)
    with pytest.raises(ValueError, match="stop"):
        psrv.LMServer(pdir, device="cpu").serve_requests(
            [dict(reqs[0], stop=[[1]])])
