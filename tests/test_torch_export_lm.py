"""The port's LM export and loaders (tempo_tpu_torch/infer/export_lm.py)
against the JAX package's StableHLO artifacts, on the CPU.

One tiny JAX GPT, exported once per module through both packages: through
tempo_tpu's ``export_lm`` as it is, and through the port's after
``interop/jax_params.py::gpt_state_dict_from_jax``. The same inputs go
through both sets of loaded calls.

Tolerances: fp32 on both sides, two layers, logits of size ~1; the two
frameworks sum the matmuls in another order, so logits and logprobs are
held to atol 1e-5, rtol 1e-5; greedy tokens are compared exactly.

The JAX model applied live with ``decode_attn="pallas_interpret"`` runs
K3's and K4's Pallas kernels in interpret mode (as tests/test_paged.py
does); a decode chain of the port's loaded calls is held against it.

On the CPU nothing is captured; the launch tally that makes counts hold
across CUDA graph replays, and the decode counters that must exist before
a capture, are checked here by standing in for a capture in progress.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.infer import export_lm as jexp
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.infer import export_lm as pexp
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.ops import cuda_decode, launches

torch.set_num_threads(1)

CFG = dict(in_size=31, block_size=32, n_layer=2, n_head=2, n_embd=32)
CHUNK, PAGE = 4, 8
TOL = {"atol": 1e-5, "rtol": 1e-5}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """The JAX tiny LM, its StableHLO artifacts, and the port's export of
    the same weights."""
    root = tmp_path_factory.mktemp("export_lm")
    jcfg = jt.TransformerConfig(**CFG)
    model = jt.Transformer(jcfg)
    tokens = jax.random.randint(jax.random.PRNGKey(1), (2, 8), 0, 31)
    params = model.init(jax.random.PRNGKey(0), tokens)["params"]
    jdir = jexp.export_lm(params, jcfg, root / "jax", decode_chunk=CHUNK,
                          page_size=PAGE)
    pcfg = pt.TransformerConfig(**CFG)
    state = gpt_state_dict_from_jax(jax.device_get(params), pcfg)
    pdir = pexp.export_lm(state, pcfg, root / "torch", decode_chunk=CHUNK,
                          page_size=PAGE)
    return {"jcfg": jcfg, "model": model, "params": params, "jdir": jdir,
            "pcfg": pcfg, "state": state, "pdir": pdir, "root": root}


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float32)


def test_export_writes_the_jax_meta_and_the_config(lm):
    jmeta = json.loads((lm["jdir"] / "meta.json").read_text())
    pmeta = json.loads((lm["pdir"] / "meta.json").read_text())
    for key, value in jmeta.items():
        if key not in ("format", "platforms"):
            assert pmeta[key] == value, key
    assert pmeta["format"] == "torch state_dict"
    assert pt.TransformerConfig(**pmeta["config"]) == lm["pcfg"]
    weights = torch.load(lm["pdir"] / "weights.pt", weights_only=True)
    assert set(weights) == set(lm["state"])
    # a state dict that does not fit the config is refused before writing
    bad = dict(lm["state"])
    bad.pop("transformer.ln_f.weight")
    with pytest.raises(RuntimeError, match="ln_f"):
        pexp.export_lm(bad, lm["pcfg"], lm["root"] / "bad")
    assert not (lm["root"] / "bad").exists()


def test_loads_share_one_model(lm):
    pre, dec, meta = pexp.load_exported_lm(lm["pdir"], "cpu")
    pre2, dk, dkr = pexp.load_exported_decode_k(lm["pdir"], "cpu")
    paged = pexp.load_exported_paged(lm["pdir"], "cpu")
    assert dec.__self__ is dk.__self__ is paged[1].__self__
    assert meta["device"] == "cpu" and meta["decode_chunk"] == CHUNK
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pexp.load_exported_lm(lm["pdir"])


def test_prefill_and_decode_step_match_jax(lm):
    """Prefill logits, then a decode_step chain's logits (mirrors
    tests/test_export.py:56), at a batch and prompt length of its own."""
    jpre, jdec, _ = jexp.load_exported_lm(lm["jdir"])
    ppre, pdec, _ = pexp.load_exported_lm(lm["pdir"], "cpu")
    prompt = np.random.default_rng(2).integers(0, 31, (3, 5))
    jl, jc = jpre(jnp.asarray(prompt, jnp.int32))
    pl, pc = ppre(prompt)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
    tok = np.argmax(np.asarray(jl)[:, -1:], axis=-1)
    for pos in range(5, 12):
        jl, jc = jdec(jnp.asarray(tok, jnp.int32), jc, jnp.int32(pos))
        pl, pc = pdec(tok, pc, pos)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1:], axis=-1)


def test_greedy_decode_exported_matches_jax_and_the_window(lm):
    prompt = np.random.default_rng(3).integers(0, 31, (3, 5))
    got = pexp.greedy_decode_exported(lm["pdir"], prompt, 6, device="cpu")
    want = jexp.greedy_decode_exported(lm["jdir"], jnp.asarray(prompt), 6)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="serving window"):
        pexp.greedy_decode_exported(lm["pdir"], prompt, 28, device="cpu")
    np.testing.assert_array_equal(
        pexp.greedy_decode_exported(lm["pdir"], prompt, 0, device="cpu"),
        prompt)
    # a request-sized window is exact within it and refuses beyond it
    short = pexp.export_lm(lm["state"], lm["pcfg"], lm["root"] / "short",
                           max_seq=8)
    np.testing.assert_array_equal(
        pexp.greedy_decode_exported(short, prompt[:, :4], 4, device="cpu"),
        pexp.greedy_decode_exported(lm["pdir"], prompt[:, :4], 4,
                                    device="cpu"))
    with pytest.raises(ValueError, match="serving window"):
        pexp.greedy_decode_exported(short, prompt[:, :4], 5, device="cpu")


def _rows_state(lm, b=2):
    """A [b]-slot cache with rows prefilled to different lengths, through
    both packages' continuous calls."""
    jpre, jrows, jadmit, jmeta = jexp.load_exported_continuous(lm["jdir"])
    ppre, prows, padmit, pmeta = pexp.load_exported_continuous(lm["pdir"],
                                                               "cpu")
    jc = jexp.zero_cache(jmeta, b)
    pc = pexp.zero_cache(pmeta, b, "cpu")
    prompts = [[3, 1, 4, 1, 5], [9, 2, 6]]
    toks = []
    for s, p in enumerate(prompts):
        jl, jrow = jpre(jnp.asarray([p], jnp.int32))
        pl, prow = ppre(np.asarray([p]))
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        jc = jadmit(jc, jrow, jnp.int32(s))
        pc = padmit(pc, prow, s)
        toks.append(int(np.argmax(np.asarray(jl)[0, -1])))
    pos = np.asarray([len(p) for p in prompts], np.int32)
    return jc, pc, np.asarray(toks)[:, None], pos


@pytest.mark.parametrize("call", ["decode_rows", "decode_k_rows",
                                  "decode_k_sample"])
def test_per_row_calls_match_jax(lm, call):
    jc, pc, tok, pos = _rows_state(lm)
    if call == "decode_rows":
        _, jrows, _, _ = jexp.load_exported_continuous(lm["jdir"])
        _, prows, _, _ = pexp.load_exported_continuous(lm["pdir"], "cpu")
        jl, jc = jrows(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos))
        pl, pc = prows(tok, pc, pos)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        return
    if call == "decode_k_rows":
        _, jk, _ = jexp.load_exported_decode_k(lm["jdir"])
        _, pk, k = pexp.load_exported_decode_k(lm["pdir"], "cpu")
        jt_, jlp, jc = jk(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos))
        pt_, plp, pc = pk(tok, pc, pos)
    else:
        # temperature 0 rows take the argmax: the only draws both
        # packages make the same
        jk, _ = jexp.load_exported_decode_k_sample(lm["jdir"])
        pk, k = pexp.load_exported_decode_k_sample(lm["pdir"], "cpu")
        zeros = np.zeros(2, np.float32)
        jt_, jlp, jc = jk(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos),
                          jnp.zeros((2, 2), jnp.uint32), jnp.asarray(zeros),
                          jnp.zeros(2, jnp.int32), jnp.ones(2, jnp.float32))
        pt_, plp, pc = pk(tok, pc, pos, [7, 9], zeros, [0, 0], [1.0, 1.0])
    assert k == CHUNK and tuple(pt_.shape) == (2, CHUNK)
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt_))
    np.testing.assert_allclose(_np(plp), np.asarray(jlp), **TOL)
    for (jk_, jv_), (pk_, pv_) in zip(jc, pc):
        np.testing.assert_allclose(_np(pk_), np.asarray(jk_), **TOL)
        np.testing.assert_allclose(_np(pv_), np.asarray(jv_), **TOL)


def test_decode_k_equals_per_token_decode_step(lm):
    """The fused K-step call at a scalar position emits the per-token
    decode_step chain and its raw-model logprobs."""
    pre, dec, _ = pexp.load_exported_lm(lm["pdir"], "cpu")
    dk, _, k = pexp.load_exported_decode_k(lm["pdir"], "cpu")
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
    logits, cache = pre(prompt)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    fused_toks, fused_lps, _ = dk(tok, pre(prompt)[1], 5)
    toks, lps = [], []
    for pos in range(5, 5 + k):
        logits, cache = dec(tok, cache, pos)
        x = logits[:, -1].float()
        tok = torch.argmax(x, dim=-1, keepdim=True)
        toks.append(tok)
        lps.append(torch.log_softmax(x, -1).gather(-1, tok))
    assert torch.equal(fused_toks, torch.cat(toks, 1))
    np.testing.assert_allclose(_np(fused_lps), _np(torch.cat(lps, 1)),
                               rtol=1e-6, atol=1e-6)


def _paged_state(lm, table):
    """Two rows prefilled through both packages' paged calls into pools
    of 9 pages with a shuffled table."""
    jpre, jdp, jadm, _ = jexp.load_exported_paged(lm["jdir"])
    ppre, pdp, padm, _ = pexp.load_exported_paged(lm["pdir"], "cpu")
    jbase = jt.init_paged_cache(lm["jcfg"], 2, 9, PAGE, window=32)
    jc = tuple((pk, pv, jnp.asarray(table)) for pk, pv, _ in jbase)
    pbase = pt.init_paged_cache(lm["pcfg"], 2, 9, PAGE, window=32,
                                device="cpu")
    ptab = torch.from_numpy(table)
    pc = tuple((pk, pv, ptab) for pk, pv, _ in pbase)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6, 5], [2, 7, 1]]
    toks = []
    for s, p in enumerate(prompts):
        jl, jrow = jpre(jnp.asarray([p], jnp.int32))
        _, prow = ppre(np.asarray([p]))
        jc = jadm(jc, jrow, jnp.asarray(table[s]))
        pc = padm(pc, prow, table[s])
        toks.append(int(np.argmax(np.asarray(jl)[0, -1])))
    return jc, pc, np.asarray(toks)[:, None], np.asarray([9, 3], np.int32)


def test_paged_calls_match_jax(lm):
    table = np.asarray([[4, 2, 7, 1], [6, 3, 5, 8]], np.int32)
    jc, pc, tok, pos = _paged_state(lm, table)
    _, jdp, _, _ = jexp.load_exported_paged(lm["jdir"])
    _, pdp, _, _ = pexp.load_exported_paged(lm["pdir"], "cpu")
    jl, jc2 = jdp(jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos))
    pl, pc2 = pdp(tok, pc, pos)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
    jk, _, _ = jexp.load_exported_paged_k(lm["jdir"])
    pk, _, _ = pexp.load_exported_paged_k(lm["pdir"], "cpu")
    jt_, jlp, _ = jk(jnp.asarray(tok, jnp.int32), jc2, jnp.asarray(pos + 1))
    pt_, plp, _ = pk(tok, pc2, pos + 1)
    np.testing.assert_array_equal(pt_.numpy(), np.asarray(jt_))
    np.testing.assert_allclose(_np(plp), np.asarray(jlp), **TOL)
    # extend_paged: a 3-token block through the table
    jext = jexp.load_exported_extend_paged(lm["jdir"])
    pext = pexp.load_exported_extend_paged(lm["pdir"], "cpu")
    block = np.asarray([[1, 2, 3], [4, 5, 6]])
    jl, _ = jext(jnp.asarray(block, jnp.int32), jc, jnp.asarray(pos))
    pl, _ = pext(block, pc, pos)
    np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["K3", "K4"])
def test_decode_chain_matches_pallas_interpret(lm, paged):
    """The JAX model applied live with decode_attn='pallas_interpret' (K3
    or K4's Pallas kernel, interpreted) against the port's loaded decode
    calls over the same cache, a greedy chain of 6 steps."""
    model_k = jt.Transformer(dataclasses.replace(
        lm["jcfg"], decode_attn="pallas_interpret"))
    params = {"params": lm["params"]}
    if paged:
        table = np.asarray([[4, 2, 7, 1], [6, 3, 5, 8]], np.int32)
        jc, pc, tok, pos = _paged_state(lm, table)
        _, step, _, _ = pexp.load_exported_paged(lm["pdir"], "cpu")
    else:
        jc, pc, tok, pos = _rows_state(lm)
        _, step, _, _ = pexp.load_exported_continuous(lm["pdir"], "cpu")
    for _ in range(6):
        jl, jc = model_k.apply(params, jnp.asarray(tok, jnp.int32),
                               cache=jc, input_pos=jnp.asarray(pos))
        pl, pc = step(tok, pc, pos)
        np.testing.assert_allclose(_np(pl), np.asarray(jl), **TOL)
        tok = np.argmax(np.asarray(jl)[:, -1:], axis=-1)
        pos = pos + 1


def test_missing_calls_raise_file_not_found(lm):
    bare = pexp.export_lm(lm["state"], lm["pcfg"], lm["root"] / "bare",
                          decode_chunk=0)
    for loader in (pexp.load_exported_decode_k,
                   pexp.load_exported_decode_k_sample,
                   pexp.load_exported_paged, pexp.load_exported_extend_paged,
                   pexp.load_exported_paged_k):
        with pytest.raises(FileNotFoundError):
            loader(bare, "cpu")
    with pytest.raises(ValueError, match="not an export of this package"):
        pexp.load_exported_lm(lm["jdir"], "cpu")


def test_zero_cache(lm):
    meta = json.loads((lm["pdir"] / "meta.json").read_text())
    cache = pexp.zero_cache(meta, 3, "cpu")
    assert len(cache) == 2
    assert all(t.shape == (3, 32, 2, 16) and t.dtype == torch.float32
               and not t.any() for layer in cache for t in layer)


def test_launches_recorded_in_a_capture_count_at_each_replay(monkeypatch):
    counts = {"k": 0}
    launches.count(counts, "k")
    assert counts["k"] == 1
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with launches.tally() as tally:
        launches.count(counts, "k")
        launches.count(counts, "k")
    assert counts["k"] == 1  # recorded, not launched
    for _ in range(3):
        launches.replay(tally)
    assert counts["k"] == 7


def test_decode_counters_are_made_before_a_capture(monkeypatch):
    dev = torch.device("cpu")
    capturing = [False]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    made = cuda_decode._counters(dev, 12345, 8)
    assert made.numel() >= 8 and not made.any()
    assert cuda_decode._counters(dev, 12345, 8) is made
    capturing[0] = True
    with pytest.raises(RuntimeError, match="warm-up"):
        cuda_decode._counters(dev, 54321, 8)
    with pytest.raises(RuntimeError, match="warm-up"):
        cuda_decode._counters(dev, 12345, made.numel() + 1)
    capturing[0] = False
    # a grown buffer keeps the one it replaces alive (a graph may hold it)
    grown = cuda_decode._counters(dev, 12345, made.numel() + 1)
    assert grown is not made and any(r is made for r in cuda_decode._RETIRED)
    del cuda_decode._COUNTERS[(dev, 12345)]


def test_lazy_setup_refused_inside_a_capture(monkeypatch):
    """A parameter's cast and the RoPE table are made by the warm-up call;
    inside a capture they would live in the graph's memory, so a capture
    that finds them missing raises."""
    cfg = pt.TransformerConfig(**dict(CFG, rope=True, pos_embed=False,
                                      compute_dtype="bfloat16"))
    model = pt.Transformer(cfg, device="cpu")
    with torch.no_grad():
        model(torch.zeros(1, 3, dtype=torch.long))  # the warm-up: all made
    monkeypatch.setattr(pt, "_capturing", lambda device: True)
    with torch.no_grad():
        model(torch.zeros(1, 3, dtype=torch.long))  # nothing new to make
    attn = model.transformer["h"][0].attn
    attn._rope = None
    with pytest.raises(RuntimeError, match="RoPE table"):
        attn._rope_table(torch.device("cpu"))
    model.__dict__.pop("_cast_cache")
    with pytest.raises(RuntimeError, match="cast"), torch.no_grad():
        pt.cast_param(model, model.transformer["wte"].weight, torch.bfloat16)
