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
    assert pmeta["format"] == "torch.export"
    assert pmeta["devices"] == ["cpu", "cuda"]
    # one program for each of JAX's, under its name
    jax_programs = {p.stem for p in lm["jdir"].glob("*.stablehlo")}
    assert set(pmeta["programs"]) == jax_programs and len(jax_programs) == 14
    assert {p.stem for p in lm["pdir"].glob("*.pt2")} == jax_programs
    assert set(pmeta["export_seconds"]) == jax_programs
    assert pt.TransformerConfig(**pmeta["config"]) == lm["pcfg"]
    weights = torch.load(lm["pdir"] / "weights.pt", weights_only=True)
    assert set(weights) == set(lm["state"]) == set(pmeta["weights"])
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


# ------------------------------------------------- each program against JAX

def _jax_program(lm, name):
    from jax import export as jexport

    return jax.jit(jexport.deserialize(
        (lm["jdir"] / f"{name}.stablehlo").read_bytes()).call)


def _port_program(lm, name):
    """The port's loaded call of program ``name``, through its loader."""
    d = lm["pdir"]
    return {
        "prefill": lambda: pexp.load_exported_lm(d, "cpu")[0],
        "decode_step": lambda: pexp.load_exported_lm(d, "cpu")[1],
        "decode_rows": lambda: pexp.load_exported_continuous(d, "cpu")[1],
        "admit": lambda: pexp.load_exported_continuous(d, "cpu")[2],
        "extend": lambda: pexp.load_exported_speculative(d, "cpu")[1],
        "extend_rows": lambda: pexp.load_exported_extend_rows(d, "cpu"),
        "decode_k": lambda: pexp.load_exported_decode_k(d, "cpu")[0],
        "decode_k_rows": lambda: pexp.load_exported_decode_k(d, "cpu")[1],
        "decode_k_sample":
            lambda: pexp.load_exported_decode_k_sample(d, "cpu")[0],
        "decode_paged": lambda: pexp.load_exported_paged(d, "cpu")[1],
        "admit_paged": lambda: pexp.load_exported_paged(d, "cpu")[2],
        "extend_paged": lambda: pexp.load_exported_extend_paged(d, "cpu"),
        "decode_paged_k": lambda: pexp.load_exported_paged_k(d, "cpu")[0],
        "decode_paged_k_sample":
            lambda: pexp.load_exported_paged_k(d, "cpu")[1],
    }[name]()


def _close_tree(got, want):
    """Tensors (or nested tuples of them) of the port against JAX's arrays
    at TOL; integer outputs exactly."""
    if isinstance(got, torch.Tensor):
        want = np.asarray(want)
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(_np(got), want.astype(np.float32),
                                       **TOL)
        return
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close_tree(g, w)


def _state(lm, b: int, rows: bool, paged: bool):
    """Both packages' caches with b rows prefilled through their own
    prefill and admit programs: prompts of one length (scalar position 6)
    or of lengths 6, 3, 9 (per-row positions); paged into a pool of
    4b + 3 pages (the programs were traced with 3) through a shuffled
    table. Returns (jax cache, port cache, tok [b, 1], pos)."""
    rng = np.random.default_rng(10 + b)
    lens = [6, 3, 9][:b] if rows else [6] * b
    jpre, ppre = _jax_program(lm, "prefill"), _port_program(lm, "prefill")
    meta = json.loads((lm["pdir"] / "meta.json").read_text())
    if paged:
        n_pages = 4 * b + 3
        table = (1 + rng.permutation(n_pages - 1)[:4 * b]).reshape(b, 4)
        table = table.astype(np.int32)
        jc = tuple((pk, pv, jnp.asarray(table)) for pk, pv, _ in
                   jt.init_paged_cache(lm["jcfg"], b, n_pages, PAGE,
                                       window=32))
        ptab = torch.from_numpy(table)
        pc = tuple((pk, pv, ptab) for pk, pv, _ in pt.init_paged_cache(
            lm["pcfg"], b, n_pages, PAGE, window=32, device="cpu"))
        jadm, padm = (_jax_program(lm, "admit_paged"),
                      _port_program(lm, "admit_paged"))
        where = [table[r] for r in range(b)]
    else:
        jc = jexp.zero_cache(meta, b)
        pc = pexp.zero_cache(meta, b, "cpu")
        jadm, padm = _jax_program(lm, "admit"), _port_program(lm, "admit")
        where = [np.int32(r) for r in range(b)]
    toks = []
    for r, n in enumerate(lens):
        prompt = rng.integers(0, 31, (1, n))
        jl, jrow = jpre(jnp.asarray(prompt, jnp.int32))
        _, prow = ppre(prompt)
        jc = jadm(jc, jrow, jnp.asarray(where[r]))
        pc = padm(pc, prow, where[r])
        toks.append(int(np.argmax(np.asarray(jl)[0, -1])))
    pos = np.asarray(lens, np.int32) if rows else np.int32(6)
    return jc, pc, np.asarray(toks)[:, None], pos


@pytest.mark.parametrize("name", pexp.program_names(
    {"decode_chunk": CHUNK, "page_size": PAGE}))
def test_each_program_matches_jax(lm, name):
    """Each loaded program against JAX's deserialized StableHLO program of
    the same name at batches 1 and 3: outputs and the caches afterwards at
    TOL, tokens exactly; prefill at t = 1 and t = max_seq; the paged
    programs over a pool of another page count than the traced one; the
    sampled programs with temperature-0 rows (the only draws both packages
    make the same)."""
    jfn, pfn = _jax_program(lm, name), _port_program(lm, name)
    for b in (1, 3):
        if name == "prefill":
            for t in (1, 32):
                prompt = np.random.default_rng(t + b).integers(0, 31, (b, t))
                _close_tree(pfn(prompt), jfn(jnp.asarray(prompt, jnp.int32)))
            continue
        paged = "paged" in name
        rows = paged or name.endswith(("_rows", "_sample"))
        if name in ("admit", "admit_paged"):
            jc, pc, _, _ = _state(lm, b, rows, paged)
            prompt = np.random.default_rng(b).integers(0, 31, (1, 7))
            _, jrow = _jax_program(lm, "prefill")(jnp.asarray(prompt,
                                                              jnp.int32))
            _, prow = _port_program(lm, "prefill")(prompt)
            if paged:
                where = np.asarray(jc[0][2])[b - 1][::-1].copy()
            else:
                where = np.int32(b - 1)
            _close_tree(pfn(pc, prow, where), jfn(jc, jrow,
                                                 jnp.asarray(where)))
            continue
        jc, pc, tok, pos = _state(lm, b, rows, paged)
        if name.startswith("extend"):
            tok = np.random.default_rng(b).integers(0, 31, (b, 3))
        args_j = [jnp.asarray(tok, jnp.int32), jc, jnp.asarray(pos)]
        args_p = [tok, pc, pos]
        if name.endswith("_sample"):
            args_j += [jnp.zeros((b, 2), jnp.uint32), jnp.zeros(b),
                       jnp.zeros(b, jnp.int32), jnp.ones(b)]
            args_p += [np.arange(b), np.zeros(b), np.zeros(b, np.int64),
                       np.ones(b)]
        _close_tree(pfn(*args_p), jfn(*args_j))


def test_programs_by_export_options(lm):
    """6 programs always, 3 more with decode_chunk > 0, 3 more with
    page_size > 0, 2 more with both (the JAX package's set)."""
    names = {(c, p): pexp.program_names({"decode_chunk": c, "page_size": p})
             for c in (0, 4) for p in (0, 8)}
    assert [len(names[k]) for k in ((0, 0), (4, 0), (0, 8), (4, 8))] == [
        6, 9, 9, 14]
    assert set(names[0, 0]) == set(pexp.PROGRAMS)
    assert set(names[4, 8]) == set(
        pexp.PROGRAMS + pexp.CHUNK_PROGRAMS + pexp.PAGED_PROGRAMS
        + pexp.PAGED_CHUNK_PROGRAMS)
    meta = json.loads((lm["pdir"] / "meta.json").read_text())
    assert tuple(meta["programs"]) == names[CHUNK, PAGE]


def _graph_of(path):
    return torch.export.load(path).graph


def test_programs_hold_the_ops_and_no_weights(lm):
    """Every program holds no weight (the weights are its first input, read
    from weights.pt once); the single-token programs reach K3/K4 through
    the ops, once a layer, with no plain-attention einsum; the block
    programs (t > 1) keep the masked einsum, as the JAX model does."""
    n_layer = lm["pcfg"].n_layer
    for path in sorted(lm["pdir"].glob("*.pt2")):
        program = torch.export.load(path)
        assert not program.state_dict and not program.constants, path.stem
        assert program.example_inputs is None, path.stem
        targets = [str(n.target) for n in program.graph.nodes
                   if n.op == "call_function"]
        dense = targets.count("tempo.decode_attention.default")
        paged = targets.count("tempo.paged_decode_attention.default")
        einsum = targets.count("aten.einsum.default")
        name = path.stem
        if name.startswith("decode_paged"):
            assert (dense, paged, einsum) == (0, n_layer, 0), name
        elif name.startswith("decode"):
            assert (dense, paged, einsum) == (n_layer, 0, 0), name
        elif name.startswith(("extend", "prefill")):
            assert (dense, paged, einsum) == (0, 0, 2 * n_layer), name


def test_weights_are_held_once(lm):
    """weights.pt holds each weight once, as trained in fp32 here, in the
    programs' order; the directory is the weights' bytes plus weightless
    programs; every loader of the directory shares one copy."""
    meta = json.loads((lm["pdir"] / "meta.json").read_text())
    weights = torch.load(lm["pdir"] / "weights.pt", weights_only=True)
    assert list(weights) == meta["weights"]
    for k, w in weights.items():
        assert torch.equal(w, lm["state"][k].float()), k
    nbytes = sum(w.numel() * w.element_size() for w in weights.values())
    assert (lm["pdir"] / "weights.pt").stat().st_size <= 1.1 * nbytes + 4096
    s = pexp._load(lm["pdir"], "cpu")
    for name in meta["programs"]:
        fn = s.program(name)
        bound = fn.args[0]
        want = () if name in ("admit", "admit_paged") else s.program.weights
        assert bound is want or bound == want == (), name


def test_bf16_programs_hold_no_cast_of_a_weight(lm):
    """A bf16 serving copy traced: no weight input feeds a cast (the
    Linear weights and the embedding tables are bf16 already, the
    LayerNorms' fp32 as their use reads them), and the bf16 program
    equals the live bf16 model bitwise on the CPU."""
    cfg = dataclasses.replace(lm["pcfg"], compute_dtype="bfloat16")
    model = pt.serving_copy(lm["state"], cfg)
    meta = pexp._meta(cfg, 32, CHUNK, PAGE, pexp.FORMAT)
    casts = {"aten.to.dtype", "aten._to_copy.default", "aten.to.dtype_layout"}
    n_weights = len(list(model.named_parameters()))
    for name in ("decode_step", "extend_rows"):
        program = pexp.trace_program(name, model, meta)
        weights = {s.arg.name for s in program.graph_signature.input_specs
                   if s.arg.name.startswith("weights")}
        assert len(weights) == n_weights
        for node in program.graph.nodes:
            if node.op == "placeholder" and node.name in weights:
                users = {str(u.target) for u in node.users}
                assert not users & casts, (node, users)
    live = pt.Transformer(cfg, device="cpu")
    live.load_state_dict(lm["state"])
    step = pexp.trace_program("decode_rows", model, meta).module()
    ws = tuple(p for _, p in model.named_parameters())
    tok = torch.tensor([[3], [7]])
    pos = torch.tensor([4, 9], dtype=torch.int32)
    c1 = pt.init_cache(cfg, 2, torch.bfloat16, cache_len=32, device="cpu")
    c2 = tuple((a.clone(), b.clone()) for a, b in c1)
    with torch.no_grad():
        got = step(ws, tok, c1, pos)
        want = live(tok, cache=c2, input_pos=pos)[0]
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for x, y in zip(c1, c2)
               for a, b in zip(x, y))


def test_loading_needs_no_model_code(lm):
    """A fresh process loads every loader of the directory and decodes
    greedily; no tempo_tpu_torch.nn module is imported, and the tokens
    equal JAX's greedy decode over its own artifacts."""
    import subprocess
    import sys

    prompt = [[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]]
    code = (
        "import json, sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from tempo_tpu_torch.infer import export_lm as e\n"
        f"d = {str(lm['pdir'])!r}\n"
        "for load in (e.load_exported_lm, e.load_exported_continuous,\n"
        "             e.load_exported_extend_rows, e.load_exported_decode_k,\n"
        "             e.load_exported_decode_k_sample,\n"
        "             e.load_exported_paged, e.load_exported_extend_paged,\n"
        "             e.load_exported_paged_k, e.load_exported_speculative):\n"
        "    load(d, 'cpu')\n"
        f"out = e.greedy_decode_exported(d, {prompt!r}, 6, device='cpu')\n"
        "nn = sorted(m for m in sys.modules\n"
        "            if m.startswith('tempo_tpu_torch.nn'))\n"
        "print(json.dumps({'tokens': out.tolist(), 'nn': nn}))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["nn"] == []
    want = jexp.greedy_decode_exported(lm["jdir"], jnp.asarray(prompt), 6)
    np.testing.assert_array_equal(np.asarray(got["tokens"]), want)


def test_a_state_dict_directory_raises(lm, tmp_path):
    """The earlier artifact format (a state dict and a config) is refused
    with a clear error; the loader never rebuilds a model."""
    meta = json.loads((lm["pdir"] / "meta.json").read_text())
    meta["format"] = "torch state_dict"
    (tmp_path / "meta.json").write_text(json.dumps(meta))
    torch.save(lm["state"], tmp_path / "weights.pt")
    with pytest.raises(ValueError, match="export it again"):
        pexp.load_exported_lm(tmp_path, "cpu")


def test_loaded_calls_check_their_inputs(lm):
    """The loaded programs skip torch.export's per-call input checks; the
    surface checks what a program takes instead: a prompt within the
    window, the cache's layers, shapes, type and block table."""
    pre, dec, meta = pexp.load_exported_lm(lm["pdir"], "cpu")
    ext = pexp.load_exported_extend_paged(lm["pdir"], "cpu")
    with pytest.raises(ValueError, match="prefill"):
        pre(np.zeros((1, 33), np.int64))
    short = dict(meta, max_seq=16)
    with pytest.raises(ValueError, match="cache tensors"):
        dec([[1]], pexp.zero_cache(short, 1, "cpu"), 3)
    with pytest.raises(ValueError, match="cache layers"):
        dec([[1]], pexp.zero_cache(meta, 1, "cpu")[:1], 3)
    with pytest.raises(ValueError, match="cache tensors"):
        dec([[1], [2]], pexp.zero_cache(meta, 1, "cpu"), 3)
    base = pt.init_paged_cache(lm["pcfg"], 2, 9, PAGE, window=32,
                               device="cpu")
    wrong = tuple((pk, pv, t.long()) for pk, pv, t in base)
    with pytest.raises(ValueError, match="block table"):
        ext(np.zeros((2, 3), np.int64), wrong, np.asarray([1, 2]))
    logits, _ = ext(np.zeros((2, 3), np.int64), base, np.asarray([1, 2]))
    assert logits.shape == (2, 3, 31)
