"""The port's speculative decoding (tempo_tpu_torch/infer/serving.py
SpeculativeLMServer, SpecLMEngine under ContinuousLMServer, and the paged
rounds of infer/paged.py) against the JAX package's same servers, on the
CPU.

A tiny JAX target (2 layers, 32 wide) and a smaller draft (1 layer, 16
wide) share a 31-token vocabulary and a 32-token window; both are exported
once per module through both packages, the port's after
``interop/jax_params.py::gpt_state_dict_from_jax``. Greedy streams and the
``rounds`` / ``drafted`` / ``accepted`` counts must equal JAX's exactly;
logprobs, fp32 on both sides with the matmuls summed in another order,
within atol 1e-5, rtol 1e-5. ``policy_probs`` and ``speculative_accept``
equal JAX's within 1e-12 (float64 numpy on both sides; the accept decision
exactly). Sampled streams cannot equal JAX's threefry stream: they are held
equal to the port's own target-only continuous server, token for token.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tempo_tpu.infer import export_lm as jexp
from tempo_tpu.infer import serving as jsrv
from tempo_tpu.infer.paged import PagedLMServer as JaxPagedLMServer
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.infer import export_lm as pexp
from tempo_tpu_torch.infer import serving as psrv
from tempo_tpu_torch.infer.paged import PagedLMServer
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

TARGET = dict(in_size=31, block_size=32, n_layer=2, n_head=2, n_embd=32)
DRAFT = dict(in_size=31, block_size=32, n_layer=1, n_head=2, n_embd=16)
CHUNK, PAGE = 4, 8
TOL = {"atol": 1e-5, "rtol": 1e-5}
KS = (1, 4)
KINDS = ("speculative", "continuous", "paged")

# tests/test_paged.py:152-180's workload made greedy, plus the lengths of
# tests/test_export.py:1126 (n_tokens 1 included)
GREEDY = [
    {"tokens": [3, 1, 4, 1, 5], "n_tokens": 12},
    {"tokens": [9, 2, 6], "n_tokens": 9},
    {"tokens": [7, 7], "n_tokens": 11},
    {"tokens": [5], "n_tokens": 8},
    {"tokens": [7], "n_tokens": 1},
    {"tokens": [2, 7, 7, 1], "n_tokens": 7},
]
SAMPLED = [
    {"tokens": [9, 2, 6], "n_tokens": 9, "temperature": 1.0, "top_k": 5,
     "seed": 3},
    {"tokens": [5], "n_tokens": 8, "temperature": 0.7, "top_p": 0.9,
     "seed": 11},
    {"tokens": [3, 1, 4, 1, 5], "n_tokens": 12},
    {"tokens": [7, 7], "n_tokens": 11, "temperature": 1.3, "seed": 5},
]
LOGPROBS = [dict(GREEDY[0], logprobs=True), dict(GREEDY[2], logprobs=True)]


def _export(root, name, cfg, key, **kw):
    jcfg = jt.TransformerConfig(**cfg)
    tokens = jax.random.randint(jax.random.PRNGKey(key + 1), (2, 8), 0, 31)
    params = jt.Transformer(jcfg).init(jax.random.PRNGKey(key),
                                       tokens)["params"]
    jdir = jexp.export_lm(params, jcfg, root / f"jax_{name}", **kw)
    pcfg = pt.TransformerConfig(**cfg)
    state = gpt_state_dict_from_jax(jax.device_get(params), pcfg)
    pdir = pexp.export_lm(state, pcfg, root / f"torch_{name}", **kw)
    return jdir, pdir


def _jax_server(kind, target, draft, k):
    if kind == "speculative":
        return jsrv.SpeculativeLMServer(target, draft, k_draft=k)
    if kind == "continuous":
        return jsrv.ContinuousLMServer(target, n_slots=2, draft_dir=draft,
                                       k_draft=k)
    return JaxPagedLMServer(target, n_slots=2, draft_dir=draft, k_draft=k)


def _server(kind, target, draft, k, **kw):
    if kind == "speculative":
        return psrv.SpeculativeLMServer(target, draft, k_draft=k,
                                        device="cpu", **kw)
    if kind == "continuous":
        return psrv.ContinuousLMServer(target, n_slots=2, draft_dir=draft,
                                       k_draft=k, device="cpu", **kw)
    return PagedLMServer(target, n_slots=2, draft_dir=draft, k_draft=k,
                         device="cpu", **kw)


def _counts(stats):
    return {k: stats[k] for k in ("rounds", "drafted", "accepted")}


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    """Both exports of target and draft, and the JAX servers' greedy
    responses and round counts for every kind and k_draft in KS."""
    root = tmp_path_factory.mktemp("speculative")
    jt_dir, pt_dir = _export(root, "target", TARGET, 0, decode_chunk=CHUNK,
                             page_size=PAGE)
    jd_dir, pd_dir = _export(root, "draft", DRAFT, 4, decode_chunk=CHUNK)
    want = {}
    for kind in KINDS:
        for k in KS:
            srv = _jax_server(kind, jt_dir, jd_dir, k)
            resp = srv.serve(GREEDY + LOGPROBS)
            want[kind, k] = (resp, _counts(srv.last_stats))
    target_only = [r["tokens"] for r in
                   jsrv.ContinuousLMServer(jt_dir, n_slots=2).serve(GREEDY)]
    return {"jt": jt_dir, "pt": pt_dir, "jd": jd_dir, "pd": pd_dir,
            "want": want, "target_only": target_only}


def _tokens(responses):
    return [r["tokens"] for r in responses]


def test_policy_probs_and_speculative_accept_match_jax():
    """The numpy references equal JAX's on seeded inputs: the policy's
    probability vector at several temperatures and truncations, and the
    accept decision and residual at several uniforms."""
    rng = np.random.default_rng(0)
    for _ in range(6):
        logits = rng.normal(size=23) * 2.0
        for temp, top_k, top_p in ((1.0, None, None), (0.7, 5, None),
                                   (1.3, None, 0.8), (0.5, 8, 0.9)):
            np.testing.assert_allclose(
                psrv.policy_probs(logits, temp, top_k, top_p),
                jsrv.policy_probs(logits, temp, top_k, top_p),
                rtol=0, atol=1e-12)
        p = rng.dirichlet(np.ones(23) * 0.5)
        q = rng.dirichlet(np.ones(23) * 0.5)
        q[3] = 0.0
        q /= q.sum()
        for d in (0, 3, 7, 22):
            for u in (0.0, 0.25, 0.5, 0.999):
                ok, res = psrv.speculative_accept(p, q, d, u)
                jok, jres = jsrv.speculative_accept(p, q, d, u)
                assert ok == jok
                if res is None:
                    assert jres is None
                else:
                    np.testing.assert_allclose(res, jres, rtol=0,
                                               atol=1e-12)


def test_speculative_accept_preserves_the_target_distribution():
    """tests/test_export.py:973 on the port's copy: marginalized over
    draft ~ q the emitted token is exactly ~ p, checked analytically with
    the helper's own acceptance boundary and residual."""
    rng = np.random.default_rng(0)
    for trial in range(5):
        v = 7
        p = rng.dirichlet(np.ones(v) * (0.3 + trial))
        q = rng.dirichlet(np.ones(v) * (0.3 + trial))
        if trial == 4:
            q[2] = 0.0  # a token the draft can never propose
            q /= q.sum()
        marginal = np.zeros(v)
        for d in range(v):
            a_d = min(1.0, p[d] / q[d]) if q[d] > 0 else 0.0
            if q[d] > 0 and a_d > 1e-9:
                assert psrv.speculative_accept(p, q, d, a_d - 1e-12)[0]
            if a_d < 1.0:
                assert not psrv.speculative_accept(p, q, d, a_d + 1e-12)[0]
            _, residual = psrv.speculative_accept(p, q, d, 1.0)
            marginal[d] += q[d] * a_d
            marginal += q[d] * (1.0 - a_d) * residual
        np.testing.assert_allclose(marginal, p, atol=1e-12)


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("kind", KINDS)
def test_greedy_streams_and_counts_match_jax(lm, kind, k):
    """Each speculative server's greedy tokens equal the JAX package's same
    server token for token, and so do its rounds, drafted and accepted
    counts; the streams are target-only decode's."""
    want, counts = lm["want"][kind, k]
    srv = _server(kind, lm["pt"], lm["pd"], k)
    got = srv.serve(GREEDY + LOGPROBS)
    assert _tokens(got) == _tokens(want)
    assert _tokens(got)[:len(GREEDY)] == lm["target_only"]
    assert _counts(srv.last_stats) == counts
    assert counts["rounds"] > 0 and counts["drafted"] > 0
    for g, w in zip(got[len(GREEDY):], want[len(GREEDY):]):
        assert len(g["logprobs"]) == len(g["tokens"])
        np.testing.assert_allclose(g["logprobs"], w["logprobs"], **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_sampled_streams_equal_target_only(lm, kind):
    """Sampled requests draw the canonical stream: the same tokens as the
    port's target-only continuous server, at k_draft 1 and 4, and really
    sampled."""
    want = _tokens(psrv.ContinuousLMServer(lm["pt"], n_slots=2,
                                           device="cpu").serve(SAMPLED))
    for k in KS:
        assert _tokens(_server(kind, lm["pt"], lm["pd"], k).serve(
            SAMPLED)) == want
    greedy = psrv.ContinuousLMServer(lm["pt"], device="cpu").serve(
        [dict(r, temperature=0.0) for r in SAMPLED])
    assert _tokens(greedy)[3] != want[3]


@pytest.mark.parametrize("kind", KINDS)
def test_self_draft_accepts_everything(lm, kind):
    """A self-draft (the target's own directory: one loaded model, separate
    caches) proposes the canonical draws, greedy and sampled, so every
    draft is accepted and the streams stay target-only decode's."""
    srv = _server(kind, lm["pt"], lm["pt"], 3)
    reqs = GREEDY + SAMPLED
    got = srv.serve(reqs)
    want = psrv.ContinuousLMServer(lm["pt"], n_slots=2,
                                   device="cpu").serve(reqs)
    assert _tokens(got) == _tokens(want)
    assert srv.last_stats["accepted"] == srv.last_stats["drafted"] > 0


def test_tight_paged_pool_preempts_without_changing_outputs(lm):
    """Two long rows cannot hold their peak pages together on 4 usable
    pages: the speculative paged server preempts, and its outputs are the
    target-only ones (the requeued request replays its canonical
    stream)."""
    reqs = [{"tokens": [3, 1, 4, 1, 5], "n_tokens": 12},
            {"tokens": [9, 2, 6, 5, 3, 5, 8], "n_tokens": 16,
             "temperature": 0.7, "seed": 5}]
    want = psrv.ContinuousLMServer(lm["pt"], n_slots=2,
                                   device="cpu").serve(reqs)
    jax_tight = JaxPagedLMServer(lm["jt"], n_slots=2, n_pages=5,
                                 draft_dir=lm["jd"], k_draft=3)
    jax_tight.serve([reqs[0]])
    for k in (1, 3):
        srv = _server("paged", lm["pt"], lm["pd"], k, n_pages=5)
        assert _tokens(srv.serve(reqs)) == _tokens(want)
        assert srv.last_stats["preemptions"] > 0
    srv = _server("paged", lm["pt"], lm["pd"], 3, n_pages=5)
    srv.serve([reqs[0]])
    assert _counts(srv.last_stats) == _counts(jax_tight.last_stats)


@pytest.mark.parametrize("kind", KINDS)
def test_eos_and_stop_compose_with_the_rounds(lm, kind):
    """eos (kept) and a stop sequence (trimmed) end a request inside a
    round exactly where target-only decode does."""
    base = lm["target_only"][0]
    eos = base[5]
    first = base.index(eos) + 1
    stop = base[3:5]
    i0 = next(i for i in range(len(base) - 1) if base[i:i + 2] == stop)
    srv = _server(kind, lm["pt"], lm["pd"], 4)
    r_eos, r_stop = srv.serve([dict(GREEDY[0], eos=eos),
                               dict(GREEDY[0], stop=stop)])
    assert r_eos["tokens"] == base[:first] and r_eos["stopped_early"]
    assert r_stop["tokens"] == base[:i0] and r_stop["stopped_early"]


def test_what_cannot_be_served_is_refused(lm):
    """k_decode with k_draft, a draft of another vocabulary, and a request
    whose draft slack passes the window raise ValueError; the batch-1
    server needs no slack."""
    for cls in (psrv.ContinuousLMServer, PagedLMServer):
        with pytest.raises(ValueError, match="alternative decode loops"):
            cls(lm["pt"], draft_dir=lm["pd"], k_draft=2, k_decode=CHUNK,
                device="cpu")
    other = pexp.export_lm(
        pt.Transformer(pt.TransformerConfig(**dict(DRAFT, in_size=17)),
                       device="cpu", seed=1).state_dict(),
        pt.TransformerConfig(**dict(DRAFT, in_size=17)),
        lm["pt"].parent / "other_vocab")
    for kind in KINDS:
        with pytest.raises(ValueError, match="vocab"):
            _server(kind, lm["pt"], other, 2)
    for kind in ("continuous", "paged"):
        with pytest.raises(ValueError, match="draft slack"):
            _server(kind, lm["pt"], lm["pd"], 4).serve(
                [{"tokens": [1] * 10, "n_tokens": 20}])
    got = _server("speculative", lm["pt"], lm["pd"], 4).serve(
        [{"tokens": [1] * 10, "n_tokens": 22}])
    assert got[0]["n_generated"] == 22
    with pytest.raises(ValueError, match="serving window"):
        _server("speculative", lm["pt"], lm["pd"], 4).serve(
            [{"tokens": [1] * 10, "n_tokens": 23}])


def test_spec_draw_block_is_the_canonical_stream():
    """spec_draw_block over [b, m, V] equals device_sample row by row at
    each slot's positions (greedy the first-max argmax), parked slots 0."""
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(size=(3, 4, 19)).astype(np.float32))
    logits[0, 1, 5] = logits[0, 1, 7] = logits[0, 1].max() + 1.0  # a tie
    slots = [{"temperature": 0.0, "top_k": None, "top_p": None, "key": 0,
              "n_committed": 6}, None,
             {"temperature": 0.8, "top_k": 5, "top_p": 0.9, "key": 7,
              "n_committed": 9}]
    got = psrv.spec_draw_block(slots, logits, offset=2)
    assert got.shape == (3, 4) and (got[1] == 0).all()
    assert got[0, 1] == 5
    for s in (0, 2):
        st = slots[s]
        for i in range(4):
            want = psrv.device_sample(
                logits[s, i:i + 1], [st["key"]],
                [st["n_committed"] - 1 + 2 + i], [st["temperature"]],
                [int(st["top_k"] or 0)],
                [1.0 if st["top_p"] is None else st["top_p"]])
            assert got[s, i] == want[0, 0]
