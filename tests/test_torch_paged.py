"""The port's paged LM server (tempo_tpu_torch/infer/paged.py over
infer/export_lm.py's live surface) on the CPU.

- Greedy outputs equal tempo_tpu's PagedLMServer over its live surface on
  the same weights, token for token: roomy and tight (preempting) pools,
  per-token and fused k_decode dispatch, chunked prefill, eos and stop
  sequences, automatic prefix sharing.
- Sampled streams cannot equal JAX's threefry stream; they are pinned
  equal across the port's own schedulers (per-token, k_decode, preempted
  replay, chunked prefill) and to the port's generate.
- The JAX package's serving faults are not carried over: a cancelled
  pending request leaves ``preempted_tickets``; a drain-chained burst falls
  back to one chunk when its page reservation preempted; the draw is one
  batched call per decode step.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.infer.export_lm import live_paged_surface as jax_surface
from tempo_tpu.infer.paged import PagedLMServer as JaxPagedLMServer
from tempo_tpu.interop.gpt_ckpt import params_from_torch_transformer
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.infer import export_lm, paged, serving
from tempo_tpu_torch.infer.export_lm import live_paged_surface
from tempo_tpu_torch.infer.paged import TRASH_PAGE, PagedLMServer, PagePool
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

CFG = dict(in_size=31, block_size=32, n_layer=2, n_head=2, n_embd=32)
PAGE, CHUNK = 8, 4

GREEDY = [
    {"tokens": [3, 1, 4, 1, 5], "n_tokens": 17},
    {"tokens": [9, 2, 6], "n_tokens": 11},
    {"tokens": [7, 7], "n_tokens": 20},
    {"tokens": [1, 2, 3, 4], "n_tokens": 5},
    {"tokens": [5], "n_tokens": 9},
    {"tokens": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], "n_tokens": 10},
]
SAMPLED = [
    {"tokens": [9, 2, 6], "n_tokens": 11, "temperature": 1.0, "top_k": 5,
     "seed": 3},
    {"tokens": [5], "n_tokens": 9, "temperature": 0.7, "top_p": 0.9,
     "seed": 11},
    {"tokens": [3, 1, 4, 1, 5], "n_tokens": 17},
    {"tokens": [7, 7], "n_tokens": 20, "temperature": 1.3, "seed": 5},
]


@pytest.fixture(scope="module")
def lm():
    """The port model (seed 0), its surface, and the JAX server's greedy
    outputs on the same weights (roomy per-token, and tight with k_decode:
    the JAX package's own schedulers agree with each other)."""
    model = pt.Transformer(pt.TransformerConfig(**CFG), device="cpu", seed=0)
    surface = live_paged_surface(model, max_seq=32, decode_chunk=CHUNK,
                                 page_size=PAGE, device="cpu")
    jcfg = jt.TransformerConfig(**CFG)
    params = params_from_torch_transformer(model.state_dict(), jcfg)
    jsurf = jax_surface(params, jcfg, max_seq=32, decode_chunk=CHUNK,
                        page_size=PAGE)
    base = JaxPagedLMServer(surface=jsurf, n_slots=2).serve(GREEDY)
    tight = JaxPagedLMServer(surface=jsurf, n_slots=2, n_pages=5,
                             k_decode=CHUNK).serve(GREEDY)
    assert [r["tokens"] for r in tight] == [r["tokens"] for r in base]
    return {"model": model, "surface": surface, "jax_surface": jsurf,
            "base": base}


def _server(lm, **kw):
    return PagedLMServer(surface=lm["surface"], n_slots=2, device="cpu",
                         **kw)


def _tokens(responses):
    return [r["tokens"] for r in responses]


@pytest.mark.parametrize("kw", [
    {}, {"n_pages": 5}, {"k_decode": CHUNK}, {"n_pages": 5, "k_decode": CHUNK},
    {"prefill_chunk": 4, "k_decode": CHUNK},
], ids=["roomy", "tight", "roomy_k", "tight_k", "chunked_prefill_k"])
def test_greedy_serve_matches_jax(lm, kw):
    srv = _server(lm, **kw)
    got = srv.serve(GREEDY)
    assert _tokens(got) == _tokens(lm["base"])
    stats = srv.last_stats
    if "n_pages" in kw:
        assert stats["preemptions"] > 0
        assert stats["peak_pages"] <= 4
    else:
        assert stats["preemptions"] == 0
    if "k_decode" in kw:
        assert stats["decode_bursts"] <= stats["decode_steps"]


def test_eos_and_stop_match_jax(lm):
    base = lm["base"][0]["tokens"]
    eos = base[7]
    stop = base[3:5]
    reqs = [dict(GREEDY[0], eos=eos), dict(GREEDY[0], stop=stop)]
    want = JaxPagedLMServer(surface=lm["jax_surface"], n_slots=2).serve(reqs)
    for kw in ({}, {"k_decode": CHUNK}):
        got = _server(lm, **kw).serve(reqs)
        assert _tokens(got) == _tokens(want)
        assert got[0]["tokens"] == base[:base.index(eos) + 1]
        assert all(r["stopped_early"] for r in got)


def test_automatic_prefix_sharing_matches_jax(lm):
    system = [3, 1, 4, 1, 5, 9, 2, 6]  # exactly one page
    reqs = [{"tokens": system + [7, 7], "n_tokens": 8},
            {"tokens": system + [1, 2, 3], "n_tokens": 6},
            {"tokens": system + [4], "n_tokens": 7}]
    want = JaxPagedLMServer(surface=lm["jax_surface"], n_slots=2).serve(reqs)
    srv = _server(lm)
    got = srv.serve(reqs)
    assert _tokens(got) == _tokens(want)
    stats = srv.last_stats
    assert stats["auto_prefixes"] == 3
    assert stats["shared_prefix_pages"] == 1  # built once...
    assert stats["prefix_hits"] == 2          # ...then hit twice
    # the registry persists across calls and is evicted under pressure
    r = srv.serve([{"tokens": system + [7, 7], "n_tokens": 8}])[0]
    assert r["tokens"] == got[0]["tokens"]
    assert srv.last_stats["prefix_hits"] == 1
    small = _server(lm, n_pages=4)
    small.serve([{"tokens": system + [7, 7], "n_tokens": 4},
                 {"tokens": system + [1], "n_tokens": 4}])
    assert small.last_stats["shared_prefix_pages"] == 1
    lone = {"tokens": [1] * 9, "n_tokens": 14}
    want = JaxPagedLMServer(surface=lm["jax_surface"], n_slots=1).serve(
        [lone])[0]
    assert small.serve([lone])[0]["tokens"] == want["tokens"]
    assert small.last_stats["shared_prefix_pages"] == 0


def test_explicit_prefix_equals_concatenated_prompt(lm):
    prefix = [3, 1, 4, 1, 5, 9, 2, 6, 5, 3]  # one shared page + 2 tail
    req = {"tokens": [7, 7, 1, 2, 3], "n_tokens": 6, "prefix": prefix}
    cat = {"tokens": prefix + req["tokens"], "n_tokens": 6}
    want = JaxPagedLMServer(surface=lm["jax_surface"], n_slots=2).serve(
        [cat])[0]
    got = _server(lm, prefill_chunk=4).serve([req])[0]
    assert got["tokens"] == want["tokens"]


def test_logprobs_fused_and_per_token_agree(lm):
    req = {"tokens": [3, 1, 4, 1, 5], "n_tokens": 8, "logprobs": True}
    per_token = _server(lm).serve([req])[0]
    fused = _server(lm, k_decode=CHUNK).serve([req])[0]
    assert per_token["tokens"] == fused["tokens"] == \
        lm["base"][0]["tokens"][:8]
    np.testing.assert_allclose(fused["logprobs"], per_token["logprobs"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kw", [
    {"k_decode": CHUNK}, {"n_pages": 5}, {"n_pages": 5, "k_decode": CHUNK},
    {"prefill_chunk": 2},
], ids=["k_decode", "tight", "tight_k", "chunked_prefill"])
def test_sampled_streams_are_scheduler_independent(lm, kw):
    base = _server(lm).serve(SAMPLED)
    srv = _server(lm, **kw)
    got = srv.serve(SAMPLED)
    assert _tokens(got) == _tokens(base)
    if "n_pages" in kw:
        assert srv.last_stats["preemptions"] > 0
    # the sampled rows really sampled: not their greedy continuation
    greedy = _server(lm).serve([dict(r, temperature=0.0) for r in SAMPLED])
    assert _tokens(got)[3] != _tokens(greedy)[3]


def test_generate_draws_the_servers_stream(lm):
    """generate's row 0 (seed + 0) and a served request with the same seed
    and policy draw the same tokens: both key the draw by the absolute
    position of the fed token."""
    req = SAMPLED[0]
    served = _server(lm).serve([req])[0]["tokens"]
    out = pt.generate(lm["model"], torch.tensor([req["tokens"]]),
                      req["n_tokens"], seed=req["seed"],
                      temperature=req["temperature"], top_k=req["top_k"],
                      cache_len=32)
    assert out[0, len(req["tokens"]):].tolist() == served


def _splitmix_reference(z: int) -> int:
    m = (1 << 64) - 1
    z = (z + 0x9E3779B97F4A7C15) & m
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & m
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & m
    return z ^ (z >> 31)


def test_counter_draw_is_splitmix64():
    seeds = [0, 7, 2 ** 40 + 3]
    got = export_lm.splitmix64(torch.tensor(seeds)).tolist()
    assert [g & ((1 << 64) - 1) for g in got] == \
        [_splitmix_reference(s) for s in seeds]
    u = export_lm.counter_uniform(torch.tensor([5]), torch.tensor([9]), 4)
    state = _splitmix_reference(_splitmix_reference(5) ^ 9)
    want = [((_splitmix_reference((state + i * 0x9E3779B97F4A7C15)
                                  & ((1 << 64) - 1)) >> 11) + 0.5) * 2.0 ** -53
            for i in range(4)]
    np.testing.assert_array_equal(u[0].numpy(), np.asarray(want))


def test_device_sample_is_a_function_of_seed_position_and_logits():
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    keys, pos = [4, 4, 9], [10, 11, 10]
    temp, topk, topp = [1.0, 1.0, 0.5], [0, 7, 0], [1.0, 1.0, 0.8]
    batch = serving.device_sample(logits, keys, pos, temp, topk, topp)
    for r in range(3):
        one = serving.device_sample(logits[r:r + 1], keys[r:r + 1],
                                    pos[r:r + 1], temp[r:r + 1],
                                    topk[r:r + 1], topp[r:r + 1])
        assert one[0, 0] == batch[r, 0]
    # the draw follows the policy: top-k support only
    x = logits[1].numpy()
    assert batch[1, 0] in np.argsort(x)[-7:]
    # greedy rows take the first max
    tie = torch.zeros(1, 5)
    assert serving.device_sample(tie, [1], [0], [0.0], [0], [1.0])[0, 0] == 0


def test_truncation_matches_the_host_policy():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4, 40)).astype(np.float32)
    top_k = np.asarray([0, 5, 0, 3])
    top_p = np.asarray([1.0, 1.0, 0.6, 0.9], np.float32)
    got = export_lm.truncate_support_rows(
        torch.from_numpy(x), torch.from_numpy(top_k),
        torch.from_numpy(top_p)).numpy()
    for r in range(4):
        want = serving._truncate_support(
            x[r], int(top_k[r]) or None,
            None if top_p[r] >= 1 else float(top_p[r]))
        np.testing.assert_array_equal(np.isinf(got[r]), np.isinf(want))


def test_page_pool_invariants():
    pool = PagePool(5)
    assert pool.n_usable == 4 and pool.n_free == 4
    got = [pool.alloc() for _ in range(4)]
    assert sorted(got) == [1, 2, 3, 4]  # trash page 0 never handed out
    assert TRASH_PAGE not in got
    assert pool.alloc() is None and pool.n_free == 0
    pool.free([got[0]])
    assert pool.n_free == 1 and pool.alloc() == got[0]
    pool.share([got[1]])
    pool.free([got[1]])
    assert pool.n_free == 0  # still held once
    pool.free([got[1]])
    assert pool.n_free == 1
    with pytest.raises(AssertionError, match="double free"):
        pool.free([got[1]])
    with pytest.raises(AssertionError, match="trash"):
        pool.free([TRASH_PAGE])


def test_requests_that_cannot_fit_are_refused(lm, tmp_path):
    with pytest.raises(ValueError, match="pages"):
        PagedLMServer(surface=lm["surface"], n_slots=1, n_pages=3,
                      device="cpu").serve([{"tokens": [1] * 10,
                                            "n_tokens": 20}])
    with pytest.raises(ValueError, match="window"):
        _server(lm).serve([{"tokens": [1] * 20, "n_tokens": 20}])
    # with a draft, the k_draft positions a verify block writes past the
    # request must fit the window and the pool too
    draft = export_lm.export_lm(lm["model"].state_dict(), lm["model"].config,
                                tmp_path / "draft")
    with pytest.raises(ValueError, match="draft slack"):
        _server(lm, draft_dir=draft, k_draft=3).serve(
            [{"tokens": [1] * 10, "n_tokens": 20}])
    with pytest.raises(ValueError, match="pages"):
        PagedLMServer(surface=lm["surface"], n_slots=1, n_pages=4,
                      draft_dir=draft, k_draft=3, device="cpu").serve(
            [{"tokens": [1] * 10, "n_tokens": 14}])


def test_cancelled_pending_request_leaves_preempted_tickets(lm):
    srv = _server(lm, n_pages=5)
    eng = paged.PagedLMEngine(srv)
    # two rows of 3 pages each on 4 usable pages: the later one is preempted
    # and waits, pending, for its whole lifetime's pages
    reqs = [GREEDY[0], GREEDY[2], GREEDY[1]]
    tickets = [eng.submit(r) for r in reqs]
    while not any(t in eng.preempted_tickets for t, _, _ in eng.pending):
        assert eng.has_work()
        eng.step()
    victim = next(t for t, _, _ in eng.pending
                  if t in eng.preempted_tickets)
    assert eng.cancel(victim)
    assert victim not in eng.preempted_tickets
    assert eng.finished[victim]["cancelled"]
    while eng.has_work():
        eng.step()
    assert not eng.preempted_tickets
    assert srv.pool.n_free == srv.pool.n_usable
    base = [lm["base"][i] for i in (0, 2, 1)]
    for t, want in zip(tickets, base):
        if t != victim:
            assert eng.finished[t]["tokens"] == want["tokens"]


def test_chain_depth_falls_back_when_reservation_preempts(lm, monkeypatch):
    """A drain-chained burst whose page reservation had to preempt a slot
    runs one chunk, so the requeued request is re-admitted next step."""
    srv = _server(lm, k_decode=CHUNK)
    eng = paged.PagedLMEngine(srv)
    reqs = [{"tokens": [7, 7], "n_tokens": 25},
            {"tokens": [3, 1], "n_tokens": 25}]
    for r in reqs:
        eng.submit(r)
    eng.step()  # admit both
    assert not eng.pending
    chains_run = []
    run_burst = eng._run_burst
    ensure_page = eng._ensure_page
    forced = []

    def run(active, k, chains, dispatch):
        chains_run.append((chains, eng.preemptions))
        return run_burst(active, k, chains, dispatch)

    def ensure(s, logical):
        if not forced:
            forced.append(s)
            eng._preempt_one(exclude=s)
        return ensure_page(s, logical)

    monkeypatch.setattr(eng, "_run_burst", run)
    monkeypatch.setattr(eng, "_ensure_page", ensure)
    monkeypatch.setattr(eng, "_chain_gate", lambda *a, **k: 2)
    eng.step()
    assert chains_run == [(1, 1)]
    monkeypatch.undo()
    while eng.has_work():
        eng.step()
    want = _server(lm).serve(reqs)
    assert [eng.finished[t]["tokens"] for t in (0, 1)] == _tokens(want)


@pytest.mark.parametrize("k_decode", [0, CHUNK])
def test_one_batched_draw_per_decode_step(lm, monkeypatch, k_decode):
    """Every decode model step over the slot batch makes exactly one
    sample_rows call over all rows (admissions draw for their one row)."""
    draws, steps = [], []
    sample_rows = export_lm.sample_rows
    model = lm["model"]
    forward = model.forward

    def counted_draw(logits, *args):
        draws.append(logits.shape[0])
        return sample_rows(logits, *args)

    def counted_forward(x, cache=None, input_pos=None, **kw):
        if cache is not None and torch.as_tensor(x).shape == (2, 1):
            steps.append(1)
        return forward(x, cache=cache, input_pos=input_pos, **kw)

    monkeypatch.setattr(export_lm, "sample_rows", counted_draw)
    monkeypatch.setattr(model, "forward", counted_forward)
    srv = _server(lm, k_decode=k_decode)
    srv.serve(SAMPLED)
    n_decode = sum(steps)
    assert n_decode > 0
    assert draws.count(2) == n_decode
    assert draws.count(1) == srv.last_stats["prefills"]
