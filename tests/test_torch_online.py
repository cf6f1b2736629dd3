"""The port's online server (tempo_tpu_torch/infer/serving.py
OnlineLMServer over the continuous, speculative and paged engines) and
cli/serve_lm.py's speculative and online modes, on the CPU.

A tiny target (2 layers, 32 wide) and draft (1 layer, 16 wide), exported
once per module through both packages (the port's after
``interop/jax_params.py::gpt_state_dict_from_jax``). Online responses must
equal the same requests served in batch mode (the port's own solo and
closed-batch servers), token for token, greedy and sampled; the CLI's
greedy completions must equal the JAX CLI's token for token. Every wait is
bounded at WAIT seconds; torch runs on one thread.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from tempo_tpu.cli import serve_lm as jserve
from tempo_tpu.infer import export_lm as jexp
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.cli import serve_lm as pserve
from tempo_tpu_torch.infer import export_lm as pexp
from tempo_tpu_torch.infer import serving as psrv
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

TARGET = dict(in_size=31, block_size=32, n_layer=2, n_head=2, n_embd=32)
DRAFT = dict(in_size=31, block_size=32, n_layer=1, n_head=2, n_embd=16)
CHUNK, PAGE = 4, 8
WAIT = 20.0

REQS = [
    {"tokens": [3, 1, 4, 1, 5], "n_tokens": 17},
    {"tokens": [9, 2, 6], "n_tokens": 11, "temperature": 1.0, "top_k": 5,
     "seed": 3},
    {"tokens": [7, 7], "n_tokens": 20},
    {"tokens": [1, 2, 3, 4], "n_tokens": 3},
]
LATE = {"tokens": [5], "n_tokens": 9, "temperature": 0.7, "top_p": 0.9,
        "seed": 11}
POOLS = {
    "continuous": {},
    "speculative": {"k_draft": 2},
    "paged": {"scheduler": "paged", "n_pages": 6},
}


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


@pytest.fixture(scope="module")
def lm(tmp_path_factory):
    root = tmp_path_factory.mktemp("online")
    jt_dir, pt_dir = _export(root, "target", TARGET, 0, decode_chunk=CHUNK,
                             page_size=PAGE)
    jd_dir, pd_dir = _export(root, "draft", DRAFT, 4, decode_chunk=CHUNK)
    solo = psrv.LMServer(pt_dir, device="cpu")
    want = {}
    for req in REQS + [LATE]:
        want[json.dumps(req)] = solo.generate_batch(
            np.asarray([req["tokens"]]), req["n_tokens"],
            temperature=req.get("temperature", 0.0), top_k=req.get("top_k"),
            top_p=req.get("top_p"), seed=req.get("seed", 0))[0].tolist()
    return {"jt": jt_dir, "pt": pt_dir, "jd": jd_dir, "pd": pd_dir,
            "want": want}


def _online(lm, pool, **kw):
    extra = {"n_slots": 2, **POOLS[pool], **kw}
    if "k_draft" in extra:
        extra["draft_dir"] = lm["pd"]
    return psrv.OnlineLMServer(lm["pt"], device="cpu", **extra)


@pytest.mark.parametrize("pool", list(POOLS))
def test_online_matches_solo(lm, pool):
    """Requests submitted from four threads, and one more submitted once
    the shortest has finished, join one running batch and come back equal
    to solo decodes, greedy and sampled; the batch is shared (fewer
    dispatches than tokens)."""
    online = _online(lm, pool)
    try:
        results = [None] * len(REQS)

        def worker(i):
            results[i] = online.generate(REQS[i], timeout=WAIT)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(REQS))]
        for t in threads:
            t.start()
        for t in threads[3:]:
            t.join(WAIT)
        late = online.generate(LATE, timeout=WAIT)
        for t in threads:
            t.join(WAIT)
        stats = online.stats()
    finally:
        online.close(WAIT)
    assert not online._thread.is_alive()
    for req, got in zip(REQS, results):
        assert got is not None and got["tokens"] == lm["want"][
            json.dumps(req)]
    assert late["tokens"] == lm["want"][json.dumps(LATE)]
    assert stats["prefills"] == len(REQS) + 1 and stats["pending"] == 0
    serial = sum(r["n_tokens"] - 1 for r in REQS + [LATE])
    assert 0 < stats["decode_steps"] < serial
    if pool == "speculative":
        assert stats["rounds"] == stats["decode_steps"]
        assert stats["drafted"] > 0
    with pytest.raises(RuntimeError, match="closed"):
        online.submit(REQS[0])


def test_online_under_thread_contention(lm):
    """More caller threads than cores, each submitting and cancelling, with
    a short switch interval: every ticket is unique, every finished
    response is its request's solo decode, every cancelled one a prefix."""
    import os
    import sys

    n_threads = (os.cpu_count() or 1) + 2
    online = _online(lm, "speculative")
    got, errors = {}, []

    def client(c):
        try:
            mine = [REQS[(c + i) % len(REQS)] for i in range(2)] + [LATE]
            tickets = [(online.submit(r), r) for r in mine]
            online.cancel(tickets[-1][0])
            for t, r in tickets:
                got[t] = (r, online.result(t, timeout=WAIT))
        except Exception as exc:  # reported below, with the thread's id
            errors.append((c, exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        online.close(WAIT)
    assert not errors, errors
    assert len(got) == 3 * n_threads
    for req, resp in got.values():
        want = lm["want"][json.dumps(req)]
        if resp.get("cancelled"):
            assert resp["tokens"] == want[:len(resp["tokens"])]
        else:
            assert resp["tokens"] == want


def test_online_batch_mode_equals_the_closed_batch(lm):
    """serve_requests through the online front equals the same server's
    closed batch, response for response, paged speculation included."""
    reqs = REQS + [LATE]
    for pool, kw in (("paged", {"k_draft": 2}), ("continuous", {})):
        online = _online(lm, pool, **kw)
        try:
            got = online.serve_requests(reqs)
        finally:
            online.close(WAIT)
        want = online._server.serve(reqs)
        assert [r["tokens"] for r in got] == [r["tokens"] for r in want]


def test_online_cancellation(lm):
    """cancel(ticket): a queued request never runs; an active one
    finalizes with a prefix of its uncancelled stream; both carry
    ``cancelled: true``; the other requests are untouched, and cancelling
    a finished ticket is a no-op."""
    online = _online(lm, "continuous", n_slots=1)
    paused, resume = threading.Event(), threading.Event()
    eng = online._engine
    real_step = eng.step

    def step():  # pause once after a step in which the first request runs
        real_step()
        if not resume.is_set() and any(st is not None and st["ticket"] == 0
                                       for st in eng.slots):
            paused.set()
            assert resume.wait(WAIT)

    eng.step = step
    try:
        long = {"tokens": [3, 1, 4, 1, 5], "n_tokens": 24}
        t_active = online.submit(long)
        t_queued = online.submit({"tokens": [9, 2, 6], "n_tokens": 24})
        t_after = online.submit({"tokens": [7, 7], "n_tokens": 5})
        assert paused.wait(WAIT)
        # the scheduler holds in its step, the queued request pending in
        # the engine: both cancellations are registered before it goes on,
        # so it applies them before its next step
        got = {}
        cancellers = [threading.Thread(
            target=lambda t=t: got.__setitem__(t, online.cancel(t)))
            for t in (t_queued, t_active)]
        for c in cancellers:
            c.start()
        with online._cond:
            assert online._cond.wait_for(lambda: len(online._cancels) == 2,
                                         WAIT)
        resume.set()
        for c in cancellers:
            c.join(WAIT)
        assert got == {t_queued: True, t_active: True}
        r_q = online.result(t_queued, timeout=WAIT)
        assert r_q["cancelled"] and r_q["tokens"] == []
        r_a = online.result(t_active, timeout=WAIT)
        assert r_a["cancelled"]
        full = psrv.LMServer(lm["pt"], device="cpu").generate_batch(
            np.asarray([long["tokens"]]), 24)[0].tolist()
        assert 0 < len(r_a["tokens"]) < 24
        assert r_a["tokens"] == full[:len(r_a["tokens"])]
        r = online.result(t_after, timeout=WAIT)
        assert "cancelled" not in r
        assert r["tokens"] == lm["want"][json.dumps(
            {"tokens": [7, 7], "n_tokens": 20})][:5]
        assert not online.cancel(t_after)
        t = online.submit({"tokens": [2], "n_tokens": 4})
        assert online.result(t, timeout=WAIT)["n_generated"] == 4
        assert not online.cancel(t)
    finally:
        resume.set()
        online.close(WAIT)


@pytest.mark.parametrize("pool", ["continuous", "paged"])
def test_dead_scheduler_raises(lm, pool):
    """An exception inside a step fails the waiting caller and every later
    submit and cancel, instead of hanging them."""
    online = _online(lm, pool)

    def boom():
        raise RuntimeError("the device went away mid-step")

    online._engine.step = boom
    try:
        ticket = online.submit(REQS[0])
        with pytest.raises(RuntimeError, match="scheduler died") as err:
            online.result(ticket, timeout=WAIT)
        assert "went away" in str(err.value.__cause__)
        with pytest.raises(RuntimeError, match="scheduler died"):
            online.submit(REQS[1])
        with pytest.raises(RuntimeError, match="scheduler died"):
            online.cancel(ticket)
    finally:
        online.close(WAIT)
    assert not online._thread.is_alive()


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


CLI_REQS = [{"tokens": [3, 1, 4, 1, 5, 9, 2, 6, 5, 3], "n_tokens": 8},
            {"tokens": [9, 2, 6], "n_tokens": 6},
            {"tokens": [2, 7], "n_tokens": 3},
            {"tokens": [7, 7], "n_tokens": 9, "logprobs": True}]


@pytest.mark.parametrize("extra", [
    {"scheduler": "speculative", "k_draft": 3},
    {"scheduler": "continuous", "slots": 2, "k_draft": 2},
    {"scheduler": "paged", "slots": 2, "n_pages": 7, "k_draft": 2,
     "prefill_chunk": 4}],
    ids=["speculative", "continuous_draft", "paged_draft_chunked"])
def test_serve_lm_speculative_modes_match_jax(lm, tmp_path, extra):
    """serve_lm batch mode with a draft: completions.jsonl equals the JAX
    CLI's (tokens exactly, logprobs within 1e-5), and serving_info.yaml
    carries the rounds."""
    req_path = tmp_path / "requests.jsonl"
    req_path.write_text("".join(json.dumps(r) + "\n" for r in CLI_REQS))
    outs = {}
    for name, main, art, draft in (
            ("jax", jserve.main, lm["jt"], lm["jd"]),
            ("torch", pserve.main, lm["pt"], lm["pd"])):
        cfg = {"output_dir": str(tmp_path / name), "artifacts": str(art),
               "draft_artifacts": str(draft), "mode": "batch",
               "requests": str(req_path), **extra}
        kwargs = {"device": "cpu"} if name == "torch" else {}
        main(_write(tmp_path / f"{name}.yaml", cfg), **kwargs)
        outs[name] = [json.loads(line) for line in
                      (tmp_path / name / "completions.jsonl").read_text()
                      .splitlines()]
    assert [r["tokens"] for r in outs["torch"]] == [
        r["tokens"] for r in outs["jax"]]
    np.testing.assert_allclose(outs["torch"][3]["logprobs"],
                               outs["jax"][3]["logprobs"], atol=1e-5,
                               rtol=1e-5)
    info = yaml.safe_load((tmp_path / "torch" / "serving_info.yaml")
                          .read_text())
    assert info["scheduler_stats"]["rounds"] > 0
    assert info["scheduler_stats"]["k_draft"] == extra["k_draft"]


def _post(base, payload, out, i):
    req = urllib.request.Request(
        f"{base}/v1/completions", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=WAIT) as r:
        out[i] = json.loads(r.read())


@pytest.mark.parametrize("extra", [
    {"scheduler": "continuous", "k_draft": 2},
    {"scheduler": "paged", "n_pages": 7}], ids=["continuous_draft", "paged"])
def test_serve_lm_http_online_matches_jax(lm, tmp_path, extra):
    """online: true over HTTP: two concurrent POSTs to /v1/completions join
    one running batch and each equals the JAX CLI's greedy completion of
    its prompt in batch mode; the server stops after them."""
    prompts = [r["tokens"] for r in CLI_REQS[:2]]
    req_path = tmp_path / "requests.jsonl"
    req_path.write_text("".join(json.dumps({"tokens": p, "n_tokens": 6})
                                + "\n" for p in prompts))
    jserve.main(_write(tmp_path / "jax.yaml", {
        "output_dir": str(tmp_path / "jax"), "artifacts": str(lm["jt"]),
        "mode": "batch", "requests": str(req_path),
        "scheduler": "continuous", "slots": 2}))
    want = [json.loads(line)["tokens"] for line in
            (tmp_path / "jax" / "completions.jsonl").read_text()
            .splitlines()]
    cfg = {"output_dir": str(tmp_path / "served"),
           "artifacts": str(lm["pt"]), "draft_artifacts": str(lm["pd"]),
           "mode": "http", "port": 0, "online": True, "slots": 2,
           "max_requests": 2, **extra}
    th = threading.Thread(target=pserve.main,
                          args=(_write(tmp_path / "http.yaml", cfg),),
                          kwargs={"device": "cpu"}, daemon=True)
    th.start()
    info_path = tmp_path / "served" / "serving_info.yaml"
    deadline = time.monotonic() + WAIT
    while not (info_path.exists() and info_path.read_text().strip()):
        assert time.monotonic() < deadline, "the server did not start"
        time.sleep(0.02)
    base = f"http://127.0.0.1:{yaml.safe_load(info_path.read_text())['port']}"
    got = [None, None]
    posters = [threading.Thread(target=_post, args=(
        base, {"prompt": p, "max_tokens": 6}, got, i))
        for i, p in enumerate(prompts)]
    for p in posters:
        p.start()
    for p in posters:
        p.join(WAIT)
    th.join(WAIT)
    assert not th.is_alive()
    assert [g["choices"][0]["tokens"] for g in got] == want


def test_build_server_online_needs_a_pool(lm):
    for scheduler in ("bucketed", "speculative"):
        with pytest.raises(ValueError, match="online"):
            pserve.build_server({"artifacts": str(lm["pt"]), "online": True,
                                 "scheduler": scheduler,
                                 "draft_artifacts": str(lm["pd"])}, "cpu")
    with pytest.raises(ValueError, match="draft_artifacts"):
        pserve.build_server({"artifacts": str(lm["pt"]),
                             "scheduler": "speculative"}, "cpu")
