"""The port's LM servers over exported artifacts (tempo_tpu_torch/infer/
serving.py, infer/paged.py) and its export_lm / serve_lm CLIs, against the
JAX package's servers over its StableHLO artifacts, on the CPU.

One tiny JAX GPT, exported once per module through both packages (the
port's export after ``interop/jax_params.py::gpt_state_dict_from_jax``).
Greedy streams are compared token for token; logprobs, fp32 on both sides
with the matmuls summed in another order, within atol 1e-5, rtol 1e-5.
Sampled streams cannot equal JAX's threefry stream: they are held equal
across the port's own schedulers.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from pathlib import Path
from urllib.error import HTTPError

import jax
import numpy as np
import pytest
import torch
import yaml

from tempo_tpu.cli import serve_lm as jserve
from tempo_tpu.infer import export_lm as jexp
from tempo_tpu.infer import serving as jsrv
from tempo_tpu.infer.paged import PagedLMServer as JaxPagedLMServer
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.cli import export_lm as pexport_cli
from tempo_tpu_torch.cli import serve_lm as pserve
from tempo_tpu_torch.cli import train_gpt
from tempo_tpu_torch.infer import export_lm as pexp
from tempo_tpu_torch.infer import serving as psrv
from tempo_tpu_torch.infer.paged import PagedLMServer
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt

torch.set_num_threads(1)

CFG = dict(in_size=31, block_size=32, n_layer=2, n_head=2, n_embd=32)
CHUNK, PAGE = 4, 8
TOL = {"atol": 1e-5, "rtol": 1e-5}

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
def lm(tmp_path_factory):
    root = tmp_path_factory.mktemp("serve_lm")
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
    want = [r["tokens"] for r in
            jsrv.ContinuousLMServer(jdir, n_slots=2).serve(GREEDY)]
    return {"jdir": jdir, "pdir": pdir, "root": root, "want": want,
            "pcfg": pcfg, "state": state}


def _tokens(responses):
    return [r["tokens"] for r in responses]


def test_lm_server_greedy_matches_jax(lm):
    """Bucketed generate_batch: one-shot and chunked prefill, the fused
    decode_k chunks with a per-token tail (mirrors tests/test_export.py:141,
    :773, :1344), and serve_requests' buckets in request order."""
    prompt = np.asarray([[3, 1, 4, 1, 5], [9, 2, 6, 5, 3]])
    want = jsrv.LMServer(lm["jdir"]).generate_batch(prompt, 20)
    for chunk in (None, 2):
        srv = psrv.LMServer(lm["pdir"], prefill_chunk=chunk, device="cpu")
        np.testing.assert_array_equal(srv.generate_batch(prompt, 20), want)
    got = psrv.LMServer(lm["pdir"], device="cpu").serve_requests(GREEDY)
    assert _tokens(got) == lm["want"]
    assert [r["n_prompt"] for r in got] == [len(r["tokens"]) for r in GREEDY]


def test_lm_server_prefix_cache_matches_jax(lm):
    """A shared prefix, KV-cached once, then reused (mirrors :1427)."""
    prefix = [3, 1, 4, 1, 5, 9]
    suffix = np.asarray([[2, 6], [5, 3]])
    jsrv_ = jsrv.LMServer(lm["jdir"])
    want = jsrv_.generate_batch(suffix, 9, prefix=prefix)
    srv = psrv.LMServer(lm["pdir"], device="cpu")
    for _ in range(2):
        np.testing.assert_array_equal(
            srv.generate_batch(suffix, 9, prefix=prefix), want)
    assert len(srv._prefix_caches) == 1
    full = np.concatenate([np.tile(prefix, (2, 1)), suffix], axis=1)
    np.testing.assert_array_equal(srv.generate_batch(full, 9), want)


@pytest.mark.parametrize("kw", [
    {}, {"k_decode": CHUNK}, {"prefill_chunk": 2},
    {"prefill_chunk": 3, "k_decode": CHUNK}],
    ids=["per_token", "k_decode", "chunked_prefill", "chunked_k"])
def test_continuous_server_matches_jax(lm, kw):
    """ContinuousLMServer (mirrors :729, :791, :1374): JAX's per-token
    stream, token for token, with fewer dispatches than tokens."""
    srv = psrv.ContinuousLMServer(lm["pdir"], n_slots=2, device="cpu", **kw)
    assert _tokens(srv.serve(GREEDY)) == lm["want"]
    st = srv.last_stats
    assert st["prefills"] == len(GREEDY)
    assert st["decode_steps"] < sum(r["n_tokens"] - 1 for r in GREEDY)
    if "k_decode" in kw:
        assert st["decode_bursts"] <= st["decode_steps"]


def test_continuous_eos_stop_and_logprobs_match_jax(lm):
    """eos (kept), stop sequences (trimmed) and logprobs (mirrors :643,
    :681), per-token and fused."""
    base = lm["want"][0]
    reqs = [dict(GREEDY[0], eos=base[7]), dict(GREEDY[0], stop=base[3:5]),
            dict(GREEDY[1], logprobs=True),
            dict(GREEDY[0], stop=base[3:5], logprobs=True)]
    want = jsrv.ContinuousLMServer(lm["jdir"], n_slots=2).serve(reqs)
    for kw in ({}, {"k_decode": CHUNK}):
        got = psrv.ContinuousLMServer(lm["pdir"], n_slots=2, device="cpu",
                                      **kw).serve(reqs)
        assert _tokens(got) == _tokens(want)
        assert [r["stopped_early"] for r in got] == [True, True, False, True]
        for i in (2, 3):
            assert len(got[i]["logprobs"]) == len(got[i]["tokens"])
            np.testing.assert_allclose(got[i]["logprobs"],
                                       want[i]["logprobs"], **TOL)
    with pytest.raises(ValueError, match="stop token ids"):
        psrv.ContinuousLMServer(lm["pdir"], device="cpu").serve(
            [dict(GREEDY[0], stop=[99])])


@pytest.mark.parametrize("kw", [
    {}, {"n_pages": 5, "k_decode": CHUNK}, {"prefill_chunk": 4}],
    ids=["roomy", "tight_k", "chunked_prefill"])
def test_paged_server_from_artifacts_matches_jax(lm, kw):
    want = JaxPagedLMServer(lm["jdir"], n_slots=2, **kw).serve(GREEDY)
    assert _tokens(want) == lm["want"]
    srv = PagedLMServer(lm["pdir"], n_slots=2, device="cpu", **kw)
    assert _tokens(srv.serve(GREEDY)) == lm["want"]
    if "n_pages" in kw:
        assert srv.last_stats["preemptions"] > 0
    # the scheduler's block table is one tensor per row count, reused
    tables = dict(srv._tables)
    srv.serve(GREEDY[:2])
    assert all(srv._tables[r] is t for r, t in tables.items())


def test_sampled_streams_are_scheduler_independent(lm):
    """The canonical stream: the same tokens from every port scheduler
    (bucketed one request at a time, continuous per-token and fused,
    paged tight and fused), and really sampled."""
    bucketed = psrv.LMServer(lm["pdir"], device="cpu")
    want = [bucketed.serve_requests([r])[0]["tokens"] for r in SAMPLED]
    for srv in (psrv.ContinuousLMServer(lm["pdir"], n_slots=2,
                                        device="cpu"),
                psrv.ContinuousLMServer(lm["pdir"], n_slots=2,
                                        k_decode=CHUNK, device="cpu"),
                PagedLMServer(lm["pdir"], n_slots=2, n_pages=5,
                              k_decode=CHUNK, device="cpu")):
        assert _tokens(srv.serve(SAMPLED)) == want
    greedy = psrv.ContinuousLMServer(lm["pdir"], device="cpu").serve(
        [dict(r, temperature=0.0) for r in SAMPLED])
    assert _tokens(greedy)[3] != want[3]


def test_burst_chunks_are_copied_before_the_next_dispatch():
    """A captured call returns the same output tensors at every replay:
    each chunk of a drain-chained burst must be copied before the next
    dispatch overwrites it (a fake dispatch that reuses one buffer)."""

    class Engine(psrv._TicketEngine):
        def __init__(self):
            self.s = type("S", (), {"device": torch.device("cpu")})()
            self.slots = [{"lps": [], "remaining": 99}]
            self.pos = np.zeros(1, np.int32)
            self.toks = np.zeros((1, 1), np.int32)
            self.decode_steps = self.decode_bursts = 0
            self.got = []

        def _push(self, s, st, tok_row):
            self.got.append(int(tok_row[0, 0]))

    buf, lps = torch.zeros(1, 2, dtype=torch.long), torch.zeros(1, 2)
    fed = []

    def dispatch(tok_dev, pos_dev):
        fed.append((int(tok_dev[0, 0]), int(pos_dev[0])))
        buf.copy_(10 * (len(fed)) + torch.arange(2)[None])
        lps.copy_(-buf.float())
        return buf, lps

    eng = Engine()
    eng._run_burst([0], 2, 3, dispatch)
    assert eng.got == [10, 11, 20, 21, 30, 31]
    assert eng.slots[0]["lps"] == [-10.0, -11.0, -20.0, -21.0, -30.0, -31.0]
    assert fed == [(0, 0), (11, 2), (21, 4)]
    assert eng.decode_steps == 3 and eng.decode_bursts == 1


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _requests(path: Path, reqs) -> str:
    path.write_text("".join(json.dumps(r) + "\n" for r in reqs))
    return str(path)


@pytest.mark.parametrize("scheduler", ["bucketed", "continuous", "paged"])
def test_serve_lm_batch_matches_jax(lm, tmp_path, scheduler):
    """serve_lm batch mode: completions.jsonl equals JAX's, and
    serving_info.yaml reads back (mirrors :255, :1314)."""
    reqs = GREEDY if scheduler == "bucketed" else GREEDY + [
        dict(GREEDY[1], logprobs=True), dict(GREEDY[0], stop=[5, 5])]
    req_path = _requests(tmp_path / "requests.jsonl", reqs)
    outs = {}
    for name, main, art in (("jax", jserve.main, lm["jdir"]),
                            ("torch", pserve.main, lm["pdir"])):
        cfg = {"output_dir": str(tmp_path / name), "artifacts": str(art),
               "mode": "batch", "requests": req_path,
               "scheduler": scheduler, "slots": 2, "k_decode": CHUNK}
        kwargs = {"device": "cpu"} if name == "torch" else {}
        main(_write(tmp_path / f"{name}.yaml", cfg), **kwargs)
        outs[name] = [json.loads(line) for line in
                      (tmp_path / name / "completions.jsonl").read_text()
                      .splitlines()]
    assert _tokens(outs["torch"]) == _tokens(outs["jax"])
    for got, want in zip(outs["torch"], outs["jax"]):
        if "logprobs" in want:
            np.testing.assert_allclose(got["logprobs"], want["logprobs"],
                                       **TOL)
    info = yaml.safe_load((tmp_path / "torch" / "serving_info.yaml")
                          .read_text())
    assert info["n_requests"] == len(reqs)
    assert info["n_generated_tokens"] == sum(len(t) for t in
                                             _tokens(outs["torch"]))


def _start_http(tmp_path, cfg):
    th = threading.Thread(target=pserve.main,
                          args=(_write(tmp_path / "http.yaml", cfg),),
                          kwargs={"device": "cpu"}, daemon=True)
    th.start()
    info_path = Path(cfg["output_dir"]) / "serving_info.yaml"
    for _ in range(600):
        if info_path.exists() and info_path.read_text().strip():
            break
        time.sleep(0.05)
    port = int(yaml.safe_load(info_path.read_text())["port"])
    return th, f"http://127.0.0.1:{port}"


def _post(base, path, payload):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_serve_lm_http_matches_jax(lm, tmp_path):
    """GET /healthz, POST /generate (one and many), POST /v1/completions
    (greedy with logprobs, n=2 sampled over consecutive seeds, a bad
    payload answered 400) over loopback (mirrors :280, :566)."""
    th, base = _start_http(tmp_path, {
        "output_dir": str(tmp_path / "served"), "artifacts": str(lm["pdir"]),
        "mode": "http", "port": 0, "scheduler": "continuous", "slots": 2,
        "max_requests": 4})
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    meta = json.loads((lm["pdir"] / "meta.json").read_text())
    assert health["status"] == "ok"
    assert {k: health[k] for k in meta} == meta
    one = _post(base, "/generate", GREEDY[0])
    assert one["tokens"] == lm["want"][0]
    many = _post(base, "/generate", {"requests": GREEDY[1:3]})
    assert _tokens(many["responses"]) == lm["want"][1:3]
    got = _post(base, "/v1/completions",
                {"prompt": [GREEDY[0]["tokens"], GREEDY[1]["tokens"]],
                 "max_tokens": 6, "logprobs": True})
    want = jsrv.ContinuousLMServer(lm["jdir"], n_slots=2).serve(
        [dict(GREEDY[0], n_tokens=6, logprobs=True),
         dict(GREEDY[1], n_tokens=6, logprobs=True)])
    assert [c["tokens"] for c in got["choices"]] == _tokens(want)
    for c, w in zip(got["choices"], want):
        assert c["finish_reason"] == "length"
        np.testing.assert_allclose(c["logprobs"]["token_logprobs"],
                                   w["logprobs"], **TOL)
    assert got["usage"] == {"prompt_tokens": 8, "completion_tokens": 12,
                            "total_tokens": 20}
    with pytest.raises(HTTPError) as err:
        _post(base, "/v1/completions", {"max_tokens": 4})
    assert err.value.code == 400
    th.join(timeout=60)
    assert not th.is_alive()


def test_openai_fan_out_draws_consecutive_seeds(lm):
    reqs = pserve._openai_to_requests(
        {"prompt": [3, 1, 4], "max_tokens": 5, "n": 2, "temperature": 1.0,
         "seed": 5}, 64)
    assert [r["seed"] for r in reqs] == [5, 6]
    srv = psrv.ContinuousLMServer(lm["pdir"], n_slots=2, device="cpu")
    resp = srv.serve(reqs)
    solo = psrv.LMServer(lm["pdir"], device="cpu")
    for i, r in enumerate(resp):
        assert r["tokens"] == solo.generate_batch(
            np.asarray([[3, 1, 4]]), 5, temperature=1.0, seed=5 + i)[0]\
            .tolist()
    assert resp[0]["tokens"] != resp[1]["tokens"]
    out = pserve._openai_response(reqs, resp, n_samples=2)
    assert out["usage"]["prompt_tokens"] == 3
    assert len(out["choices"]) == 2


def test_export_lm_cli_from_a_train_gpt_run(lm, tmp_path):
    """cli/export_lm.py over a tiny port train_gpt run directory: the
    latest checkpoint's weights, served, give the live model's greedy
    tokens."""
    run = tmp_path / "run"
    train_gpt.main(_write(tmp_path / "train.yaml", {
        "output_dir": str(run), "seed": 7,
        "data": {"synthetic": {"vocab_size": 17, "length": 2000},
                 "batch_size": 4},
        "model": {"n_layer": 1, "n_head": 2, "n_embd": 32,
                  "block_size": 32},
        "training": {"n_steps": 2, "save_every": 2, "val_every": 2,
                     "plot_every": 1000},
        "generation": {"n_tokens": 0}}), device="cpu")
    out = tmp_path / "export"
    pexport_cli.main(_write(tmp_path / "export.yaml", {
        "run_dir": str(run), "output_dir": str(out), "max_seq": 16,
        "decode_chunk": 4, "page_size": 8}), device="cpu")
    meta = json.loads((out / "lm" / "meta.json").read_text())
    assert meta["vocab_size"] == 17 and meta["max_seq"] == 16
    info = yaml.safe_load((out / "export_info.yaml").read_text())
    assert info["checkpoint"].endswith("ckpt_step=000002.pt")
    state = torch.load(info["checkpoint"], weights_only=True)["model"]
    model = pt.Transformer(pt.TransformerConfig(
        in_size=17, n_layer=1, n_head=2, n_embd=32, block_size=32),
        device="cpu")
    model.load_state_dict(state)
    want = pt.generate(model, torch.tensor([[1, 2, 3]]), 6,
                       temperature=0.0, cache_len=16)
    srv = PagedLMServer(out / "lm", n_slots=2, k_decode=4, device="cpu")
    got = srv.serve([{"tokens": [1, 2, 3], "n_tokens": 6}])[0]["tokens"]
    assert got == want[0, 3:].tolist()


def test_unported_options_raise(lm, tmp_path):
    """What stays refused is refused; beam search and int8 exports, which
    the port now runs, run: beam_batch and beam requests equal the JAX
    LMServer's over its artifact of the same weights, and an int8 export
    of a train_gpt run serves the live int8 model's greedy tokens."""
    prompts = np.asarray([[1, 2], [5, 3]])
    got = psrv.LMServer(lm["pdir"], device="cpu").beam_batch(prompts, 3, 2)
    want = jsrv.LMServer(lm["jdir"]).beam_batch(prompts, 3, 2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], **TOL)
    req = [{"tokens": [1, 2], "n_tokens": 3, "beam_width": 2}]
    resp = psrv.LMServer(lm["pdir"], device="cpu").serve_requests(req)[0]
    assert resp["beams"] == got[0][0].tolist()
    assert resp["tokens"] == resp["beams"][0]
    with pytest.raises(ValueError, match="prefix"):
        psrv.LMServer(lm["pdir"], device="cpu").serve_requests(
            [dict(req[0], prefix=[1])])
    base = {"artifacts": str(lm["pdir"])}
    # speculation and the online server are ported; online stays the mode
    # of the slot pools, as in the JAX CLI
    with pytest.raises(ValueError, match="online"):
        pserve.build_server({**base, "online": True, "scheduler": "bucketed"},
                            "cpu")
    with pytest.raises(ValueError, match="unknown scheduler"):
        pserve.build_server({**base, "scheduler": "beam"}, "cpu")
    with pytest.raises(ValueError, match="quantize"):
        pexport_cli.main(_write(tmp_path / "q4.yaml", {
            "run_dir": str(_run_dir_stub(tmp_path)),
            "output_dir": str(tmp_path / "q4"), "quantize": "int4"}),
            device="cpu")
    with pytest.raises(ValueError, match="bucketed scheduler"):
        psrv.LMServer(lm["pdir"], device="cpu").serve_requests(
            [dict(GREEDY[0], eos=0)])
    run = tmp_path / "run"
    model_cfg = {"n_layer": 1, "n_head": 2, "n_embd": 32, "block_size": 32}
    train_gpt.main(_write(tmp_path / "train.yaml", {
        "output_dir": str(run), "seed": 7,
        "data": {"synthetic": {"vocab_size": 17, "length": 2000},
                 "batch_size": 4},
        "model": model_cfg,
        "training": {"n_steps": 2, "save_every": 2, "val_every": 2,
                     "plot_every": 1000},
        "generation": {"n_tokens": 0}}), device="cpu")
    out = tmp_path / "q"
    pexport_cli.main(_write(tmp_path / "q.yaml", {
        "run_dir": str(run), "output_dir": str(out), "quantize": "int8",
        "max_seq": 16, "decode_chunk": 4, "page_size": 0}), device="cpu")
    meta = json.loads((out / "lm" / "meta.json").read_text())
    assert meta["quantize"] == "int8" and meta["n_experts"] == 0
    from tempo_tpu_torch.nn.quant import quantize_lm_params

    state = torch.load(run / "checkpoints" / "ckpt_step=000002.pt",
                       weights_only=True)["model"]
    model = pt.Transformer(pt.TransformerConfig(in_size=17, quantize="int8",
                                                **model_cfg), device="cpu")
    model.load_state_dict(quantize_lm_params(state))
    want = pt.generate(model, torch.tensor([[1, 2, 3]]), 6, temperature=0.0,
                       cache_len=16)
    got = psrv.LMServer(out / "lm", device="cpu").serve_requests(
        [{"tokens": [1, 2, 3], "n_tokens": 6}])[0]["tokens"]
    assert got == want[0, 3:].tolist()


def _run_dir_stub(tmp_path: Path) -> Path:
    run = tmp_path / "stub"
    run.mkdir()
    _write(run / "config.yaml", {"model": {"in_size": 17}})
    return run
