#!/usr/bin/env python3
"""Serve exported GPT artifacts (cli/export_lm.py output) on one GPU;
counterpart of tempo_tpu/cli/serve_lm.py.

    python -m tempo_tpu_torch.cli.serve_lm config.yaml [--overwrite] [--debug]

Schedulers (infer/serving.py, infer/paged.py):

- ``scheduler: bucketed`` (default): LMServer batches same-length requests
  into one prefill and decode chain each.
- ``scheduler: continuous``: ContinuousLMServer, a pool of ``slots`` rows
  each at its own position, refilled mid-flight; ``k_decode`` > 0
  advances every slot K tokens a dispatch (must equal the export's
  ``decode_chunk``).
- ``scheduler: paged``: PagedLMServer, continuous batching over a paged KV
  cache of ``n_pages`` pages (0: every slot's whole window) with
  preemption; needs an export with ``page_size`` > 0.
- ``scheduler: speculative``: SpeculativeLMServer, one request at a time:
  the draft (``draft_artifacts``, a second export sharing the vocabulary)
  proposes ``k_draft`` tokens (default 4), the target verifies them in one
  pass.

``draft_artifacts`` + ``k_draft`` > 0 also compose speculation into the
continuous and paged pools (every slot drafts and verifies at its own
position; an alternative to ``k_decode``). Every speculative output equals
target-only decode's, greedy and sampled. ``prefill_chunk`` > 0 prefills
long prompts in chunks through ``extend`` under every scheduler. On the
card every fixed-shape decode call replays a CUDA graph (infer/graphs.py).

Modes:

- ``mode: batch``: read a JSONL request file ({"tokens": [...],
  "n_tokens": N, "temperature": T, "top_k": K, "top_p": P, "seed": S, and
  under the continuous and paged schedulers "eos", "stop" and
  "logprobs"}), write ``completions.jsonl`` and ``serving_info.yaml``
  (aggregate tokens/s and the scheduler's statistics).
- ``mode: http``: a stdlib HTTP endpoint: GET /healthz -> the artifact's
  meta; POST /generate with one request or {"requests": [...]}; POST
  /v1/completions, an OpenAI-Completions-shaped surface over token ids
  (``prompt`` one list or a batch, ``max_tokens``, ``temperature``,
  ``top_p``, ``stop``, ``logprobs``, ``seed``, ``n``: n samples fan out
  over seeds seed..seed+n-1; ``stop`` and ``logprobs`` need the
  continuous or paged scheduler, the bucketed one answers them with 400).
  ``max_requests`` > 0 exits after that many POSTs. With ``online: true``
  (continuous or paged, with or without a draft) the endpoint is a
  ThreadingHTTPServer over an OnlineLMServer: concurrent POSTs join one
  running device batch; without it, one request at a time.

``serving_info.yaml`` is written as JSON (which YAML readers read), so the
serving functions run where PyYAML is absent, as on the card's machine:
there ``build_server`` and ``_serve_batch`` / ``_serve_http`` are driven
with a dict config (chip_smoke.py). Only ``main`` reads YAML.

``beam_width`` requests (with ``eos`` and ``length_penalty``) decode by
beam search on the bucketed scheduler, in batch mode and through POST
/generate; their responses add ``beams`` and ``scores`` (infer/serving.py
``LMServer.serve_requests``). As in the JAX CLI, the slot schedulers take
no beams.

Config:
  output_dir: <logs/completions dir>
  artifacts: <exported lm dir (the lm/ dir cli/export_lm.py writes)>
  mode: batch | http
  scheduler: bucketed | continuous | paged | speculative
  slots: 8                          # continuous / paged: batch rows
  k_decode: 0                       # continuous / paged: fused K-token calls
  draft_artifacts: <exported draft lm dir>  # speculation (speculative, or
                                    #   continuous / paged with k_draft > 0)
  k_draft: 4                        # speculation: draft block size
  n_pages: 0                        # paged: pool pages (0: every window)
  online: false                     # http + continuous / paged:
                                    #   OnlineLMServer (threaded endpoint)
  prefill_chunk: 0                  # >0: chunked prefill (every scheduler)
  requests: <jsonl path>            # batch mode
  host: 127.0.0.1                   # http mode
  port: 8900                        # http mode (0: any free port)
  max_requests: 0                   # http mode: exit after N POSTs (0: never)
  default_n_tokens: 64
"""

from __future__ import annotations

import json
import time
import threading
from http.server import (BaseHTTPRequestHandler, HTTPServer,
                         ThreadingHTTPServer)
from pathlib import Path
from typing import Any, Dict, Union

import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def _draft(config: Dict[str, Any], required: bool = False):
    """The draft artifact directory a config names (None without one, or
    with k_draft 0 where the draft is optional)."""
    if required:
        require_keys(config, ["draft_artifacts"])
    elif not (config.get("draft_artifacts")
              and int(config.get("k_draft", 0)) > 0):
        return None
    draft = Path(config["draft_artifacts"])
    if not (draft / "meta.json").exists():
        raise ValueError(f"FATAL: no exported draft artifacts at {draft}")
    return draft


def build_server(config: Dict[str, Any],
                 device: Union[str, torch.device, None] = None):
    """The server a config asks for, over ``config['artifacts']`` on
    ``device`` (None: CUDA). ``online: true`` gives an OnlineLMServer,
    whose scheduler thread runs until ``close()``."""
    artifacts = Path(config["artifacts"])
    if not (artifacts / "meta.json").exists():
        raise ValueError(f"FATAL: no exported artifacts at {artifacts} "
                         "(expected the programs, weights.pt and "
                         "meta.json that cli/export_lm.py writes)")
    scheduler = str(config.get("scheduler", "bucketed"))
    chunk = int(config.get("prefill_chunk", 0)) or None
    pool = {"n_slots": int(config.get("slots", 8)), "prefill_chunk": chunk,
            "k_decode": int(config.get("k_decode", 0)),
            "draft_dir": _draft(config),
            "k_draft": int(config.get("k_draft", 0)), "device": device}
    if config.get("online"):
        if scheduler not in ("continuous", "paged"):
            raise ValueError("FATAL: online: true is the open-world mode of "
                             "the continuous and paged schedulers")
        from tempo_tpu_torch.infer.serving import OnlineLMServer

        return OnlineLMServer(
            artifacts, scheduler=scheduler,
            n_pages=int(config.get("n_pages", 0)),
            default_new_tokens=int(config.get("default_n_tokens", 64)),
            **pool)
    if scheduler == "continuous":
        from tempo_tpu_torch.infer.serving import ContinuousLMServer

        return ContinuousLMServer(artifacts, **pool)
    if scheduler == "paged":
        from tempo_tpu_torch.infer.paged import PagedLMServer

        return PagedLMServer(artifacts, n_pages=int(config.get("n_pages", 0)),
                             **pool)
    if scheduler == "speculative":
        from tempo_tpu_torch.infer.serving import SpeculativeLMServer

        return SpeculativeLMServer(artifacts, _draft(config, required=True),
                                   k_draft=int(config.get("k_draft", 4)),
                                   prefill_chunk=chunk, device=device)
    if scheduler == "bucketed":
        from tempo_tpu_torch.infer.serving import LMServer

        return LMServer(artifacts, prefill_chunk=chunk, device=device)
    raise ValueError(f"FATAL: unknown scheduler {scheduler!r} "
                     "(bucketed | continuous | paged | speculative)")


def _serve_batch(server, config: dict, output_dir: Path,
                 default_n: int) -> None:
    req_path = Path(config["requests"])
    if not req_path.exists():
        raise ValueError(f"FATAL: requests file not found: {req_path}")
    requests = [json.loads(line) for line in
                req_path.read_text().splitlines() if line.strip()]
    print(f"Serving {len(requests)} requests from {req_path} ...")
    t0 = time.perf_counter()
    responses = server.serve_requests(requests, default_new_tokens=default_n)
    elapsed = time.perf_counter() - t0
    out_path = Path(output_dir) / "completions.jsonl"
    with out_path.open("w") as f:
        for resp in responses:
            f.write(json.dumps(resp) + "\n")
    n_generated = sum(r["n_generated"] for r in responses)
    info = {
        "n_requests": len(requests),
        "n_generated_tokens": n_generated,
        "elapsed_s": round(elapsed, 3),
        "tokens_per_sec": round(n_generated / max(elapsed, 1e-9), 2),
        "artifacts": str(config["artifacts"]),
    }
    if getattr(server, "last_stats", None):
        info["scheduler_stats"] = server.last_stats
    save_json_yaml(info, Path(output_dir) / "serving_info.yaml")
    print(f"Wrote {out_path}")
    print(f"Generated {n_generated} tokens in {elapsed:.2f}s "
          f"({info['tokens_per_sec']} tok/s)")


def _openai_to_requests(payload: dict, default_n: int) -> list:
    """An OpenAI Completions-style body as scheduler requests. Prompts are
    token ids (one list or a batch of lists); ``max_tokens``,
    ``temperature``, ``top_p``, ``stop`` (token-id sequences), ``logprobs``
    and ``seed`` map directly. ``n`` samples a prompt fan out as n requests
    with seeds seed, seed+1, ...: under the canonical sampled stream
    identical seeds return identical completions."""
    prompts = payload.get("prompt")
    if prompts is None:
        raise ValueError("missing 'prompt' (token ids)")
    if prompts and isinstance(prompts[0], int):
        prompts = [prompts]
    n = int(payload.get("n", 1))
    seed = int(payload.get("seed", 0))
    reqs = []
    for toks in prompts:
        for i in range(n):
            req = {"tokens": list(toks),
                   "n_tokens": int(payload.get("max_tokens", default_n)),
                   "seed": seed + i}
            for key in ("temperature", "top_p", "stop"):
                if payload.get(key) is not None:
                    req[key] = payload[key]
            if payload.get("logprobs"):
                req["logprobs"] = True
            reqs.append(req)
    return reqs


def _openai_response(reqs: list, responses: list,
                     n_samples: int = 1) -> dict:
    """OpenAI Completions-style response over token ids: one choice per
    (prompt, sample), finish_reason 'stop' when a stop or eos fired,
    'length' when the budget ran out; usage counts each prompt once."""
    choices = []
    for i, (req, resp) in enumerate(zip(reqs, responses)):
        choice = {
            "index": i,
            "tokens": resp["tokens"],
            "finish_reason": ("stop" if resp.get("stopped_early")
                              else "length"),
        }
        if "logprobs" in resp:
            choice["logprobs"] = {"token_logprobs": resp["logprobs"]}
        choices.append(choice)
    n_prompt = sum(len(r["tokens"]) for r in reqs) // max(n_samples, 1)
    n_out = sum(r["n_generated"] for r in responses)
    return {
        "object": "text_completion",
        "model": "tempo_tpu-lm",
        "choices": choices,
        "usage": {"prompt_tokens": n_prompt,
                  "completion_tokens": n_out,
                  "total_tokens": n_prompt + n_out},
    }


def _serve_http(server, config: dict, output_dir: Path,
                default_n: int, online: bool = False) -> None:
    """GET /healthz, POST /generate, POST /v1/completions. One request at a
    time (the decode calls are not thread-safe), or with ``online`` (an
    OnlineLMServer) one thread a connection, all submitting into the
    server's one running batch."""
    host = str(config.get("host", "127.0.0.1"))
    port = int(config.get("port", 8900))
    max_requests = int(config.get("max_requests", 0))
    counter = {"posts": 0}
    count_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        server_version = "tempo_tpu-lm"

        def _send(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — stdlib API
            if self.path == "/healthz":
                self._send(200, {"status": "ok", **server.meta})
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802 — stdlib API
            if self.path not in ("/generate", "/v1/completions"):
                self._send(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length))
                if self.path == "/v1/completions":
                    reqs = _openai_to_requests(payload, default_n)
                    responses = server.serve_requests(
                        reqs, default_new_tokens=default_n)
                    self._send(200, _openai_response(
                        reqs, responses,
                        n_samples=int(payload.get("n", 1))))
                else:
                    many = "requests" in payload
                    responses = server.serve_requests(
                        payload["requests"] if many else [payload],
                        default_new_tokens=default_n)
                    self._send(200, {"responses": responses} if many
                               else responses[0])
            except Exception as exc:  # serving endpoint: report, don't die
                self._send(400, {"error": f"{type(exc).__name__}: {exc}"})
            with count_lock:
                counter["posts"] += 1

        def log_message(self, fmt, *args):
            print(f"[http] {fmt % args}")

    httpd = (ThreadingHTTPServer if online else HTTPServer)((host, port),
                                                          Handler)
    bound = httpd.server_address
    print(f"Serving on http://{bound[0]}:{bound[1]} "
          f"(POST /generate, POST /v1/completions, GET /healthz"
          + (", online continuous batching)" if online else ")")
          + (f", exiting after {max_requests} requests" if max_requests
             else ""))
    save_json_yaml({"host": bound[0], "port": int(bound[1]),
                 "artifacts": str(config["artifacts"])},
                Path(output_dir) / "serving_info.yaml")
    if online and max_requests:
        # handler threads count asynchronously: a poll timeout keeps the
        # accept loop from waiting for a connection after the last POST
        httpd.timeout = 0.2
    try:
        if max_requests:
            while counter["posts"] < max_requests:
                httpd.handle_request()
        else:
            httpd.serve_forever()
    finally:
        httpd.server_close()


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Serve as the config says, on ``device`` (None: CUDA)."""
    config = load_config(config_path)
    require_keys(config, ["output_dir", "artifacts"])
    mode = str(config.get("mode", "batch"))
    if mode not in ("batch", "http"):
        raise ValueError(f"FATAL: unknown mode {mode!r} (batch | http)")
    if mode == "batch":
        require_keys(config, ["requests"])
    online = bool(config.get("online", False))
    server = build_server(config, device)
    try:
        output_dir = init_directory(Path(config["output_dir"]),
                                    overwrite=overwrite)
        copy_config(config_path, output_dir)
        print(f"Loaded artifacts: vocab {server.vocab}, window "
              f"{server.window}, scheduler "
              f"{config.get('scheduler', 'bucketed')}"
              f"{' (online)' if online else ''}, device "
              f"{server.meta['device']}")
        default_n = int(config.get("default_n_tokens", 64))
        if debug:
            default_n = min(default_n, 8)
        if mode == "batch":
            _serve_batch(server, config, output_dir, default_n)
        else:
            _serve_http(server, config, output_dir, default_n, online=online)
    finally:
        if online:
            server.close()
    print("\nDone!")


if __name__ == "__main__":
    run_cli(main, "Serve exported GPT artifacts (batch JSONL or HTTP)")
