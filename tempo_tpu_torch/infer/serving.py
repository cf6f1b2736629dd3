"""Serving runtime over exported LM artifacts (infer/export_lm.py).

Counterpart of tempo_tpu/infer/serving.py: ``chunked_prefill``, the
bucketed ``LMServer`` (same-length requests batched into one prefill and
decode chain, the prefix cache), ``ContinuousLMServer`` over its stepper
``LMEngine`` (a pool of slots, each at its own position, refilled
mid-flight; fused k-token chunks with drain chaining), and the host-side
policy they share with the paged server (infer/paged.py): support
truncation, stop sequences, raw-model logprobs, the canonical sampled
stream ``device_sample`` and the ticket plumbing of ``_TicketEngine``. The
numpy helpers are copies of the JAX package's (that module imports JAX at
load).

On CUDA the decode calls replay CUDA graphs whose outputs are static
tensors overwritten by the next replay of the same call: every scheduler
here reads or copies a call's outputs before it makes the next one. Each
server or engine owns its caches for its lifetime (the graphs write them
in place) and copies prefilled rows into them.

Not ported yet: beam search (``LMServer.beam_batch``, M11), speculation
(``SpecLMEngine``, ``SpeculativeLMServer``, ``draft_dir`` / ``k_draft``) and
``OnlineLMServer`` (ROADMAP, M12).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tempo_tpu_torch.infer import export_lm
from tempo_tpu_torch.infer.export_lm import (load_exported_continuous,
                                              load_exported_decode_k,
                                              load_exported_decode_k_sample,
                                              load_exported_lm,
                                              load_exported_speculative,
                                              zero_cache)

Device = Union[str, torch.device, None]


def chunked_prefill(extend_fn, meta: Dict[str, Any], prompts, chunk: int,
                    device: Device = None):
    """Exact prefill in fixed-size chunks through ``extend``: extending a
    zero cache from position 0 computes the cache and the last position's
    logits of a one-shot prefill (the absolute-position mask hides the
    slots never written) while bounding the attention scores to [b, n_head,
    chunk, max_seq] a call. Returns (logits of the last chunk, cache)."""
    prompts = torch.as_tensor(np.asarray(prompts, np.int64))
    b, t = prompts.shape
    assert chunk >= 1, chunk
    cache = zero_cache(meta, b, device)
    logits = None
    for i in range(0, t, chunk):
        logits, cache = extend_fn(prompts[:, i:i + chunk], cache, i)
    assert logits is not None, "empty prompt"
    return logits, cache


def _truncate_support(logits: np.ndarray, top_k: Optional[int],
                      top_p: Optional[float]) -> np.ndarray:
    """Top-k (keep the k largest logits) then top-p / nucleus (keep the
    smallest prefix of the sorted distribution whose mass reaches p,
    including the token that crosses the boundary). Works on [..., V]."""
    if top_k is not None and 0 < top_k < logits.shape[-1]:
        kth = np.partition(logits, -top_k, axis=-1)[..., -top_k:][..., :1]
        logits = np.where(logits < kth, -np.inf, logits)
    if top_p is not None and top_p < 1.0:
        x = logits - logits.max(axis=-1, keepdims=True)
        probs = np.exp(x)
        probs /= probs.sum(axis=-1, keepdims=True)
        sp = np.sort(probs, axis=-1)[..., ::-1]
        cum = np.cumsum(sp, axis=-1)
        keep = (cum - sp) < top_p  # exclusive cumsum: index 0 always kept
        thr = np.where(keep, sp, np.inf).min(axis=-1, keepdims=True)
        logits = np.where(probs < thr, -np.inf, logits)
    return logits


def parse_stops(req: Dict[str, Any], vocab: int) -> List[tuple]:
    """A request's 'stop' field as a list of token tuples: one sequence
    ([ids...]) or several ([[ids...], ...]); ids checked against the
    vocabulary. Empty/absent -> []."""
    raw = req.get("stop")
    if not raw:
        return []
    if isinstance(raw[0], int):
        raw = [raw]
    stops = []
    for s in raw:
        s = [int(x) for x in s]
        if not s:
            raise ValueError("empty stop sequence")
        if min(s) < 0 or max(s) >= vocab:
            raise ValueError(f"stop token ids outside [0, {vocab})")
        stops.append(tuple(s))
    return stops


def check_stops(st: Dict[str, Any]) -> bool:
    """After a token lands in st['out']: if the output now ends with a stop
    sequence, trim the matched tokens (the stop text is excluded, unlike
    the single-token 'eos', which is kept) and mark the slot finished."""
    for stop in st.get("stops", ()):
        n = len(stop)
        if len(st["out"]) >= n and tuple(st["out"][-n:]) == stop:
            del st["out"][len(st["out"]) - n:]
            st["eos_hit"] = True
            st["remaining"] = 0
            return True
    return False


def token_logprob(logits_row: np.ndarray, tok: int) -> float:
    """log p(tok) under the raw model distribution (no temperature or
    truncation) for one [V] row."""
    x = np.asarray(logits_row, np.float64).reshape(-1)
    x = x - x.max()
    return float(x[tok] - np.log(np.exp(x).sum()))


def device_sample(logits, keys, pos, temperature, top_k,
                  top_p) -> np.ndarray:
    """The canonical sampled stream every scheduler draws: one batched
    ``export_lm.sample_rows`` call on the logits' device, keyed by each
    row's integer seed and the absolute position of the fed token. logits
    [b, V] (a tensor stays where it is); keys/pos/temperature/top_k/top_p
    length-b sequences (top_k 0 and top_p >= 1 disable truncation).
    Returns [b, 1] int64 on the host."""
    x = torch.as_tensor(logits)
    dev = x.device

    def vec(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype)

    out = export_lm.sample_rows(
        x, vec(keys, torch.int64), vec(pos, torch.int64),
        vec(temperature, torch.float32), vec(top_k, torch.int64),
        vec(top_p, torch.float32))
    return out.cpu().numpy()[:, None].astype(np.int64)


class _TicketEngine:
    """Ticket plumbing shared by the decode engines: validated submission
    (zero-budget requests finish at once), work detection, cancellation
    (a pending request never runs; an active one finalizes with its partial
    tokens, flagged ``cancelled: true``), and the fused-burst machinery.
    Subclasses provide ``s`` (the server), ``pending``, ``finished``,
    ``slots``, ``pos``, ``toks``, ``_ticket``, ``default_new_tokens``,
    ``decode_steps``, ``decode_bursts``, ``_push`` and ``_finalize``."""

    def submit(self, req: Dict[str, Any]) -> int:
        """Validate and enqueue; returns a ticket to look up in
        ``finished``."""
        self.s._validate([req], self.default_new_tokens)
        t = self._ticket
        self._ticket += 1
        n_tokens = int(req.get("n_tokens", self.default_new_tokens))
        if n_tokens <= 0:
            self.finished[t] = {"tokens": [], "n_prompt":
                                len(req["tokens"]), "n_generated": 0,
                                "slot": -1, "stopped_early": False}
        else:
            self.pending.append((t, req, n_tokens))
        return t

    def has_work(self) -> bool:
        return bool(self.pending) or any(
            st is not None for st in self.slots)

    def _forget(self, ticket: int) -> None:
        """Drop scheduler state kept for a ticket that will never run
        again (subclasses that keep any override this)."""

    def cancel(self, ticket: int) -> bool:
        """Cancel a submitted request: a pending one never runs (and the
        scheduler forgets it); an active one finalizes now with the tokens
        generated so far. Either way its response carries ``cancelled:
        true``. Finished tickets are left as they are (returns False)."""
        for i, (t, req, n) in enumerate(self.pending):
            if t == ticket:
                self.pending.pop(i)
                self._forget(ticket)
                self.finished[ticket] = {
                    "tokens": [], "n_prompt": len(req["tokens"]),
                    "n_generated": 0, "slot": -1,
                    "stopped_early": False, "cancelled": True}
                return True
        for s, st in enumerate(self.slots):
            if st is not None and st["ticket"] == ticket:
                st["cancelled"] = True
                self._finalize(s)
                return True
        return False

    def _chain_gate(self, active, k: int, window: int,
                    cap: int = 4) -> int:
        """Drain-chaining depth: how many fused chunks to dispatch back to
        back. Only when nothing is pending, every active slot's budget
        survives the extra chunks, and the window allows the writes."""
        chains = 1
        while (chains < cap and not self.pending
               and all(self.slots[s]["remaining"] > chains * k
                       for s in active if self.slots[s] is not None)
               and all(self.pos[s] + (chains + 1) * k <= window
                       for s in active if self.slots[s] is not None)):
            chains += 1
        return chains

    def _policy_arrays(self, active):
        """Per-row sampling policy for the fused sampled dispatch:
        (seeds [b], temperature, top_k, top_p)."""
        b = len(self.slots)
        keys = np.zeros(b, np.int64)
        temp = np.zeros(b, np.float32)
        topk = np.zeros(b, np.int64)
        topp = np.ones(b, np.float32)
        for s in active:
            st = self.slots[s]
            keys[s] = st["key"]
            temp[s] = st["temperature"]
            topk[s] = int(st["top_k"] or 0)
            topp[s] = float(1.0 if st["top_p"] is None else st["top_p"])
        return keys, temp, topk, topp

    def _run_burst(self, active, k: int, chains: int, dispatch) -> None:
        """Dispatch ``chains`` fused chunks, feeding each chunk's last
        tokens (on the device) into the next; the host syncs once, then
        commits. Mid-burst finishers skip the remaining chunks (their tail
        is discarded like any over-decode). ``dispatch(tok_dev, pos_dev) ->
        (tokens [b, k], logprobs [b, k])``, both on the device, which may
        be a captured call's static outputs: each chunk is copied on the
        device before the next dispatch overwrites them."""
        dev = self.s.device
        burst = []
        tok_dev = torch.as_tensor(self.toks, dtype=torch.int64).to(dev)
        pos_dev = torch.as_tensor(self.pos).to(dev)
        for c in range(chains):
            chunk, lps = dispatch(tok_dev, pos_dev + c * k)
            chunk = chunk.clone()
            burst.append((chunk, None if lps is None else lps.clone()))
            tok_dev = chunk[:, -1:]
        self.decode_steps += chains
        self.decode_bursts += 1
        for chunk, lps in burst:
            chunk_np = chunk.cpu().numpy()
            lps_np = None if lps is None else lps.cpu().numpy()
            for s in active:
                st = self.slots[s]
                if st is None:
                    continue  # finished earlier in the burst
                for j in range(k):
                    self.pos[s] += 1
                    if st["lps"] is not None:
                        st["lps"].append(float(lps_np[s, j]))
                    self._push(s, st, chunk_np[s:s + 1, j:j + 1])
                    if self.slots[s] is None:
                        break


class LMServer:
    """Loads the exported artifacts once (``device`` None: CUDA) and serves
    batched generate calls. The server keeps one cache per batch size: a
    bucket's prefilled cache is copied into it, and the captured decode
    calls write it in place."""

    def __init__(self, artifacts_dir: Union[str, Path],
                 prefill_chunk: Optional[int] = None,
                 device: Device = None):
        self.prefill, self.decode_step, self.meta = load_exported_lm(
            artifacts_dir, device)
        self.device = torch.device(self.meta["device"])
        self.window = int(self.meta.get("max_seq", self.meta["block_size"]))
        self.vocab = int(self.meta["vocab_size"])
        self.prefill_chunk = prefill_chunk
        _, self.extend, _ = load_exported_speculative(artifacts_dir, device)
        try:
            # fused K-token greedy decode: one replay per K tokens
            self.decode_k, _, self.k_decode = load_exported_decode_k(
                artifacts_dir, device)
        except FileNotFoundError:
            self.decode_k, self.k_decode = None, 0
        try:
            # a bucket shares one policy, so the whole bucket rides the
            # device sampler; every row of a call draws with the request
            # seed, keyed by the fed token's absolute position
            self.decode_k_sample, _ = load_exported_decode_k_sample(
                artifacts_dir, device)
        except FileNotFoundError:
            self.decode_k_sample = None
        # prefix cache: tuple(prefix tokens) -> batch-1 KV cache
        self._prefix_caches: Dict[tuple, Any] = {}
        self._caches: Dict[int, Any] = {}  # batch -> the server's cache

    def _cache(self, b: int, src):
        """The server's cache for batch ``b``, with ``src`` (a cache of
        batch b, or of batch 1 to broadcast) copied into it."""
        cache = self._caches.get(b)
        if cache is None:
            cache = self._caches[b] = zero_cache(self.meta, b, self.device)
        for (ck, cv), (sk, sv) in zip(cache, src):
            ck.copy_(sk)
            cv.copy_(sv)
        return cache

    def _prefill(self, prompts):
        c = self.prefill_chunk
        if c is not None and np.shape(prompts)[1] > c:
            return chunked_prefill(self.extend, self.meta, prompts, c,
                                   self.device)
        return self.prefill(prompts)

    def _prefix_cache(self, prefix: tuple):
        """Batch-1 KV cache of a shared prompt prefix, computed once per
        distinct prefix by extending a zero cache (the prefill path's
        layout; reuse is exact under the absolute-position mask)."""
        cached = self._prefix_caches.get(prefix)
        if cached is None:
            arr = np.asarray(prefix, np.int64).reshape(1, -1)
            _, cached = self.extend(arr, zero_cache(self.meta, 1,
                                                    self.device), 0)
            self._prefix_caches[prefix] = cached
        return cached

    def generate_batch(self, prompts: np.ndarray, max_new_tokens: int,
                       temperature: float = 0.0,
                       top_k: Optional[int] = None, seed: int = 0,
                       top_p: Optional[float] = None,
                       prefix: Optional[Sequence[int]] = None) -> np.ndarray:
        """prompts: int array [b, t] (one length: the rows share one
        position). Returns [b, max_new_tokens].

        ``prefix``: a shared prompt prefix whose KV cache is computed once
        per distinct prefix and reused; each call then ingests only the
        [b, t] suffixes through ``extend`` at position len(prefix).

        Sampling draws the canonical stream: every row at ``seed``, keyed
        by the fed token's absolute position, so identical rows emit
        identical tokens; N diverse samples need N seeds."""
        prompts = np.asarray(prompts, np.int64)
        assert prompts.ndim == 2, prompts.shape
        b, t = prompts.shape
        n_prefix = len(prefix) if prefix else 0
        if max_new_tokens <= 0:
            return np.zeros((b, 0), np.int32)
        if n_prefix + t + max_new_tokens > self.window:
            raise ValueError(
                f"prefix {n_prefix} + prompt {t} + {max_new_tokens} new "
                f"tokens exceeds the exported serving window {self.window}")
        if prompts.size and (prompts.min() < 0 or prompts.max() >= self.vocab):
            raise ValueError(f"token ids outside [0, {self.vocab})")
        if n_prefix:
            assert t >= 1, "prefix mode needs at least one suffix token"
            cache = self._cache(b, self._prefix_cache(
                tuple(int(x) for x in prefix)))
            logits, cache = self.extend(prompts, cache, n_prefix)
            t = n_prefix + t  # decode continues from the absolute position
        else:
            logits, row = self._prefill(prompts)
            cache = self._cache(b, row)
            del row
        pos = int(t)
        remaining = max_new_tokens - 1
        if temperature > 0.0:
            keys = np.full(b, int(seed), np.int64)
            temp_v = np.full(b, float(temperature), np.float32)
            topk_v = np.full(b, int(top_k or 0), np.int64)
            topp_v = np.full(b, 1.0 if top_p is None else float(top_p),
                             np.float32)
            tok = device_sample(logits[:, -1], keys, np.full(b, pos - 1),
                                temp_v, topk_v, topp_v)
            out = [tok]
            k = self.k_decode
            while (self.decode_k_sample is not None and remaining > 0
                   and pos + k <= self.window):
                # a surplus last chunk is trimmed: its extra writes are
                # never attended, the loop ends right after
                chunk, _lps, cache = self.decode_k_sample(
                    tok, cache, np.full(b, pos), keys, temp_v, topk_v,
                    topp_v)
                take = min(k, remaining)
                chunk = chunk.cpu().numpy()[:, :take]
                out.append(chunk)
                tok = chunk[:, -1:]
                pos += take
                remaining -= take
            for _ in range(remaining):
                logits, cache = self.decode_step(tok, cache, pos)
                tok = device_sample(logits[:, -1], keys, np.full(b, pos),
                                    temp_v, topk_v, topp_v)
                out.append(tok)
                pos += 1
            return np.concatenate(out, axis=1).astype(np.int32)
        # greedy: the device argmax, first max on ties, as in the chunks
        tok = torch.argmax(logits[:, -1].float(), dim=-1, keepdim=True)
        out = [tok.cpu().numpy()]
        if self.decode_k is not None:
            while remaining >= self.k_decode:
                chunk, _lps, cache = self.decode_k(tok, cache, pos)
                out.append(chunk.cpu().numpy())
                tok = chunk[:, -1:]
                pos += self.k_decode
                remaining -= self.k_decode
        for _ in range(remaining):
            logits, cache = self.decode_step(tok, cache, pos)
            tok = torch.argmax(logits[:, -1].float(), dim=-1, keepdim=True)
            out.append(tok.cpu().numpy())
            pos += 1
        return np.concatenate(out, axis=1).astype(np.int32)

    def beam_batch(self, prompts: np.ndarray, max_new_tokens: int,
                   beam_width: int, eos_id: Optional[int] = None,
                   length_penalty: float = 0.0):
        """Beam decode over the artifacts: not ported yet (M11)."""
        raise NotImplementedError(
            "beam search (LMServer.beam_batch) is not ported yet (ROADMAP "
            "M11)")

    def serve_requests(self, requests: Sequence[Dict[str, Any]],
                       default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """requests: dicts with 'tokens' and optional 'n_tokens',
        'temperature', 'top_k', 'top_p', 'seed' and 'prefix' (shared
        system-prompt tokens, KV-cached once per distinct prefix).
        Buckets by (prompt length, sampling params, prefix) so each bucket
        is one batched prefill and decode chain; responses keep request
        order. 'beam_width' requests raise NotImplementedError (M11)."""
        buckets: Dict[tuple, List[int]] = {}
        for i, req in enumerate(requests):
            if "tokens" not in req:
                raise ValueError(f"request {i}: missing 'tokens'")
            if req.get("beam_width"):
                self.beam_batch(np.zeros((1, 1), np.int64), 1,
                                int(req["beam_width"]))
            # per-request early stops and logprobs need per-slot
            # bookkeeping: the slot schedulers' job
            for key in ("stop", "logprobs", "eos"):
                # presence, not truthiness, for eos: token id 0 is a
                # real vocab id
                if req.get(key) or (key == "eos"
                                    and req.get(key) is not None):
                    raise ValueError(
                        f"request {i}: {key!r} is not supported by the "
                        "bucketed scheduler — use scheduler: continuous "
                        "(or paged)")
            key = (len(req["tokens"]),
                   int(req.get("n_tokens", default_new_tokens)),
                   float(req.get("temperature", 0.0)),
                   req.get("top_k"), req.get("top_p"),
                   int(req.get("seed", 0)),
                   tuple(req["prefix"]) if req.get("prefix") else None)
            buckets.setdefault(key, []).append(i)

        responses: List[Optional[Dict[str, Any]]] = [None] * len(requests)
        for (t, n_tokens, temperature, top_k, top_p, seed,
             prefix), idxs in buckets.items():
            prompts = np.asarray([requests[i]["tokens"] for i in idxs],
                                 np.int64).reshape(len(idxs), t)
            t0 = time.perf_counter()
            toks = self.generate_batch(prompts, n_tokens,
                                       temperature=temperature, top_k=top_k,
                                       top_p=top_p, seed=seed, prefix=prefix)
            per_req = (time.perf_counter() - t0) / len(idxs)
            for row, i in enumerate(idxs):
                responses[i] = {
                    "tokens": toks[row].tolist(),
                    "n_prompt": t,
                    "n_generated": int(toks.shape[1]),
                    "batch": len(idxs),
                    "seconds": round(per_req, 4),
                }
        assert all(r is not None for r in responses)
        return responses  # type: ignore[return-value]

    def serve(self, requests: Sequence[Dict[str, Any]],
              default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """Scheduler-agnostic alias: hosts call serve() on any server."""
        return self.serve_requests(requests, default_new_tokens)


class LMEngine(_TicketEngine):
    """Stepper form of ContinuousLMServer's scheduling loop: submit /
    has_work / step / finished / cancel. One step() = one admission sweep
    + one decode dispatch (a fused k-token burst when eligible, a
    per-token dispatch otherwise). The engine decodes in the server's slot
    cache, which the captured decode calls update in place and ``admit``
    copies prefilled rows into: one engine at a time per server. Not
    thread-safe."""

    def __init__(self, server: "ContinuousLMServer",
                 default_new_tokens: int = 64):
        self.s = server
        self.default_new_tokens = int(default_new_tokens)
        b = server.n_slots
        self.slots: List[Optional[Dict[str, Any]]] = [None] * b
        self.pos = np.zeros(b, np.int32)
        self.toks = np.zeros((b, 1), np.int32)
        self.cache = server.slot_cache()
        self.pending: List[tuple] = []  # FIFO of (ticket, req, n_tokens)
        self.finished: Dict[int, Dict[str, Any]] = {}
        self._ticket = 0
        self.decode_steps = 0
        self.decode_bursts = 0  # host syncs on the fused path
        self.prefills = 0

    def _finalize(self, s: int) -> None:
        st = self.slots[s]
        assert st is not None
        resp = {
            "tokens": st["out"],
            "n_prompt": st["n_prompt"],
            "n_generated": len(st["out"]),
            "slot": s,
            "stopped_early": st["eos_hit"],
        }
        if st["lps"] is not None:
            # stop-sequence trimming shortened `out`; keep lps in step
            resp["logprobs"] = st["lps"][:len(st["out"])]
        if st.get("cancelled"):
            resp["cancelled"] = True
        self.finished[st["ticket"]] = resp
        self.slots[s] = None
        self.pos[s] = 0
        self.toks[s, 0] = 0

    def _push(self, s: int, st: Dict[str, Any],
              tok_row: np.ndarray) -> None:
        tok = int(tok_row[0, 0])
        st["out"].append(tok)
        st["remaining"] -= 1
        if st["eos"] is not None and tok == st["eos"]:
            st["eos_hit"] = True
            st["remaining"] = 0
        check_stops(st)
        if st["remaining"] <= 0:
            self._finalize(s)
        else:
            self.toks[s, 0] = tok

    def _admit(self) -> None:
        for s in range(self.s.n_slots):
            if self.slots[s] is not None or not self.pending:
                continue
            ticket, req, n_tokens = self.pending.pop(0)
            prompt = np.asarray(req["tokens"], np.int64).reshape(1, -1)
            logits, row_cache = self.s._prefill(prompt)
            self.s.admit(self.cache, row_cache, s)
            del row_cache
            self.prefills += 1
            st = {
                "ticket": ticket,
                "n_prompt": prompt.shape[1],
                "out": [],
                "remaining": n_tokens,
                "temperature": float(req.get("temperature", 0.0)),
                "top_k": req.get("top_k"),
                "top_p": req.get("top_p"),
                "eos": req.get("eos"),
                "eos_hit": False,
                "stops": parse_stops(req, self.s.vocab),
                # raw-model logprobs; they ride the fused chunks
                "lps": [] if req.get("logprobs") else None,
                # the request's seed keys its canonical stream
                "key": int(req.get("seed", 0)),
            }
            self.slots[s] = st
            self.pos[s] = prompt.shape[1]
            tok = device_sample(
                logits[:, -1], [st["key"]], [prompt.shape[1] - 1],
                [st["temperature"]], [int(st["top_k"] or 0)],
                [1.0 if st["top_p"] is None else float(st["top_p"])])
            if st["lps"] is not None:
                st["lps"].append(token_logprob(
                    logits[0, -1].float().cpu().numpy(), int(tok[0, 0])))
            self._push(s, st, tok)

    def step(self) -> None:
        """One admission sweep + (if anything is active) one decode
        dispatch. Mid-chunk finishers discard their over-decoded tail; the
        freed slot is refilled at the next step's admission."""
        self._admit()
        srv = self.s
        b = srv.n_slots
        slots, pos = self.slots, self.pos
        active = [s for s in range(b) if slots[s] is not None]
        if not active:
            return
        k = srv.k_decode
        all_greedy = all(slots[s]["temperature"] == 0.0 for s in active)
        if (srv.decode_k_rows is not None
                and (all_greedy or srv.decode_k_sample is not None)
                and (srv.fused_lps
                     or not any(slots[s]["lps"] is not None
                                for s in active))
                and all(pos[s] + k <= srv.window for s in active)):
            # every slot advances k tokens a dispatch; drain chaining
            # dispatches several chunks back to back when nothing waits
            chains = self._chain_gate(active, k, srv.window)
            cache = self.cache
            policy = None
            if not all_greedy:
                policy = tuple(torch.as_tensor(a).to(srv.device)
                               for a in self._policy_arrays(active))

            def dispatch(tok_dev, pos_dev):
                if policy is None:
                    chunk, lps, _ = srv.decode_k_rows(tok_dev, cache,
                                                      pos_dev)
                else:
                    chunk, lps, _ = srv.decode_k_sample(tok_dev, cache,
                                                        pos_dev, *policy)
                return chunk, lps

            self._run_burst(active, k, chains, dispatch)
            return
        logits, _ = srv.decode_rows(self.toks, self.cache, pos)
        logits_dev = logits[:, -1]  # stays on the device for the draw
        self.decode_steps += 1
        # one batched draw of the canonical stream, keyed by the fed
        # position, as inside the fused chunks
        keys, temp, topk, topp = self._policy_arrays(active)
        drawn = device_sample(logits_dev, keys, pos.copy(), temp, topk,
                              topp)
        # logprob rows fetch together, before the next dispatch
        lp_rows = [s for s in active if slots[s]["lps"] is not None]
        lp_np = (logits_dev[lp_rows].float().cpu().numpy()
                 if lp_rows else None)
        for s in active:
            st = slots[s]
            if st["lps"] is not None:
                st["lps"].append(token_logprob(
                    lp_np[lp_rows.index(s)], int(drawn[s, 0])))
            pos[s] += 1
            self._push(s, st, drawn[s:s + 1])


class ContinuousLMServer:
    """Continuous batching over the exported per-row-position calls.

    A fixed pool of ``n_slots`` rows decodes in lockstep, each at its own
    absolute position (``decode_rows`` takes pos [b]); a finished row is
    refilled mid-flight: the next request is prefilled at batch 1 and
    ``admit`` copies its cache into the row. Mixed prompt and generation
    lengths share one device batch. Outputs equal per-request
    ``generate_batch``, greedy and sampled (rows are independent; the
    sampled stream is a function of seed, prompt and position).
    ``k_decode`` > 0 advances every slot k tokens a dispatch through the
    fused ``decode_k_rows`` / ``decode_k_sample``. Speculation
    (``draft_dir`` / ``k_draft``) is not ported yet."""

    def __init__(self, artifacts_dir: Union[str, Path], n_slots: int = 8,
                 prefill_chunk: Optional[int] = None,
                 draft_dir: Optional[Union[str, Path]] = None,
                 k_draft: int = 0, k_decode: int = 0,
                 device: Device = None):
        if draft_dir is not None or k_draft:
            raise NotImplementedError(
                "speculation (draft_dir / k_draft) is not ported yet "
                "(ROADMAP M12)")
        (self.prefill, self.decode_rows, self.admit,
         self.meta) = load_exported_continuous(artifacts_dir, device)
        self.device = torch.device(self.meta["device"])
        assert n_slots >= 1, n_slots
        self.n_slots = int(n_slots)
        self.k_decode = int(k_decode)
        self.decode_k_rows = self.decode_k_sample = None
        if self.k_decode > 0:
            _, self.decode_k_rows, k_art = load_exported_decode_k(
                artifacts_dir, device)
            assert self.k_decode == k_art, (
                f"artifacts were exported with decode_chunk={k_art}, "
                f"scheduler asked for k_decode={self.k_decode}")
            self.decode_k_sample, _ = load_exported_decode_k_sample(
                artifacts_dir, device)
        self.fused_lps = bool(self.meta.get("decode_k_logprobs"))
        self.window = int(self.meta.get("max_seq", self.meta["block_size"]))
        self.vocab = int(self.meta["vocab_size"])
        self.last_stats: Dict[str, Any] = {}
        self.prefill_chunk = prefill_chunk
        if prefill_chunk is not None:
            _, self.extend, _ = load_exported_speculative(artifacts_dir,
                                                          device)
        self._slots = None

    def slot_cache(self):
        """The [n_slots] cache the engines decode in, made once: the
        captured calls are bound to its tensors. A parked row's contents
        are dead: ``admit`` replaces the whole row."""
        if self._slots is None:
            self._slots = zero_cache(self.meta, self.n_slots, self.device)
        return self._slots

    def _prefill(self, prompts):
        c = self.prefill_chunk
        if c is not None and np.shape(prompts)[1] > c:
            return chunked_prefill(self.extend, self.meta, prompts, c,
                                   self.device)
        return self.prefill(prompts)

    def _validate(self, requests: Sequence[Dict[str, Any]],
                  default_new_tokens: int) -> None:
        for i, req in enumerate(requests):
            if "tokens" not in req:
                raise ValueError(f"request {i}: missing 'tokens'")
            t = len(req["tokens"])
            n = int(req.get("n_tokens", default_new_tokens))
            if t + n > self.window:
                raise ValueError(
                    f"request {i}: prompt {t} + {n} new tokens exceeds the "
                    f"exported serving window {self.window}")
            toks = np.asarray(req["tokens"], np.int64)
            if toks.size and (toks.min() < 0 or toks.max() >= self.vocab):
                raise ValueError(
                    f"request {i}: token ids outside [0, {self.vocab})")
            try:
                parse_stops(req, self.vocab)
            except ValueError as exc:
                raise ValueError(f"request {i}: {exc}") from None

    def serve(self, requests: Sequence[Dict[str, Any]],
              default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """requests: dicts with 'tokens' and optional 'n_tokens',
        'temperature', 'top_k', 'top_p', 'seed', 'eos' (kept in the
        output), 'stop' (token sequences, excluded from the output) and
        'logprobs'. Submit-all + drain over an LMEngine; every request is
        validated before any device work. Responses keep request order."""
        t_start = time.perf_counter()
        eng = LMEngine(self, default_new_tokens)
        tickets = [eng.submit(req) for req in requests]
        while eng.has_work():
            eng.step()
        dt = time.perf_counter() - t_start
        responses = [eng.finished[t] for t in tickets]
        n_generated = sum(r["n_generated"] for r in responses)
        self.last_stats = {
            "decode_steps": eng.decode_steps,
            "decode_bursts": eng.decode_bursts,
            "prefills": eng.prefills,
            "n_requests": len(requests),
            "n_slots": self.n_slots,
            "n_generated": n_generated,
            "seconds": round(dt, 4),
            "tokens_per_sec": round(n_generated / dt, 2) if dt > 0 else 0.0,
        }
        return responses

    def serve_requests(self, requests: Sequence[Dict[str, Any]],
                       default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """Scheduler-agnostic alias: hosts call either name."""
        return self.serve(requests, default_new_tokens)
