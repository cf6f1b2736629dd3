"""Serving runtime over exported LM artifacts (infer/export_lm.py).

Counterpart of tempo_tpu/infer/serving.py: ``chunked_prefill``, the
bucketed ``LMServer`` (same-length requests batched into one prefill and
decode chain, the prefix cache), ``ContinuousLMServer`` over its stepper
``LMEngine`` (a pool of slots, each at its own position, refilled
mid-flight; fused k-token chunks with drain chaining), speculation
(``SpeculativeLMServer`` at batch 1, and ``SpecLMEngine``, the draft/verify
stepper of ``ContinuousLMServer(draft_dir=..., k_draft=...)``), the online
front ``OnlineLMServer``, and the host-side policy they share with the
paged server (infer/paged.py): support truncation, stop sequences,
raw-model logprobs, the canonical sampled stream ``device_sample``, the
speculative draws ``spec_draw_block`` and the ticket plumbing of
``_TicketEngine``. The numpy helpers (``policy_probs`` and
``speculative_accept`` among them) are copies of the JAX package's (that
module imports JAX at load).

On CUDA the decode calls replay CUDA graphs whose outputs are static
tensors overwritten by the next replay of the same call: every scheduler
here reads or copies a call's outputs before it makes the next one (a
speculative round draws from each draft step's logits on the device, in
stream order, before the next step replays). Each server or engine owns
its caches for its lifetime (the graphs write them in place) and copies
prefilled rows into them.

Beam search (``LMServer.beam_batch``, and ``beam_width`` requests of the
bucketed ``serve_requests``) runs the unmodified prefill and decode_step
programs on the flattened [b*k] beam batch and scores candidates on the
host, as JAX's does; the server's beam cache is one tensor whose views are
the layers' caches, so the expand and each step's reorder are one device
gather each.
"""

from __future__ import annotations

import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tempo_tpu_torch.infer import export_lm
from tempo_tpu_torch.infer.export_lm import (load_exported_continuous,
                                              load_exported_decode_k,
                                              load_exported_decode_k_sample,
                                              load_exported_extend_rows,
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


def _policy_vectors(slots, rows: Sequence[int], m: int, dev):
    """The sampling policy of ``rows`` (slot indices), each repeated m times,
    as [len(rows) * m] tensors on ``dev``: (seeds, temperature, top_k,
    top_p)."""
    def vec(vals, dtype):
        return torch.as_tensor(np.repeat(np.asarray(vals), m)).to(
            device=dev, dtype=dtype)

    return (vec([slots[s]["key"] for s in rows], torch.int64),
            vec([slots[s]["temperature"] for s in rows], torch.float32),
            vec([int(slots[s]["top_k"] or 0) for s in rows], torch.int64),
            vec([1.0 if slots[s]["top_p"] is None else float(slots[s]["top_p"])
                 for s in rows], torch.float32))


def _spec_draws(slots: Sequence[Optional[Dict[str, Any]]], logits,
                offset: int = 0) -> torch.Tensor:
    """``spec_draw_block`` left on the logits' device: [b, m] int64. Greedy
    rows take the first-max argmax of the fp32 logits; sampled rows ride
    one ``export_lm.sample_rows`` call over all their (row, position)
    pairs. Rows of parked slots hold a draw that nothing reads."""
    x = torch.as_tensor(logits)
    b, m = x.shape[0], x.shape[1]
    drawn = torch.argmax(x.float(), dim=-1)
    sampled = [s for s in range(b) if slots[s] is not None
               and slots[s]["temperature"] > 0.0]
    if sampled:
        n = len(sampled)
        idx = torch.as_tensor(sampled, device=x.device)
        pos = np.concatenate([slots[s]["n_committed"] - 1 + offset
                              + np.arange(m) for s in sampled])
        seeds, temp, topk, topp = _policy_vectors(slots, sampled, m,
                                                  x.device)
        out = export_lm.sample_rows(
            x[idx].reshape(n * m, -1), seeds,
            torch.as_tensor(pos).to(x.device), temp, topk, topp)
        drawn[idx] = out.view(n, m)
    return drawn


def spec_draw_block(slots: Sequence[Optional[Dict[str, Any]]], logits_bmv,
                    offset: int = 0) -> np.ndarray:
    """Canonical-stream draws for every active slot over m consecutive
    emitted positions: logits [b, m, V] (a tensor stays where it is), where
    slot s's column i sits at absolute fed-position n_committed[s] - 1 +
    offset + i. Greedy slots take the argmax (the first max on ties, as
    the host argmax); sampled slots draw ``device_sample``'s stream keyed
    by their integer seed. The draft proposes and the target verifies
    through this one schedule, so accepted chains are exactly the canonical
    stream's. Returns [b, m] int64 on the host (0 for parked slots)."""
    drawn = _spec_draws(slots, logits_bmv, offset).cpu().numpy()
    for s, st in enumerate(slots):
        if st is None:
            drawn[s] = 0
    return drawn


def policy_probs(logits_row: np.ndarray, temperature: float,
                 top_k: Optional[int],
                 top_p: Optional[float] = None) -> np.ndarray:
    """The serving sampling policy as an explicit probability vector [V]:
    temperature scaling, then top-k / top-p support truncation (the support
    ``export_lm.truncate_support_rows`` keeps on the device). The
    distribution every canonical-stream draw follows, and the one the
    rejection-sampling reference ``speculative_accept`` preserves."""
    logits = np.asarray(logits_row, np.float64).reshape(-1)
    assert temperature > 0.0, "policy_probs is the sampled path"
    logits = _truncate_support(logits / float(temperature), top_k, top_p)
    logits -= logits.max()
    probs = np.exp(logits)
    return probs / probs.sum()


def speculative_accept(p: np.ndarray, q: np.ndarray, draft_tok: int,
                       u: float) -> tuple:
    """One rejection-sampling step of classical (Leviathan) speculative
    decoding: the draft token was sampled from q; accept it with
    probability min(1, p/q), otherwise resample from the residual
    max(p - q, 0), normalized. Marginalized over draft_tok ~ q the emitted
    token is exactly ~ p.

    The schedulers do not draw this path: they accept a draft iff it
    equals the canonical stream's draw at its position, which makes every
    stream equal to target-only decode. Kept as the distribution-
    correctness reference.

    Returns (accepted, residual): the normalized distribution to resample
    from on rejection (p itself when the residual is 0), None on accept."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    pd, qd = float(p[draft_tok]), float(q[draft_tok])
    if qd <= 0.0:
        # the draft could never propose this token under q: a hard reject
        accept = False
    else:
        accept = u < min(1.0, pd / qd)
    if accept:
        return True, None
    residual = np.maximum(p - q, 0.0)
    s = residual.sum()
    return False, (residual / s if s > 0.0 else p)


def _slot_state(ticket: int, req: Dict[str, Any], n_tokens: int,
                n_prompt: int, vocab: int) -> Dict[str, Any]:
    """A slot's host state for an admitted request."""
    return {
        "ticket": ticket,
        "n_prompt": n_prompt,
        "out": [],
        "remaining": n_tokens,
        "temperature": float(req.get("temperature", 0.0)),
        "top_k": req.get("top_k"),
        "top_p": req.get("top_p"),
        "eos": req.get("eos"),
        "eos_hit": False,
        "stops": parse_stops(req, vocab),
        # raw-model logprobs of the emitted tokens
        "lps": [] if req.get("logprobs") else None,
        # the request's seed keys its canonical stream
        "key": int(req.get("seed", 0)),
    }


def _first_token(st: Dict[str, Any], logits, pos: int) -> int:
    """The first token of an admitted slot, drawn from its prompt's last
    logits [1, V] at fed-position ``pos``; its logprob is recorded."""
    tok = int(device_sample(
        logits, [st["key"]], [pos], [st["temperature"]],
        [int(st["top_k"] or 0)],
        [1.0 if st["top_p"] is None else float(st["top_p"])])[0, 0])
    if st["lps"] is not None:
        st["lps"].append(token_logprob(logits[0].float().cpu().numpy(),
                                       tok))
    return tok


def draft_and_verify(srv, slots: Sequence[Optional[Dict[str, Any]]],
                     active: Sequence[int], d_cache, verify):
    """One batched draft/verify round, shared by SpecLMEngine and the paged
    engine: the draft ingests each row's lag (the committed tokens its
    cache has not seen: at most [d_k, correction]) through one
    ``d_extend_rows`` of width 2 and proposes k tokens (the first from the
    lag's last logits, the rest from k - 1 captured ``d_decode_rows``);
    then ``verify(block [b, k + 1], pos [b])`` scores every row's [last
    committed, d_1..d_k] at the row's position in one target pass. Every
    draw is made on the device right after the call whose logits it reads
    (a captured call's logits are overwritten by its next replay); drafts
    and draws reach the host together once. Parked rows ride on token 0 /
    position 0 of the lag and on their draws after it, all of which
    ``admit`` overwrites before the row is used. Returns (drafts [b, k],
    draws [b, k + 1]) on the host and the verify logits [b, k + 1, V]."""
    b, k, dev = srv.n_slots, srv.k_draft, srv.device
    width = 2  # the longest lag: [d_k, correction] after a full accept
    block_d = np.zeros((b, width), np.int64)
    pos_d = np.zeros(b, np.int64)
    last_lag = np.zeros(b, np.int64)
    committed = np.zeros(b, np.int64)  # 0 marks a parked row
    last = np.zeros((b, 1), np.int64)
    for s in active:
        st = slots[s]
        lag = st["lag"]
        assert 1 <= len(lag) <= width, lag
        block_d[s] = lag + [lag[-1]] * (width - len(lag))
        pos_d[s] = st["n_committed"] - len(lag)
        last_lag[s] = len(lag) - 1
        committed[s] = st["n_committed"]
        last[s, 0] = st["last"]
    d_logits, _ = srv.d_extend_rows(block_d, d_cache, pos_d)
    prop = d_logits[torch.arange(b, device=dev),
                    torch.as_tensor(last_lag).to(dev)]
    drafts = [_spec_draws(slots, prop[:, None], offset=0)]
    for i in range(1, k):
        step_pos = np.where(committed > 0, committed + i - 1, 0)
        logits, _ = srv.d_decode_rows(drafts[-1], d_cache, step_pos)
        drafts.append(_spec_draws(slots, logits[:, -1:], offset=i))
    drafts = torch.cat(drafts, 1)
    block_t = torch.cat([torch.as_tensor(last).to(dev), drafts], 1)
    t_logits, _ = verify(block_t, np.where(committed > 0, committed - 1, 0))
    both = torch.cat([drafts, _spec_draws(slots, t_logits)], 1).cpu().numpy()
    return both[:, :k], both[:, k:], t_logits


def accepted_commit(drafts_row: np.ndarray, draws_row: np.ndarray,
                    k: int) -> tuple:
    """(j, tokens to commit) for one row: the longest draft prefix equal to
    the canonical draws, then the next draw (the correction, or the bonus
    token after a full accept)."""
    j = 0
    while j < k and int(drafts_row[j]) == int(draws_row[j]):
        j += 1
    return j, [int(d) for d in drafts_row[:j]] + [int(draws_row[j])]


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

    def _respond(self, s: int) -> None:
        """Record slot s's response under its ticket in ``finished``."""
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


def top_k_rows_host(cand: np.ndarray, k: int):
    """(values, indices) [rows, k] of each row's k largest entries, best
    first, the lowest index first among equal values: what a stable
    argsort of -cand gives (``lax.top_k``'s order), without sorting whole
    rows. A partition finds each row's k-th largest value; only the entries
    above it and the lowest-indexed ones equal to it are ordered."""
    n = cand.shape[-1]
    if k >= n:
        idx = np.argsort(-cand, axis=-1, kind="stable")[:, :k]
        return np.take_along_axis(cand, idx, axis=-1), idx
    kth = np.partition(cand, n - k, axis=-1)[:, n - k]
    idx = np.empty((cand.shape[0], k), np.int64)
    for r, row in enumerate(cand):
        above = np.flatnonzero(row > kth[r])
        tied = np.flatnonzero(row == kth[r])[:k - above.size]
        sel = np.concatenate([above, tied])
        idx[r] = sel[np.lexsort((sel, -row[sel]))]
    return np.take_along_axis(cand, idx, axis=-1), idx


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
        # b*k -> the beam cache: one [2L, b*k, S, kv, hd] tensor
        self._beam_bufs: Dict[int, torch.Tensor] = {}
        self.beam_stats: Dict[str, float] = {}  # the last beam_batch's

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

    def _beam_expand(self, cache, k: int):
        """The server's beam cache for ``cache``'s b rows (kept for its
        lifetime: the captured decode calls write it in place), each row
        repeated k times in place, filled by one gather; returns (the
        tensor, the layers' (k, v) views of it)."""
        src = torch.stack([t for layer in cache for t in layer])
        b = src.shape[1]
        buf = self._beam_bufs.get(b * k)
        if buf is None:
            buf = self._beam_bufs[b * k] = torch.empty(
                (src.shape[0], b * k) + tuple(src.shape[2:]),
                dtype=src.dtype, device=src.device)
        rows = torch.arange(b, device=src.device).repeat_interleave(k)
        torch.index_select(src, 1, rows, out=buf)
        return buf, tuple((buf[2 * i], buf[2 * i + 1])
                          for i in range(len(cache)))

    def _beam_reorder(self, buf: torch.Tensor, flat_parent: np.ndarray):
        """Every layer's cache rows gathered by ``flat_parent``: one
        gather (and its copy back into the captured calls' tensor)."""
        idx = torch.as_tensor(flat_parent).to(self.device)
        buf.copy_(buf.index_select(1, idx))

    def beam_batch(self, prompts: np.ndarray, max_new_tokens: int,
                   beam_width: int, eos_id: Optional[int] = None,
                   length_penalty: float = 0.0):
        """Deterministic beam decode over the exported artifacts; the
        serving twin of nn/beam.py ``beam_search`` (the same scoring,
        frozen-eos and GNMT length-penalty semantics). The device runs the
        prefill and decode_step programs on the [b*k] beam batch, the host
        scores candidates (fp32 log-softmax, ``top_k_rows_host``: the
        lowest flat index first among ties, as JAX's stable argsort), and
        each step's beam reorder is one cache gather. Returns (continuations [b, k, max_new_tokens] best
        first, scores [b, k]); the prompt is not repeated, as in
        generate_batch. ``beam_stats`` holds the call's seconds and those
        of the host's scoring."""
        t_start = time.perf_counter()
        prompts = np.asarray(prompts, np.int64)
        assert prompts.ndim == 2, prompts.shape
        b, t = prompts.shape
        k = int(beam_width)
        if not 1 <= k <= self.vocab:
            raise ValueError(f"beam_width {k} outside [1, {self.vocab}]")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if t + max_new_tokens > self.window:
            raise ValueError(
                f"prompt {t} + {max_new_tokens} new tokens exceeds the "
                f"exported serving window {self.window}")
        if prompts.min() < 0 or prompts.max() >= self.vocab:
            raise ValueError(f"token ids outside [0, {self.vocab})")
        host = 0.0

        def log_softmax(logits):
            x = logits[:, -1].float().cpu().numpy()
            x = x - x.max(axis=-1, keepdims=True)
            return x - np.log(np.exp(x).sum(axis=-1, keepdims=True))

        def top_k_rows(cand):
            return top_k_rows_host(cand, k)

        logits, row = self._prefill(prompts)
        scores, tok = top_k_rows(log_softmax(logits))
        buf, cache = self._beam_expand(row, k)
        del row, logits
        toks = np.zeros((b, k, max_new_tokens), np.int64)
        toks[:, :, 0] = tok
        finished = ((tok == eos_id) if eos_id is not None
                    else np.zeros((b, k), bool))
        lengths = np.ones((b, k), np.int64)
        if eos_id is not None:
            frozen = np.full((self.vocab,), -np.inf, np.float32)
            frozen[eos_id] = 0.0
        rows = np.arange(b)[:, None] * k
        for i in range(1, max_new_tokens):
            logits, cache = self.decode_step(tok.reshape(b * k, 1), cache,
                                             t + i - 1)
            t0 = time.perf_counter()
            logp = log_softmax(logits).reshape(b, k, self.vocab)
            if eos_id is not None:
                logp = np.where(finished[:, :, None], frozen, logp)
            cand = (scores[:, :, None] + logp).reshape(b, k * self.vocab)
            scores, flat = top_k_rows(cand)
            parent = flat // self.vocab
            tok = flat % self.vocab
            toks = np.take_along_axis(toks, parent[:, :, None], axis=1)
            finished = np.take_along_axis(finished, parent, axis=1)
            lengths = np.take_along_axis(lengths, parent, axis=1)
            host += time.perf_counter() - t0
            self._beam_reorder(buf, (rows + parent).reshape(b * k))
            toks[:, :, i] = tok
            lengths = lengths + (~finished)
            if eos_id is not None:
                finished = finished | (tok == eos_id)

        if length_penalty != 0.0:
            scores = scores / ((5.0 + lengths.astype(np.float32)) / 6.0
                               ) ** length_penalty
            order = np.argsort(-scores, axis=-1, kind="stable")
            scores = np.take_along_axis(scores, order, axis=1)
            toks = np.take_along_axis(toks, order[:, :, None], axis=1)
        if eos_id is not None:
            past_eos = np.cumsum(toks == eos_id, axis=-1) > 1
            toks = np.where(past_eos, eos_id, toks)
        self.beam_stats = {"seconds": time.perf_counter() - t_start,
                           "host_scoring_s": host,
                           "steps": max_new_tokens - 1}
        return toks.astype(np.int32), scores.astype(np.float32)

    def serve_requests(self, requests: Sequence[Dict[str, Any]],
                       default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """requests: dicts with 'tokens' and optional 'n_tokens',
        'temperature', 'top_k', 'top_p', 'seed', 'prefix' (shared
        system-prompt tokens, KV-cached once per distinct prefix) and
        'beam_width' (+ 'eos', 'length_penalty'): beam requests decode
        through beam_batch, and their responses carry all k hypotheses
        under 'beams' and 'scores', the best one as 'tokens'. Buckets by
        (prompt length, sampling params, prefix, beam) so each bucket is
        one batched prefill and decode chain; responses keep request
        order."""
        buckets: Dict[tuple, List[int]] = {}
        for i, req in enumerate(requests):
            if "tokens" not in req:
                raise ValueError(f"request {i}: missing 'tokens'")
            if req.get("beam_width") and req.get("prefix"):
                raise ValueError(f"request {i}: beam_width does not compose "
                                 f"with prefix caching yet")
            # per-request early stops and logprobs need per-slot
            # bookkeeping: the slot schedulers' job ('eos' is honored
            # inside beam requests only)
            for key in (("stop", "logprobs") if req.get("beam_width")
                        else ("stop", "logprobs", "eos")):
                # presence, not truthiness, for eos: token id 0 is a
                # real vocab id
                if req.get(key) or (key == "eos"
                                    and req.get(key) is not None):
                    raise ValueError(
                        f"request {i}: {key!r} is not supported by the "
                        "bucketed scheduler — use scheduler: continuous "
                        "(or paged)")
            beam = None
            if req.get("beam_width"):
                beam = (int(req["beam_width"]), req.get("eos"),
                        float(req.get("length_penalty", 0.0)))
            key = (len(req["tokens"]),
                   int(req.get("n_tokens", default_new_tokens)),
                   float(req.get("temperature", 0.0)),
                   req.get("top_k"), req.get("top_p"),
                   int(req.get("seed", 0)),
                   tuple(req["prefix"]) if req.get("prefix") else None,
                   beam)
            buckets.setdefault(key, []).append(i)

        responses: List[Optional[Dict[str, Any]]] = [None] * len(requests)
        for (t, n_tokens, temperature, top_k, top_p, seed,
             prefix, beam), idxs in buckets.items():
            prompts = np.asarray([requests[i]["tokens"] for i in idxs],
                                 np.int64).reshape(len(idxs), t)
            t0 = time.perf_counter()
            beams = scores = None
            if beam is not None:
                k, eos, alpha = beam
                beams, scores = self.beam_batch(prompts, n_tokens, k,
                                                eos_id=eos,
                                                length_penalty=alpha)
                toks = beams[:, 0]  # the best hypothesis
            else:
                toks = self.generate_batch(
                    prompts, n_tokens, temperature=temperature, top_k=top_k,
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
                if beams is not None:
                    responses[i]["beams"] = beams[row].tolist()
                    responses[i]["scores"] = scores[row].tolist()
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
        self._respond(s)
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
            st = _slot_state(ticket, req, n_tokens, prompt.shape[1],
                             self.s.vocab)
            self.slots[s] = st
            self.pos[s] = prompt.shape[1]
            tok = _first_token(st, logits[:, -1], prompt.shape[1] - 1)
            self._push(s, st, np.asarray([[tok]]))

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


class SpecLMEngine(_TicketEngine):
    """Stepper form of speculation over the continuous pool: the same
    submit / has_work / step / finished / cancel surface as LMEngine, so
    OnlineLMServer drives draft/verify pools as it drives plain ones. One
    step() = one admission sweep + one draft/verify round
    (``draft_and_verify``): one draft ``extend_rows`` of width 2 over each
    row's lag, k - 1 captured draft ``decode_rows``, one eager target
    ``extend_rows`` of width k + 1 at each row's own position; then each
    row accepts the longest draft prefix equal to the canonical draws and
    commits the next draw, so every request's output is target-only
    decode's under the same seed and prompt.

    'stop' sequences and 'logprobs' compose (the verify pass holds every
    committed token's target logits). Admission prefills the target and
    the draft at batch 1 and copies the row into both slot caches (the
    server's, which the captured calls are bound to), replacing a parked
    row's whole cache. Not thread-safe."""

    def __init__(self, server: "ContinuousLMServer",
                 default_new_tokens: int = 64):
        assert server.draft is not None and server.k_draft > 0
        self.s = server
        self.default_new_tokens = int(default_new_tokens)
        self.slots: List[Optional[Dict[str, Any]]] = [None] * server.n_slots
        self.cache = server.slot_cache()
        self.d_cache = server.draft_slot_cache()
        self.pending: List[tuple] = []  # FIFO of (ticket, req, n_tokens)
        self.finished: Dict[int, Dict[str, Any]] = {}
        self._ticket = 0
        self.rounds = 0
        self.prefills = 0
        self.drafted = 0
        self.accepted = 0

    @property
    def decode_steps(self) -> int:
        """LMEngine's name for the decode dispatches: the rounds."""
        return self.rounds

    def _finalize(self, s: int) -> None:
        self._respond(s)
        self.slots[s] = None

    def _admit(self) -> None:
        srv = self.s
        for s in range(srv.n_slots):
            while self.slots[s] is None and self.pending:
                ticket, req, n_tokens = self.pending.pop(0)
                prompt = np.asarray(req["tokens"], np.int64).reshape(1, -1)
                logits, row_cache = srv._prefill(prompt)
                srv.admit(self.cache, row_cache, s)
                _, d_row = srv.d_prefill(prompt)
                srv.d_admit(self.d_cache, d_row, s)
                del row_cache, d_row
                self.prefills += 1
                st = _slot_state(ticket, req, n_tokens, prompt.shape[1],
                                 srv.vocab)
                self.slots[s] = st
                tok = _first_token(st, logits[:, -1], prompt.shape[1] - 1)
                # committed-token bookkeeping of the rounds: the absolute
                # count, the last token, the tokens the draft has not seen
                st.update(n_committed=prompt.shape[1], lag=[tok])
                _commit(st, [tok])
                if st["remaining"] <= 0:
                    self._finalize(s)

    def step(self) -> None:
        """One admission sweep + (if anything is active) one draft/verify
        round."""
        self._admit()
        srv, slots = self.s, self.slots
        active = [s for s in range(srv.n_slots) if slots[s] is not None]
        if not active:
            return
        cache = self.cache
        drafts, draws, t_logits = draft_and_verify(
            srv, slots, active, self.d_cache,
            lambda block, pos: srv.t_extend_rows(block, cache, pos))
        self.drafted += srv.k_draft * len(active)
        self.rounds += 1
        lp = _logprob_rows(slots, active, t_logits)
        for s in active:
            st = slots[s]
            j, commit = accepted_commit(drafts[s], draws[s], srv.k_draft)
            self.accepted += j
            # d_1..d_min(j, k-1) are in the draft cache already (they were
            # fed to propose the next); the rest is the next round's lag
            st["lag"] = commit[min(j, srv.k_draft - 1):]
            _commit(st, commit, None if lp is None else lp.get(s))
            if st["remaining"] <= 0:
                self._finalize(s)


def _logprob_rows(slots, active, t_logits) -> Optional[Dict[int, np.ndarray]]:
    """{slot: its verify logits [k + 1, V] on the host} for the active
    slots that asked for logprobs (fetched together), or None."""
    rows = [s for s in active if slots[s]["lps"] is not None]
    if not rows:
        return None
    got = t_logits[rows].float().cpu().numpy()
    return dict(zip(rows, got))


def _commit(st: Dict[str, Any], toks: Sequence[int],
            logits: Optional[np.ndarray] = None) -> int:
    """Append ``toks`` to a speculative slot's output, one at a time, with
    their logprobs from ``logits`` rows (when the slot asked); stop at an
    eos, a stop sequence or the budget. Returns how many were taken."""
    n = 0
    for i, tok in enumerate(toks):
        if logits is not None:
            st["lps"].append(token_logprob(logits[i], tok))
        st["out"].append(tok)
        st["remaining"] -= 1
        st["last"] = tok
        st["n_committed"] += 1
        n += 1
        if st["eos"] is not None and tok == st["eos"]:
            st["eos_hit"] = True
            st["remaining"] = 0
        check_stops(st)
        if st["remaining"] <= 0:
            break
    return n


class _DraftPool:
    """The draft model of a batched speculative pool (ContinuousLMServer,
    PagedLMServer): its continuous-batching calls and one dense [n_slots]
    draft cache, made once (the captured ``d_decode_rows`` is bound to
    it). Needs ``n_slots``, ``vocab``, ``window`` and ``device``."""

    draft = None
    k_draft = 0
    _d_slots = None

    def _load_draft(self, draft_dir, k_draft: int, device: Device) -> None:
        self.k_draft = int(k_draft)
        if draft_dir is None or self.k_draft <= 0:
            return
        (self.d_prefill, self.d_decode_rows, self.d_admit,
         self.d_meta) = load_exported_continuous(draft_dir, device)
        self.d_extend_rows = load_exported_extend_rows(draft_dir, device)
        if int(self.d_meta["vocab_size"]) != self.vocab:
            raise ValueError(
                f"draft vocab {self.d_meta['vocab_size']} != target vocab "
                f"{self.vocab}: speculative decoding needs a shared token "
                "space")
        self.window = min(self.window, int(
            self.d_meta.get("max_seq", self.d_meta["block_size"])))
        self.draft = draft_dir

    def draft_slot_cache(self):
        """The draft's [n_slots] cache, made once; ``d_admit`` replaces a
        row whole."""
        if self._d_slots is None:
            self._d_slots = zero_cache(self.d_meta, self.n_slots,
                                       self.device)
        return self._d_slots

    def _draft_slack(self) -> int:
        """Positions a verify block may write past the last committed
        token: rejected drafts' KV, masked but written, so the window (and
        the page budget) must hold them."""
        return self.k_draft if self.draft is not None else 0


def spec_stats(eng, k_draft: int) -> Dict[str, Any]:
    """A speculative engine's round statistics (the JAX package's keys)."""
    return {"rounds": eng.rounds, "drafted": eng.drafted,
            "accepted": eng.accepted, "k_draft": k_draft,
            "accept_rate": (round(eng.accepted / eng.drafted, 4)
                            if eng.drafted else None)}


class ContinuousLMServer(_DraftPool):
    """Continuous batching over the exported per-row-position calls.

    A fixed pool of ``n_slots`` rows decodes in lockstep, each at its own
    absolute position (``decode_rows`` takes pos [b]); a finished row is
    refilled mid-flight: the next request is prefilled at batch 1 and
    ``admit`` copies its cache into the row. Mixed prompt and generation
    lengths share one device batch. Outputs equal per-request
    ``generate_batch``, greedy and sampled (rows are independent; the
    sampled stream is a function of seed, prompt and position).
    ``k_decode`` > 0 advances every slot k tokens a dispatch through the
    fused ``decode_k_rows`` / ``decode_k_sample``.

    Speculation composes (``draft_dir`` + ``k_draft`` > 0, an alternative
    to ``k_decode``): every slot runs the draft/verify rounds of a
    SpecLMEngine in one device batch, each row verified at its own position
    through ``extend_rows``; acceptance is against the canonical stream, so
    greedy and sampled outputs stay the target-only ones. The window is the
    smaller of the two models'."""

    def __init__(self, artifacts_dir: Union[str, Path], n_slots: int = 8,
                 prefill_chunk: Optional[int] = None,
                 draft_dir: Optional[Union[str, Path]] = None,
                 k_draft: int = 0, k_decode: int = 0,
                 device: Device = None):
        if int(k_decode) > 0 and int(k_draft) > 0:
            raise ValueError(
                "k_decode (fused chunks) and k_draft (speculative "
                "draft/verify) are alternative decode loops: pick one")
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
        self._load_draft(draft_dir, k_draft, device)
        if self.draft is not None:
            self.t_extend_rows = load_exported_extend_rows(artifacts_dir,
                                                           device)

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
            slack = self._draft_slack()
            if t + n + slack > self.window:
                raise ValueError(
                    f"request {i}: prompt {t} + {n} new tokens "
                    + (f"+ {slack} draft slack " if slack else "")
                    + f"exceeds the exported serving window {self.window}")
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
        'logprobs'. Submit-all + drain over an LMEngine (a SpecLMEngine
        with a draft); every request is validated before any device work.
        Responses keep request order."""
        t_start = time.perf_counter()
        spec = self.draft is not None
        eng = (SpecLMEngine if spec else LMEngine)(self, default_new_tokens)
        tickets = [eng.submit(req) for req in requests]
        while eng.has_work():
            eng.step()
        dt = time.perf_counter() - t_start
        responses = [eng.finished[t] for t in tickets]
        n_generated = sum(r["n_generated"] for r in responses)
        steps = (dict(spec_stats(eng, self.k_draft),
                      target_passes=eng.rounds + eng.prefills) if spec else
                 {"decode_steps": eng.decode_steps,
                  "decode_bursts": eng.decode_bursts})
        self.last_stats = {
            **steps,
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


class SpeculativeLMServer:
    """Speculative decoding over two exported artifact sets, one request at
    a time: the draft (``load_exported_lm``: prefill, captured decode_step)
    proposes ``k_draft`` tokens, the target (``load_exported_speculative``:
    prefill, eager extend) verifies the block [last, d_1..d_k] in one pass,
    so the target runs about 1/(j + 1) passes a committed token, j the
    round's accepted count.

    A draft token is accepted iff it equals the canonical-stream draw on the
    target's logits at its absolute position (greedy: the argmax), and a
    rejection emits that draw: the output is exactly target-only decode's
    under the same seed and prompt, on every scheduler. The draft proposes
    through the same key schedule, so close distributions accept often.

    Rejected drafts leave KV at positions past the committed ones, hidden
    by the absolute-position mask until the next round's block overwrites
    them; rollback costs nothing. The draft's batch-1 cache belongs to the
    server (its captured decode_step is bound to it) and each request's
    draft prefill is copied into it. The target prompt may be chunked
    through ``chunked_prefill``; the draft prefills in one shot."""

    def __init__(self, target_dir: Union[str, Path],
                 draft_dir: Union[str, Path], k_draft: int = 4,
                 prefill_chunk: Optional[int] = None,
                 device: Device = None):
        (self.t_prefill, self.t_extend,
         self.meta) = load_exported_speculative(target_dir, device)
        self.d_prefill, self.d_decode, self.d_meta = load_exported_lm(
            draft_dir, device)
        self.device = torch.device(self.meta["device"])
        self.prefill_chunk = prefill_chunk
        if int(self.d_meta["vocab_size"]) != int(self.meta["vocab_size"]):
            raise ValueError(
                f"draft vocab {self.d_meta['vocab_size']} != target vocab "
                f"{self.meta['vocab_size']}: speculative decoding needs a "
                "shared token space")
        if int(k_draft) < 1:
            raise ValueError(f"k_draft must be >= 1, got {k_draft}")
        self.k_draft = int(k_draft)
        self.window = min(
            int(self.meta.get("max_seq", self.meta["block_size"])),
            int(self.d_meta.get("max_seq", self.d_meta["block_size"])))
        self.vocab = int(self.meta["vocab_size"])
        self.last_stats: Dict[str, Any] = {}
        self._d_cache = None

    def _draft_cache(self, row):
        """The server's batch-1 draft cache with ``row`` copied into it."""
        if self._d_cache is None:
            self._d_cache = zero_cache(self.d_meta, 1, self.device)
        for (ck, cv), (rk, rv) in zip(self._d_cache, row):
            ck.copy_(rk)
            cv.copy_(rv)
        return self._d_cache

    def _draw(self, logits, seed: int, pos0: int, temperature: float,
              top_k: Optional[int], top_p: Optional[float]):
        """Canonical-stream draws for a contiguous block: logits [m, V] at
        absolute fed-positions pos0..pos0+m-1 -> [m] int64 on their device.
        Greedy takes the first-max argmax."""
        x = logits.float()
        if temperature <= 0.0:
            return torch.argmax(x, dim=-1)
        m = x.shape[0]
        st = {"key": int(seed), "temperature": float(temperature),
              "top_k": top_k, "top_p": top_p}
        seeds, temp, topk, topp = _policy_vectors([st], [0], m, x.device)
        pos = torch.arange(pos0, pos0 + m, dtype=torch.int64,
                           device=x.device)
        return export_lm.sample_rows(x, seeds, pos, temp, topk, topp)

    def _generate(self, prompt: Sequence[int], n_tokens: int,
                  temperature: float, top_k: Optional[int], seed: int,
                  top_p: Optional[float] = None, eos: Optional[int] = None,
                  stops: Sequence[tuple] = (),
                  want_lps: bool = False) -> tuple:
        t = len(prompt)
        prompt_arr = np.asarray(prompt, np.int64).reshape(1, -1)
        c = self.prefill_chunk
        if c is not None and t > c:
            tg_logits, tg_cache = chunked_prefill(
                self.t_extend, self.meta, prompt_arr, c, self.device)
        else:
            tg_logits, tg_cache = self.t_prefill(prompt_arr)
        _, d_row = self.d_prefill(prompt_arr)
        dr_cache = self._draft_cache(d_row)
        del d_row
        # the slot schedulers' bookkeeping (_commit: eos, stops, logprobs)
        st = {"out": [], "remaining": n_tokens, "eos": eos, "eos_hit": False,
              "stops": list(stops), "lps": [] if want_lps else None,
              "n_committed": t}
        first = self._draw(tg_logits[0, -1:], seed, t - 1, temperature,
                           top_k, top_p)
        _commit(st, [int(first[0])],
                tg_logits[0, -1:].float().cpu().numpy() if want_lps else None)
        dr_done = t  # the draft cache holds positions 0..dr_done-1
        rounds = drafted = accepted = 0

        while st["remaining"] > 0:
            n_committed = st["n_committed"]
            k = min(self.k_draft, st["remaining"])
            # the draft ingests the committed tokens it has not seen (the
            # correction, and d_k after a full accept), then proposes k;
            # each draw reads the logits of the replay just made, before
            # the next replay overwrites them
            for pos in range(dr_done, n_committed):
                dr_logits, _ = self.d_decode([[st["out"][pos - t]]],
                                             dr_cache, pos)
            dr_done = n_committed
            drafts = []
            for i in range(k):
                d = self._draw(dr_logits[:, -1], seed, n_committed - 1 + i,
                               temperature, top_k, top_p)
                drafts.append(d)
                if i < k - 1:
                    dr_logits, _ = self.d_decode(d.view(1, 1), dr_cache,
                                                 dr_done + i)
            drafted += k
            # one target pass over [last, d_1..d_k], then the canonical
            # draws at all k + 1 positions
            drafts = torch.cat(drafts)
            block = torch.cat([torch.tensor([st["last"]],
                                            device=drafts.device),
                               drafts]).view(1, -1)
            tg_logits, _ = self.t_extend(block, tg_cache, n_committed - 1)
            draws = self._draw(tg_logits[0], seed, n_committed - 1,
                               temperature, top_k, top_p)
            both = torch.cat([drafts, draws]).cpu().numpy()
            j, commit = accepted_commit(both[:k], both[k:], k)
            accepted += j
            _commit(st, commit, tg_logits[0, :len(commit)].float().cpu()
                    .numpy() if want_lps else None)
            # drafts past d_{k-1} were never fed to the draft cache
            dr_done = n_committed + min(j, k - 1)
            rounds += 1

        stats = {"rounds": rounds, "drafted": drafted, "accepted": accepted,
                 "target_passes": rounds + 1}
        out = st["out"]
        return (out[:n_tokens], stats, st["eos_hit"],
                None if st["lps"] is None else st["lps"][:len(out)])

    def serve_requests(self, requests: Sequence[Dict[str, Any]],
                       default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """requests: dicts with 'tokens' and optional 'n_tokens',
        'temperature', 'top_k', 'top_p', 'seed', 'eos' (kept), 'stop'
        (excluded) and 'logprobs'. Served one at a time (the batched form
        is ContinuousLMServer(draft_dir=...)); responses in order. Each
        request is checked when its turn comes, as in the JAX package."""
        responses: List[Dict[str, Any]] = []
        totals = {"rounds": 0, "drafted": 0, "accepted": 0,
                  "target_passes": 0, "n_generated": 0}
        t_start = time.perf_counter()
        for i, req in enumerate(requests):
            if "tokens" not in req:
                raise ValueError(f"request {i}: missing 'tokens'")
            toks = np.asarray(req["tokens"], np.int64)
            n = int(req.get("n_tokens", default_new_tokens))
            # no draft slack: the batch-1 round shrinks its depth to the
            # budget left, so the verify block never writes past t + n - 1
            if len(req["tokens"]) + n > self.window:
                raise ValueError(
                    f"request {i}: prompt {len(req['tokens'])} + {n} new "
                    f"tokens exceeds the serving window {self.window} "
                    "(min of target and draft windows)")
            if toks.size and (toks.min() < 0 or toks.max() >= self.vocab):
                raise ValueError(
                    f"request {i}: token ids outside [0, {self.vocab})")
            try:
                stops = parse_stops(req, self.vocab)
            except ValueError as exc:
                raise ValueError(f"request {i}: {exc}") from None
            if n <= 0:
                responses.append({"tokens": [], "n_prompt": len(req["tokens"]),
                                  "n_generated": 0, "rounds": 0,
                                  "stopped_early": False,
                                  "accept_rate": None})
                continue
            out, stats, eos_hit, lps = self._generate(
                req["tokens"], n, float(req.get("temperature", 0.0)),
                req.get("top_k"), int(req.get("seed", 0)),
                top_p=req.get("top_p"), eos=req.get("eos"), stops=stops,
                want_lps=bool(req.get("logprobs")))
            resp = {
                "tokens": out,
                "n_prompt": len(req["tokens"]),
                "n_generated": len(out),
                "rounds": stats["rounds"],
                "stopped_early": eos_hit,
                "accept_rate": (round(stats["accepted"] / stats["drafted"], 4)
                                if stats["drafted"] else None),
            }
            if lps is not None:
                resp["logprobs"] = lps
            responses.append(resp)
            for key in stats:
                totals[key] += stats[key]
            totals["n_generated"] += len(out)
        dt = time.perf_counter() - t_start
        self.last_stats = {
            **totals,
            "n_requests": len(requests),
            "k_draft": self.k_draft,
            "accept_rate": (round(totals["accepted"] / totals["drafted"], 4)
                            if totals["drafted"] else None),
            "tokens_per_target_pass": (
                round(totals["n_generated"] / totals["target_passes"], 3)
                if totals["target_passes"] else None),
            "seconds": round(dt, 4),
            "tokens_per_sec": (round(totals["n_generated"] / dt, 2)
                               if dt > 0 else 0.0),
        }
        return responses

    def serve(self, requests: Sequence[Dict[str, Any]],
              default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """Scheduler-agnostic alias: hosts call either name."""
        return self.serve_requests(requests, default_new_tokens)


class OnlineLMServer:
    """Online continuous batching: a thread-safe front over one engine
    (LMEngine, SpecLMEngine with a draft, or ``scheduler="paged"``'s
    PagedLMEngine over ``n_pages``). Callers submit from any thread at any
    time; one scheduler thread drives the engine, so requests of different
    callers join one running device batch between steps. Each response
    equals the request's solo decode (rows are independent).

    Callers never touch the engine or the device: ``submit`` validates on
    the host and puts the request in an inbox, ``cancel`` takes it out of
    the inbox or leaves a cancellation for the scheduler, ``result`` waits
    for the response. The scheduler drains the inbox and the cancellations
    under the lock, then steps the engine outside it, so a caller waits at
    most one step for the lock, and every CUDA call (captures included)
    is made on the scheduler thread. A scheduler thread that raises makes
    every later ``submit``, ``cancel`` and ``result`` raise.
    ``default_new_tokens`` is fixed at construction (validation depends on
    it)."""

    def __init__(self, artifacts_dir: Union[str, Path], n_slots: int = 8,
                 prefill_chunk: Optional[int] = None, k_decode: int = 0,
                 draft_dir: Optional[Union[str, Path]] = None,
                 k_draft: int = 0, default_new_tokens: int = 64,
                 scheduler: str = "continuous", n_pages: int = 0,
                 device: Device = None):
        if scheduler == "paged":
            from tempo_tpu_torch.infer.paged import (PagedLMEngine,
                                                     PagedLMServer)

            self._server = PagedLMServer(
                artifacts_dir, n_slots=n_slots, n_pages=n_pages,
                k_decode=k_decode, draft_dir=draft_dir, k_draft=k_draft,
                prefill_chunk=prefill_chunk, device=device)
            engine_cls = PagedLMEngine
        elif scheduler == "continuous":
            self._server = ContinuousLMServer(
                artifacts_dir, n_slots=n_slots, prefill_chunk=prefill_chunk,
                k_decode=k_decode, draft_dir=draft_dir, k_draft=k_draft,
                device=device)
            engine_cls = (SpecLMEngine if self._server.draft is not None
                          else LMEngine)
        else:
            raise ValueError(f"unknown scheduler {scheduler!r} (continuous "
                             "| paged)")
        self.meta = self._server.meta
        self.vocab = self._server.vocab
        self.window = self._server.window
        self.default_new_tokens = int(default_new_tokens)
        self._engine = engine_cls(self._server, self.default_new_tokens)
        self._cond = threading.Condition()
        self._inbox: List[tuple] = []  # (ticket, request), FIFO
        self._cancels: Dict[int, Optional[bool]] = {}  # None: not applied
        self._done: Dict[int, Dict[str, Any]] = {}
        self._next_ticket = 0
        self._closing = False
        self._error: Optional[BaseException] = None
        self._stats = self._snapshot()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="lm-engine")
        self._thread.start()

    def _snapshot(self) -> Dict[str, Any]:
        e = self._engine
        out = {"decode_steps": e.decode_steps, "prefills": e.prefills,
               "pending": len(e.pending),
               "active": sum(st is not None for st in e.slots),
               "n_slots": self._server.n_slots}
        if self._server.draft is not None:
            out.update(spec_stats(e, self._server.k_draft))
        return out

    def _idle(self) -> bool:
        return not (self._inbox or None in self._cancels.values()
                    or self._engine.has_work())

    def _run(self) -> None:
        eng = self._engine
        to_engine: Dict[int, int] = {}  # ticket -> the engine's ticket
        to_online: Dict[int, int] = {}
        while True:
            with self._cond:
                while self._idle() and not self._closing:
                    self._cond.wait()
                if self._closing and self._idle():
                    return
                inbox, self._inbox = self._inbox, []
                cancels = [t for t, r in self._cancels.items() if r is None]
            try:
                for ticket, req in inbox:
                    et = eng.submit(req)
                    to_engine[ticket], to_online[et] = et, ticket
                applied = {t: t in to_engine and eng.cancel(to_engine[t])
                           for t in cancels}
                if eng.has_work():
                    eng.step()
            except BaseException as exc:  # noqa: BLE001 — a dead scheduler
                # must fail its callers, not leave them waiting
                with self._cond:
                    self._error = exc
                    self._closing = True
                    self._cond.notify_all()
                if not isinstance(exc, Exception):
                    raise  # an interrupt or an exit propagates
                return
            with self._cond:
                for et in list(eng.finished):
                    ticket = to_online.pop(et)
                    del to_engine[ticket]
                    self._done[ticket] = eng.finished.pop(et)
                self._cancels.update(applied)
                self._stats = self._snapshot()
                self._cond.notify_all()

    def _check_alive(self) -> None:
        if self._error is not None:
            raise RuntimeError("server scheduler died") from self._error
        if self._closing:
            raise RuntimeError("server is closed")

    def submit(self, req: Dict[str, Any]) -> int:
        """Validate (on the host) and enqueue; returns a ticket for
        ``result``. Raises if the server is closed or its scheduler died."""
        with self._cond:
            self._check_alive()
        self._server._validate([req], self.default_new_tokens)
        with self._cond:
            self._check_alive()
            ticket = self._next_ticket
            self._next_ticket += 1
            self._inbox.append((ticket, req))
            self._cond.notify_all()
            return ticket

    def cancel(self, ticket: int) -> bool:
        """Cancel a submitted request: one still queued never runs, an
        active one finalizes with the tokens generated so far; its response
        then carries ``cancelled: true``. Returns False if the ticket had
        already finished (its response untouched). Waits for the
        scheduler's next turn at most."""
        with self._cond:
            if ticket in self._done:
                return False
            for i, (t, req) in enumerate(self._inbox):
                if t == ticket:
                    del self._inbox[i]
                    self._done[t] = {
                        "tokens": [], "n_prompt": len(req["tokens"]),
                        "n_generated": 0, "slot": -1,
                        "stopped_early": False, "cancelled": True}
                    self._cond.notify_all()
                    return True
            if not 0 <= ticket < self._next_ticket:
                return False
            if self._error is not None:
                raise RuntimeError("server scheduler died") from self._error
            self._cancels.setdefault(ticket, None)
            self._cond.notify_all()
            self._cond.wait_for(
                lambda: self._cancels.get(ticket, False) is not None
                or self._error is not None)
            done = self._cancels.pop(ticket, False)
            if done is None:
                raise RuntimeError("server scheduler died") from self._error
            return done

    def result(self, ticket: int,
               timeout: Optional[float] = None) -> Dict[str, Any]:
        """Block until the ticket finishes; pops and returns its response.
        Raises TimeoutError after ``timeout`` seconds, and RuntimeError if
        the scheduler died before the ticket finished."""
        with self._cond:
            ok = self._cond.wait_for(
                lambda: ticket in self._done or self._error is not None,
                timeout=timeout)
            if not ok:
                raise TimeoutError(f"ticket {ticket} not finished within "
                                   f"{timeout}s")
            if ticket not in self._done:
                raise RuntimeError(
                    f"server scheduler died before ticket {ticket} "
                    "finished") from self._error
            return self._done.pop(ticket)

    def generate(self, req: Dict[str, Any],
                 timeout: Optional[float] = None) -> Dict[str, Any]:
        return self.result(self.submit(req), timeout=timeout)

    def serve_requests(self, requests: Sequence[Dict[str, Any]],
                       default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """Batch-mode compatibility: submit all, collect in order (the
        construction-time default_new_tokens governs, not this one)."""
        tickets = [self.submit(r) for r in requests]
        return [self.result(t) for t in tickets]

    serve = serve_requests

    def stats(self) -> Dict[str, Any]:
        """The engine's cumulative counters after its last step, with the
        requests still in the inbox counted as pending."""
        with self._cond:
            return dict(self._stats,
                        pending=self._stats["pending"] + len(self._inbox))

    @property
    def last_stats(self) -> Dict[str, Any]:
        """Hosts read ``last_stats``; here it is cumulative, not a call's."""
        return self.stats()

    def close(self, timeout: Optional[float] = None) -> None:
        """Finish the work submitted, then stop the scheduler thread."""
        with self._cond:
            self._closing = True
            self._cond.notify_all()
        self._thread.join(timeout)
