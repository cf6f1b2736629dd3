"""Host-side serving policy shared by the LM schedulers.

Counterpart of the pieces of tempo_tpu/infer/serving.py that the paged
server (infer/paged.py) uses: support truncation, stop sequences, raw-model
logprobs, the canonical sampled stream ``device_sample``, and the ticket
plumbing of ``_TicketEngine``. The numpy helpers are copies of the JAX
package's (that module imports JAX at load).

Not ported yet: the bucketed ``LMServer``, ``ContinuousLMServer`` with its
``LMEngine`` / ``SpecLMEngine``, ``SpeculativeLMServer``, ``OnlineLMServer``
and beam search.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from tempo_tpu_torch.infer import export_lm


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
        (tokens [b, k], logprobs [b, k])``, both on the device."""
        dev = self.s.device
        burst = []
        tok_dev = torch.as_tensor(self.toks, dtype=torch.int64).to(dev)
        pos_base = self.pos.copy()
        for c in range(chains):
            pos_dev = torch.as_tensor(pos_base + c * k).to(dev)
            chunk, lps = dispatch(tok_dev, pos_dev)
            burst.append((chunk, lps))
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
