"""Paged-KV-cache serving: page allocator + slot scheduler.

Counterpart of tempo_tpu/infer/paged.py (``PagePool``, ``PagedLMServer``,
``PagedLMEngine``). The device holds per-layer pools [n_pages, page, kv,
hd] and a block table [n_slots, window / page]; ``PagePool`` hands pages to
rows on demand, so the slot count oversubscribes the pool, and when the
pool runs dry the most recently admitted slot is preempted (pages freed,
request requeued at the front). Re-admission replays the request from its
prompt: greedy trivially, and sampled requests too, because every draw is
the canonical stream of serving.device_sample (a pure function of seed,
position and logits). Decode runs K4 (ops/cuda_decode.py) through the
model's paged branch; prompts ingest through ``extend_paged``.

The server runs on exported artifacts (``artifacts_dir``, through the
loaders of infer/export_lm.py) or on a live surface (``surface=``,
``live_paged_surface``); both are the same calls, with the decode calls
captured as CUDA graphs on the card. The server owns its pools and one
static block table per row count, updated in place from the scheduler's
host table before each call, so a captured call sees the same tensors at
every replay.

Speculation composes (``draft_dir`` + ``k_draft``): a draft model with a
dense [n_slots] cache proposes k tokens a row and the paged target verifies
every row's block through ``extend_paged`` at the row's position
(serving.draft_and_verify); the pages the block writes (positions pos ..
pos + k) are reserved before the round, preempting if they must.

Two scheduler faults of the JAX package are not carried over: a
cancelled pending request leaves no trace in ``preempted_tickets``, and a
drain-chained burst falls back to one chunk when its page reservation had
to preempt a slot.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer import export_lm, serving
from tempo_tpu_torch.infer.serving import (_commit, _DraftPool,
                                            _first_token, _logprob_rows,
                                            _slot_state, _TicketEngine,
                                            accepted_commit, check_stops,
                                            draft_and_verify, parse_stops,
                                            spec_stats, token_logprob)

TRASH_PAGE = 0


def _pages_for(n_tokens: int, page: int) -> int:
    """ceil(n_tokens / page)."""
    return -(-n_tokens // page)


class PagePool:
    """Refcounting free-list page allocator. Page 0 is the trash page:
    never handed out, it absorbs the writes of parked rows and of table
    slots past a row's allocation (the absolute-position mask hides what
    lives there). Refcounts exist for prefix sharing: page-aligned prefix
    pages sit in many rows' tables at once and return to the free list
    when the last holder lets go."""

    def __init__(self, n_pages: int):
        assert n_pages >= 2, f"need >= 2 pages (1 is trash), got {n_pages}"
        self.n_pages = int(n_pages)
        # LIFO keeps recently freed pages hot; ids 1..n_pages-1
        self._free = list(range(1, self.n_pages))
        self._rc: Dict[int, int] = {}

    @property
    def n_usable(self) -> int:
        return self.n_pages - 1

    @property
    def n_free(self) -> int:
        return len(self._free)

    def alloc(self) -> Optional[int]:
        if not self._free:
            return None
        p = self._free.pop()
        self._rc[p] = 1
        return p

    def share(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert p in self._rc, f"sharing unheld page {p}"
            self._rc[p] += 1

    def free(self, pages: Sequence[int]) -> None:
        for p in pages:
            assert p != TRASH_PAGE, "freeing the trash page"
            assert p in self._rc, f"double free of page {p}"
            self._rc[p] -= 1
            if self._rc[p] == 0:
                del self._rc[p]
                self._free.append(p)


class PagedLMServer(_DraftPool):
    """Continuous batching over a paged KV cache with preemption.

    ``artifacts_dir`` is an export with ``page_size`` > 0, loaded on
    ``device`` (None means CUDA); or ``surface`` is
    ``live_paged_surface(model, ...)``, and ``device`` must be its. A
    request of total length L holds ceil(L / page_size) pages; ``n_pages``
    sizes the pool (usable pages = n_pages - 1; default: no
    oversubscription). ``k_decode`` > 0 dispatches fused k-token chunks
    (pages pre-reserved); ``prefill_chunk`` ingests long prompts through
    extend_paged in fixed chunks; ``draft_dir`` + ``k_draft`` > 0 (instead
    of ``k_decode``) runs speculative rounds, every request's page budget
    holding the k_draft positions a verify block may write past it."""

    def __init__(self, artifacts_dir=None, n_slots: int = 8,
                 n_pages: int = 0, k_decode: int = 0, draft_dir=None,
                 k_draft: int = 0, prefill_chunk: Optional[int] = None,
                 surface: Optional[Dict[str, Any]] = None,
                 device: Union[str, torch.device, None] = None):
        if int(k_decode) > 0 and int(k_draft) > 0:
            raise ValueError(
                "k_decode (fused chunks) and k_draft (speculative "
                "draft/verify) are alternative decode loops: pick one")
        if (artifacts_dir is None) == (surface is None):
            raise ValueError("pass artifacts_dir or surface="
                             "live_paged_surface(model, ...), one of them")
        if artifacts_dir is not None:
            surface = _artifact_surface(artifacts_dir, k_decode, device)
        dev = resolve_device(device)
        self.decode_paged = surface["decode_paged"]
        self.extend_paged = surface["extend_paged"]
        self.meta = surface["meta"]
        sdev = torch.device(self.meta["device"])
        if sdev.type != dev.type or dev.index not in (None, sdev.index):
            raise ValueError(f"the surface is on {sdev}, the server on {dev}")
        self.device = sdev
        assert n_slots >= 1, n_slots
        self.n_slots = int(n_slots)
        self.k_decode = int(k_decode)
        self.decode_paged_k = self.decode_paged_k_sample = None
        if self.k_decode > 0:
            self.decode_paged_k = surface["decode_paged_k"]
            self.decode_paged_k_sample = surface["decode_paged_k_sample"]
            k_art = int(self.meta["decode_chunk"])
            assert self.k_decode == k_art, (
                f"the surface was built with decode_chunk={k_art}, the "
                f"scheduler asked for k_decode={self.k_decode}")
        # page-aligned shared-prefix registry: tuple(full-page tokens) ->
        # pool pages holding their KV (refcounted; the base count 1 keeps
        # them resident across requests, idle entries evictable)
        self._prefix_pages: Dict[tuple, List[int]] = {}
        self._prefix_hits = 0
        self.window = int(self.meta.get("max_seq", self.meta["block_size"]))
        self.vocab = int(self.meta["vocab_size"])
        self.page = int(self.meta["page_size"])
        self.fused_lps = bool(self.meta.get("decode_k_logprobs"))
        self.mp = self.window // self.page
        self.pool = PagePool(n_pages or self.n_slots * self.mp + 1)
        self.last_stats: Dict[str, Any] = {}
        kv = int(self.meta.get("n_kv_head") or self.meta["n_head"])
        hd = int(self.meta["n_embd"]) // int(self.meta["n_head"])
        dt = getattr(torch, self.meta["compute_dtype"])
        shape = (self.pool.n_pages, self.page, kv, hd)
        # one pair of pools per layer, updated in place by the surface
        self._pools = [(torch.zeros(shape, dtype=dt, device=self.device),
                        torch.zeros(shape, dtype=dt, device=self.device))
                       for _ in range(int(self.meta["n_layer"]))]
        self._tables: Dict[int, torch.Tensor] = {}  # rows -> block table
        self.prefill_chunk = (int(prefill_chunk)
                              if prefill_chunk else None)
        self._load_draft(draft_dir, k_draft, device)

    def _validate(self, requests: Sequence[Dict[str, Any]],
                  default_new_tokens: int) -> None:
        for i, req in enumerate(requests):
            if "tokens" not in req:
                raise ValueError(f"request {i}: missing 'tokens'")
            pfx = list(req.get("prefix") or ())
            t = len(req["tokens"]) + len(pfx)
            n = int(req.get("n_tokens", default_new_tokens))
            slack = self._draft_slack()
            if t + n + slack > self.window:
                raise ValueError(
                    f"request {i}: prompt {t} + {n} new tokens "
                    + (f"+ {slack} draft slack " if slack else "")
                    + f"exceeds the serving window {self.window}")
            need = _pages_for(t + n + slack, self.page)
            if need > self.pool.n_usable:
                raise ValueError(
                    f"request {i}: needs {need} pages but the pool holds "
                    f"{self.pool.n_usable}")
            toks = np.asarray(pfx + list(req["tokens"]), np.int64)
            if toks.size and (toks.min() < 0 or toks.max() >= self.vocab):
                raise ValueError(
                    f"request {i}: token ids outside [0, {self.vocab})")
            try:
                parse_stops(req, self.vocab)
            except ValueError as exc:
                raise ValueError(f"request {i}: {exc}") from None

    def _cache(self, table: np.ndarray):
        """The paged cache through this server's static block table for
        len(table) rows, updated in place from ``table``."""
        t = self._tables.get(len(table))
        if t is None:
            t = torch.zeros(table.shape, dtype=torch.int32,
                            device=self.device)
            self._tables[len(table)] = t
        t.copy_(torch.from_numpy(np.ascontiguousarray(table, np.int32)))
        return tuple((pk, pv, t) for pk, pv in self._pools)

    def _ingest_row(self, table: np.ndarray, s: int, toks: np.ndarray,
                    pos0: int):
        """Feed ``toks`` into row s's (pre-allocated) pages through
        extend_paged at absolute positions pos0.., in chunks of
        prefill_chunk when set. Returns the last chunk's logits
        [1, c, V]."""
        toks = np.asarray(toks, np.int64).reshape(-1)
        c = self.prefill_chunk or len(toks)
        logits = None
        for off in range(0, len(toks), c):
            part = toks[off:off + c]
            logits, _ = self.extend_paged(
                part.reshape(1, -1), self._cache(table[s:s + 1]),
                np.asarray([pos0 + off], np.int32))
        return logits

    def _auto_prefixes(self, requests: Sequence[Dict[str, Any]]
                       ) -> Dict[int, tuple]:
        """Automatic prefix sharing: request index -> the page-aligned
        token prefix to share, detected without any 'prefix' field. A
        request is a candidate when its prompt's aligned head is already in
        the registry or shared with another request of this batch (sorting
        the prompts puts the longest common prefix of any pair between
        sorted neighbours). Sharers of one batch get the same aligned
        length, capped so each keeps one private token to prefill. Explicit
        'prefix' fields win."""
        out: Dict[int, tuple] = {}
        toks_of = []
        for i, r in enumerate(requests):
            if r.get("prefix") or not r.get("tokens"):
                continue
            toks_of.append((i, tuple(int(x) for x in r["tokens"])))
        toks_of.sort(key=lambda kv: kv[1])

        pair_lcp = []
        for j in range(len(toks_of) - 1):
            t, u = toks_of[j][1], toks_of[j + 1][1]
            m = min(len(t) - 1, len(u) - 1)
            c = 0
            while c < m and t[c] == u[c]:
                c += 1
            pair_lcp.append((c // self.page) * self.page)

        # a run of neighbours sharing >= 1 aligned page takes ONE key: the
        # run's minimum adjacent LCP (per-request maxima would build
        # duplicate registry entries holding identical KV)
        j = 0
        while j < len(pair_lcp):
            if pair_lcp[j] < self.page:
                j += 1
                continue
            e = j
            while e < len(pair_lcp) and pair_lcp[e] >= self.page:
                e += 1
            length = min(pair_lcp[j:e])
            for i, t in toks_of[j:e + 1]:
                out[i] = t[:length]
            j = e + 1

        # a longer key already in the registry wins (it builds nothing)
        for i, t in toks_of:
            max_l = ((len(t) - 1) // self.page) * self.page
            have = len(out.get(i, ()))
            for length in range(max_l, have, -self.page):
                if t[:length] in self._prefix_pages:
                    out[i] = t[:length]
                    break
        return out

    def _prefix_registry(self, key: tuple) -> List[int]:
        """Pool pages holding the KV of ``key`` (a page-aligned token
        tuple), built once through a 1-row table in prefill_chunk pieces."""
        pages = self._prefix_pages.get(key)
        if pages is not None:
            self._prefix_hits += 1
            return pages
        n_full = len(key) // self.page
        pages = []
        for _ in range(n_full):
            p = self.pool.alloc()
            assert p is not None, "registry build must be gated on n_free"
            pages.append(p)
        tab = np.zeros((1, self.mp), np.int32)
        tab[0, :n_full] = pages
        c = self.prefill_chunk or len(key)
        toks = np.asarray(key, np.int64)
        for off in range(0, len(key), c):
            self.extend_paged(toks[off:off + c].reshape(1, -1),
                              self._cache(tab), np.asarray([off], np.int32))
        self._prefix_pages[key] = pages
        return pages

    def serve(self, requests: Sequence[Dict[str, Any]],
              default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        """Requests: 'tokens' plus optional 'n_tokens' / 'temperature' /
        'top_k' / 'top_p' / 'seed' / 'eos' / 'stop' / 'logprobs' /
        'prefix'; responses keep request order. Submit-all + drain over a
        PagedLMEngine; every request is validated before any device work."""
        t_start = time.perf_counter()
        eng = PagedLMEngine(self, default_new_tokens)
        tickets = [eng.submit(req) for req in requests]
        while eng.has_work():
            eng.step()
        dt = time.perf_counter() - t_start
        responses = [eng.finished[t] for t in tickets]
        n_generated = sum(r["n_generated"] for r in responses)
        self.last_stats = {
            **eng.stats(),
            "n_requests": len(requests),
            "n_slots": self.n_slots,
            "n_generated": n_generated,
            "seconds": round(dt, 4),
            "tokens_per_sec": round(n_generated / dt, 2) if dt > 0 else 0.0,
        }
        return responses

    def serve_requests(self, requests: Sequence[Dict[str, Any]],
                       default_new_tokens: int = 64) -> List[Dict[str, Any]]:
        return self.serve(requests, default_new_tokens)


def _artifact_surface(artifacts_dir, k_decode: int,
                      device) -> Dict[str, Any]:
    """PagedLMServer's surface dict from an exported artifact directory."""
    prefill, decode_paged, admit_paged, meta = export_lm.load_exported_paged(
        artifacts_dir, device)
    surface = {"prefill": prefill, "decode_paged": decode_paged,
               "admit_paged": admit_paged,
               "extend_paged": export_lm.load_exported_extend_paged(
                   artifacts_dir, device),
               "meta": meta}
    if k_decode > 0:
        (surface["decode_paged_k"], surface["decode_paged_k_sample"],
         _) = export_lm.load_exported_paged_k(artifacts_dir, device)
    return surface


class PagedLMEngine(_TicketEngine):
    """Stepper form of the paged continuous-batching loop: submit /
    has_work / step / finished / cancel. One step() = one admission sweep
    + one decode quantum (a speculative round with a draft, a fused
    k-token burst when the surface allows it, a per-token dispatch
    otherwise). Not thread-safe."""

    def __init__(self, server: PagedLMServer,
                 default_new_tokens: int = 64):
        self.s = server
        self.default_new_tokens = int(default_new_tokens)
        b = server.n_slots
        self.slots: List[Optional[Dict[str, Any]]] = [None] * b
        self.pos = np.zeros(b, np.int32)
        self.toks = np.zeros((b, 1), np.int32)
        self.table = np.zeros((b, server.mp), np.int32)
        self.pages_of: List[List[int]] = [[] for _ in range(b)]
        self.shared_of: List[List[int]] = [[] for _ in range(b)]
        # the draft's dense cache (speculation): rows admitted whole
        self.d_cache = (server.draft_slot_cache()
                        if server.draft is not None else None)
        self.pending: List[tuple] = []  # FIFO of (ticket, req, n_tokens)
        self.finished: Dict[int, Dict[str, Any]] = {}
        self._ticket = 0
        self.admit_serial = 0
        # requests preempted once re-admit only when their FULL remaining
        # page need fits the free pool: preemption loses all progress, so
        # cheap re-admission could ping-pong two growing rows forever
        self.preempted_tickets: set = set()
        self.decode_steps = 0
        self.decode_bursts = 0  # host syncs on the fused path
        self.prefills = 0
        self.preemptions = 0
        self.rounds = self.drafted = self.accepted = 0
        self.peak_pages = 0
        self.auto_tickets: set = set()  # requests with a detected head
        self._auto_cache: tuple = ((), {})
        self._hits0 = server._prefix_hits  # per-engine registry hits

    def stats(self) -> Dict[str, Any]:
        s = self.s
        out = {
            "decode_steps": self.decode_steps,
            "decode_bursts": self.decode_bursts,
            "prefills": self.prefills,
            "preemptions": self.preemptions,
            "peak_pages": self.peak_pages,
            "prefix_hits": s._prefix_hits - self._hits0,
            "auto_prefixes": len(self.auto_tickets),
            "shared_prefix_pages": sum(len(p) for p in
                                       s._prefix_pages.values()),
            "n_pages": s.pool.n_usable,
        }
        if s.draft is not None:
            out.update(spec_stats(self, s.k_draft))
        return out

    # ---------------------------------------------- page bookkeeping
    def _forget(self, ticket: int) -> None:
        self.preempted_tickets.discard(ticket)

    def _release(self, s: int) -> None:
        pool = self.s.pool
        pool.free(self.pages_of[s])
        # shared-prefix pages: drop this row's refcount; the registry's
        # base count keeps them resident for the next hit
        pool.free(self.shared_of[s])
        self.pages_of[s] = []
        self.shared_of[s] = []
        self.table[s] = TRASH_PAGE
        self.slots[s] = None
        self.pos[s] = 0
        self.toks[s, 0] = 0

    def _evict_idle_prefix(self, keep: Optional[tuple] = None) -> bool:
        """Free a registry entry no live row uses (all refcounts at the
        registry's base 1), except ``keep``. Last-resort pressure valve."""
        pool = self.s.pool
        for key, pages in list(self.s._prefix_pages.items()):
            if key == keep:
                continue
            if all(pool._rc.get(p) == 1 for p in pages):
                pool.free(pages)
                del self.s._prefix_pages[key]
                return True
        return False

    def _finalize(self, s: int) -> None:
        self._respond(s)
        self._forget(self.slots[s]["ticket"])
        self._release(s)

    def _preempt_one(self, exclude: int) -> bool:
        """Evict the most recently admitted slot other than ``exclude``:
        pages freed, request requeued at the front. False if there is
        nobody to evict."""
        victim = None
        for s in range(self.s.n_slots):
            if s == exclude or self.slots[s] is None:
                continue
            if victim is None or \
                    self.slots[s]["serial"] > self.slots[victim]["serial"]:
                victim = s
        if victim is None:
            return False
        st = self.slots[victim]
        self.pending.insert(0, (st["ticket"], st["request"],
                                st["n_tokens"]))
        self.preempted_tickets.add(st["ticket"])
        self._release(victim)
        self.preemptions += 1
        return True

    def _ensure_page(self, s: int, logical: int) -> None:
        """Allocate row s's logical page, preempting (then evicting idle
        shared prefixes) until one frees up."""
        if self.table[s, logical] != TRASH_PAGE:
            return
        pool = self.s.pool
        while True:
            p = pool.alloc()
            if p is not None:
                self.table[s, logical] = p
                self.pages_of[s].append(p)
                return
            if self._preempt_one(exclude=s) or self._evict_idle_prefix():
                continue
            raise RuntimeError(
                "page pool exhausted with nothing left to preempt "
                f"or evict — raise n_pages (usable {pool.n_usable})")

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

    # ------------------------------------------------------ admission
    def _admit(self) -> None:
        srv = self.s
        for s in range(srv.n_slots):
            while self.slots[s] is None and self.pending:
                # automatic prefix sharing over what is pending now plus
                # the cross-call registry, recomputed only when the
                # pending sequence changes
                ck = tuple(t for t, _, _ in self.pending)
                if self._auto_cache[0] != ck:
                    self._auto_cache = (ck, srv._auto_prefixes(
                        [req for _, req, _ in self.pending]))
                auto = self._auto_cache[1]
                ticket, nxt, n_tokens = self.pending[0]
                pfx = tuple(nxt.get("prefix") or ())
                body = list(nxt.get("tokens") or ())
                auto_hit = False
                if not pfx and 0 in auto:
                    pfx = auto[0]
                    body = body[len(pfx):]
                    auto_hit = True
                n_full = len(pfx) // srv.page
                key = pfx[:n_full * srv.page]
                build = n_full if (n_full and
                                   key not in srv._prefix_pages) else 0
                total = len(pfx) + len(body)
                if ticket in self.preempted_tickets:
                    # full-lifetime need (see preempted_tickets above)
                    life = total + n_tokens + srv._draft_slack()
                    private = max(_pages_for(life, srv.page) - n_full, 1)
                else:
                    private = max(_pages_for(total, srv.page) - n_full, 1)
                # idle registry prefixes hold pool capacity across calls:
                # evict them before concluding the pool is too tight
                while (build + private > srv.pool.n_free
                       and self._evict_idle_prefix(
                           keep=key if n_full else None)):
                    pass
                if build + private > srv.pool.n_free:
                    return  # wait for pages instead of thrashing
                self.pending.pop(0)
                if auto_hit:
                    self.auto_tickets.add(ticket)
                if n_full:
                    shared = srv._prefix_registry(key)
                    srv.pool.share(shared)
                    self.shared_of[s] = list(shared)
                    self.table[s, :n_full] = shared
                for j in range(n_full,
                               max(_pages_for(total, srv.page), 1)):
                    self._ensure_page(s, j)
                # prefix tail + prompt body straight into the row's pages
                # (chunked when prefill_chunk is set)
                ingest = np.asarray(list(pfx[n_full * srv.page:]) + body,
                                    np.int64)
                logits = srv._ingest_row(self.table, s, ingest,
                                         n_full * srv.page)
                if srv.draft is not None:
                    # the draft sees the full context (prefix + prompt) in
                    # its own dense cache
                    _, d_row = srv.d_prefill(np.asarray(
                        list(pfx) + body, np.int64).reshape(1, -1))
                    srv.d_admit(self.d_cache, d_row, s)
                    del d_row
                self.prefills += 1
                st = _slot_state(ticket, nxt, n_tokens, len(nxt["tokens"]),
                                 srv.vocab)
                st.update(request=nxt, n_tokens=n_tokens,
                          serial=self.admit_serial)
                self.admit_serial += 1
                self.slots[s] = st
                self.pos[s] = total  # prefix + prompt (abs decode pos)
                tok = _first_token(st, logits[:, -1], total - 1)
                # the speculative rounds' bookkeeping
                st.update(last=tok, lag=[tok], n_committed=total + 1)
                self._push(s, st, np.asarray([[tok]]))

    # ------------------------------------------------------ decoding
    def step(self) -> None:
        """One admission sweep + (if anything is active) one decode
        quantum: a fused burst or a per-token dispatch."""
        self._admit()
        srv = self.s
        b = srv.n_slots
        slots, pos, toks, table = (self.slots, self.pos, self.toks,
                                   self.table)
        if not any(st is not None for st in slots):
            if self.pending:
                # every slot idle yet nothing admitted: only idle
                # registry prefixes can hold pages — evict one and retry
                if not self._evict_idle_prefix():
                    raise RuntimeError(
                        "scheduler stalled with free slots")
            return

        if srv.draft is not None:
            self._spec_round()
            return
        k = srv.k_decode
        active = [s for s in range(b) if slots[s] is not None]
        if (srv.decode_paged_k is not None
                and (srv.fused_lps
                     or not any(slots[s]["lps"] is not None
                                for s in active))
                and all(pos[s] + k <= srv.window for s in active)):
            self._fused_step(active, k)
            return

        # per-token path: the coming dispatch writes each row at pos[s]
        for s in range(b):
            if slots[s] is not None:
                self._ensure_page(s, int(pos[s]) // srv.page)
        self.peak_pages = max(
            self.peak_pages, srv.pool.n_usable - srv.pool.n_free)
        logits, _ = srv.decode_paged(toks, srv._cache(table), pos)
        logits_dev = logits[:, -1]  # stays on the device for the draw
        self.decode_steps += 1
        live = [s for s in range(b) if slots[s] is not None]
        keys, temp, topk, topp = self._policy_arrays(live)
        drawn = serving.device_sample(logits_dev, keys, pos.copy(), temp,
                                      topk, topp)
        # logprob rows fetch lazily and together
        lp_rows = [s for s in live if slots[s]["lps"] is not None]
        lp_np = (logits_dev[lp_rows].float().cpu().numpy()
                 if lp_rows else None)
        for s in live:
            st = slots[s]
            if st["lps"] is not None:
                st["lps"].append(token_logprob(
                    lp_np[lp_rows.index(s)], int(drawn[s, 0])))
            pos[s] += 1
            self._push(s, st, drawn[s:s + 1])

    def _fused_step(self, active: List[int], k: int) -> None:
        """Fused k-token dispatch over the paged cache: the pages the k
        writes may touch are reserved before it, with drain chaining gated
        also on the burst's page appetite fitting the free pool. If the
        reservation still had to preempt a slot, the burst falls back to
        one chunk so the requeued request is re-admitted at the next
        step."""
        srv = self.s
        slots, pos, table = self.slots, self.pos, self.table
        chains = self._chain_gate(active, k, srv.window)

        def burst_pages(extra_k: int) -> int:
            need = 0
            for s in active:
                for j in range(int(pos[s]) // srv.page,
                               (int(pos[s]) + extra_k - 1) // srv.page + 1):
                    if table[s, j] == TRASH_PAGE:
                        need += 1
            return need

        while chains > 1 and burst_pages(chains * k) > srv.pool.n_free:
            chains -= 1
        preempted = self.preemptions
        for s in active:
            if slots[s] is None:
                continue  # preempted by an earlier _ensure_page
            for j in range(int(pos[s]) // srv.page,
                           (int(pos[s]) + chains * k - 1) // srv.page + 1):
                self._ensure_page(s, j)
        if self.preemptions != preempted:
            chains = 1
        active = [s for s in range(srv.n_slots) if slots[s] is not None]
        self.peak_pages = max(
            self.peak_pages, srv.pool.n_usable - srv.pool.n_free)
        all_greedy = all(slots[s]["temperature"] == 0.0 for s in active)
        policy = None if all_greedy else self._policy_arrays(active)

        cache = srv._cache(table)  # the table holds still during a burst
        if policy is not None:
            policy = tuple(torch.as_tensor(a).to(srv.device) for a in policy)

        def dispatch(tok_dev, pos_dev):
            if all_greedy:
                chunk, lps, _ = srv.decode_paged_k(tok_dev, cache, pos_dev)
            else:
                chunk, lps, _ = srv.decode_paged_k_sample(
                    tok_dev, cache, pos_dev, *policy)
            return chunk, lps

        self._run_burst(active, k, chains, dispatch)

    def _spec_round(self) -> None:
        """A speculative round over the paged cache: the pages of positions
        pos .. pos + k_draft of every row are reserved first (preempting
        if they must), then serving.draft_and_verify with the target's
        verify through ``extend_paged`` at per-row positions (rejected
        drafts' KV is masked, then overwritten), then each row commits its
        accepted drafts and the next canonical draw."""
        srv = self.s
        slots, pos, k = self.slots, self.pos, srv.k_draft
        for s in range(srv.n_slots):
            for j in range(int(pos[s]) // srv.page,
                           (int(pos[s]) + k) // srv.page + 1):
                if slots[s] is None:
                    break  # parked, or preempted by an earlier reservation
                self._ensure_page(s, j)
        active = [s for s in range(srv.n_slots) if slots[s] is not None]
        if not active:
            return  # everyone preempted: re-admission at the next step
        self.peak_pages = max(
            self.peak_pages, srv.pool.n_usable - srv.pool.n_free)
        cache = srv._cache(self.table)  # the table holds still this round
        drafts, draws, t_logits = draft_and_verify(
            srv, slots, active, self.d_cache,
            lambda block, p: srv.extend_paged(block, cache, p))
        self.drafted += k * len(active)
        self.decode_steps += 1
        self.rounds += 1
        lp = _logprob_rows(slots, active, t_logits)
        for s in active:
            st = slots[s]
            j, commit = accepted_commit(drafts[s], draws[s], k)
            self.accepted += j
            st["lag"] = commit[min(j, k - 1):]
            pos[s] += _commit(st, commit, None if lp is None else lp.get(s))
            if st["remaining"] <= 0:
                self._finalize(s)
            else:
                self.toks[s, 0] = st["last"]
