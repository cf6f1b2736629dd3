"""Export of a trained GPT for serving as ``torch.export`` programs, their
loaders, the serving calls over a live model, and the on-device sampling
policy.

Counterpart of tempo_tpu/infer/export_lm.py. ``export_lm`` writes an
artifact directory that a serving host runs with NO model code:

  <program>.pt2  one ``torch.export`` program for each program of the JAX
                 package's export, under the same names: ``prefill``,
                 ``decode_step``, ``decode_rows``, ``admit``, ``extend``,
                 ``extend_rows``; with ``decode_chunk`` > 0 ``decode_k``,
                 ``decode_k_rows``, ``decode_k_sample``; with
                 ``page_size`` > 0 ``decode_paged``, ``admit_paged``,
                 ``extend_paged``; with both ``decode_paged_k``,
                 ``decode_paged_k_sample``
  weights.pt     the weights, once, each in the type its use reads
                 (nn/transformer.py ``serving_copy``)
  meta.json      the JAX package's meta keys, ``"format": "torch.export"``,
                 ``"devices"`` in place of ``"platforms"``, the weights'
                 names in the programs' order, the programs written, and
                 the whole ``TransformerConfig`` under ``config`` (read by
                 nothing that loads)

The symbolic dimensions are JAX's: the batch everywhere, the prompt length
``t <= max_seq`` of ``prefill``, the block length ``k <= max_seq`` of the
``extend`` calls, and the pool's page count ``P``. Where JAX bakes the
weights into every program, the port's programs take them as their first
input (a tuple, traced through ``torch.func.functional_call``), so the
directory and a device hold them once, whatever number of programs is
loaded. K3 and K4 are the ops ``tempo::decode_attention`` and
``tempo::paged_decode_attention`` in the programs (ops/cuda_decode.py):
their CPU kernels are the plain versions and their CUDA kernels the
hand-written ones, so one artifact serves both devices, whichever device
exported it (``"devices"``); a program is moved to its device at load
(``move_to_device_pass``), as infer/export_codec.py does.

A ``quantize='int8'`` model (nn/quant.py) exports as it is: its int8
kernels are in the weights' tuple and ``weights.pt``, its scales in the
compute type, and each program dequantizes at the read, as the live model
does; ``meta.json`` says ``quantize`` and ``n_experts``. An MoE model is
refused (NotImplementedError): its expert capacity needs the call's token
count, which the programs keep symbolic, and the JAX package's export
fails there too.

The fused family (``decode_k``, ``decode_k_rows``, ``decode_k_sample``,
``decode_paged_k``, ``decode_paged_k_sample``) is exported as ONE step of
its body (the model step, the argmax or the on-device draw, the chosen
token's logprob); the loaders run ``decode_chunk`` of them in one call,
which on CUDA is one captured graph, as JAX's scan is one dispatch.

The loaders (``load_exported_*``, ``zero_cache``, ``greedy_decode_exported``)
keep the JAX contracts: the same calls, arguments and returns, with
``device=None`` meaning CUDA. They import the op registrations and nothing
of the model (nn/). Loads of one artifact directory on one device share
one surface, so a server that calls four loaders holds the weights once.
What differs on the device:

- The fixed-shape decode calls (``decode_step``, ``decode_rows``,
  ``decode_k``, ``decode_k_rows``, ``decode_k_sample``, ``decode_paged``,
  ``decode_paged_k``, ``decode_paged_k_sample``) are captured as CUDA
  graphs (infer/graphs.py), one per (call, batch, k, cache), and replayed:
  a ``decode_k`` of K model steps is one replay. Their outputs are the
  graph's static tensors, valid until the same call's next replay.
- ``prefill`` and ``extend`` / ``extend_rows`` / ``extend_paged``, whose
  lengths are symbolic, run eagerly (one graph per length would not pay
  for a call made once a request), and so do ``admit`` / ``admit_paged``,
  which are copies.
- Caches are updated IN PLACE and returned (JAX returns new arrays): the
  programs write the caller's cache tensors, so a server keeps its caches
  for its lifetime and copies prefilled rows into them.
- Sampled rows are keyed by integer seeds [b] instead of threefry keys.

On the CPU nothing is captured: the same calls run eagerly. The live
surface (``live_paged_surface``) runs the same bodies over a live model.

Sampling: JAX draws from threefry keys folded with the absolute position;
that stream cannot be reproduced in torch. What is kept is its property:
the draw is a pure function of (request seed, absolute position of the fed
token, logits, policy), so every scheduler, chunk size and preemption
replay emits the same stream. The draw is a Gumbel-max over the truncated
logits with uniforms from SplitMix64 of (seed, position, vocabulary
index), computed with int64 tensor ops on the logits' device: the same
bits on the CPU and on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time
import weakref
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.graphs import GraphSet, cache_key
# The op registrations a loaded program needs (K3/K4; ops/cuda_gn.py with
# them); no model code.
from tempo_tpu_torch.ops import cuda_decode  # noqa: F401

Device = Union[str, torch.device, None]
FORMAT = "torch.export"
DEVICES = ("cpu", "cuda")
# The programs export_lm writes: always; with decode_chunk > 0; with
# page_size > 0; with both (the JAX package's names and order).
PROGRAMS = ("prefill", "decode_step", "decode_rows", "admit", "extend",
            "extend_rows")
CHUNK_PROGRAMS = ("decode_k", "decode_k_rows", "decode_k_sample")
PAGED_PROGRAMS = ("decode_paged", "admit_paged", "extend_paged")
PAGED_CHUNK_PROGRAMS = ("decode_paged_k", "decode_paged_k_sample")

# SplitMix64 constants as signed int64 (tensor ops wrap modulo 2^64).
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def _shr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def splitmix64(z: torch.Tensor) -> torch.Tensor:
    """One SplitMix64 output for state z (int64 tensor, elementwise)."""
    z = z + _GOLDEN
    z = (z ^ _shr(z, 30)) * _MIX1
    z = (z ^ _shr(z, 27)) * _MIX2
    return z ^ _shr(z, 31)


def counter_uniform(seeds: torch.Tensor, pos: torch.Tensor,
                    vocab: int) -> torch.Tensor:
    """[b, vocab] float64 uniforms in (0, 1): element (r, i) is the i-th
    output of the SplitMix64 stream whose state is
    splitmix64(splitmix64(seeds[r]) ^ pos[r])."""
    state = splitmix64(splitmix64(seeds.long()) ^ pos.long())
    idx = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    bits = splitmix64(state[:, None] + idx[None] * _GOLDEN)
    return (_shr(bits, 11).double() + 0.5) * 2.0 ** -53


def categorical(x: torch.Tensor, seeds: torch.Tensor,
                pos: torch.Tensor) -> torch.Tensor:
    """One draw per row from softmax(x) (x [b, V], -inf excluded) by
    Gumbel-max over counter_uniform noise; first index on ties."""
    u = counter_uniform(seeds, pos, x.shape[-1])
    return torch.argmax(x.double() - torch.log(-torch.log(u)), dim=-1)


def truncate_support_rows(logits: torch.Tensor, top_k: torch.Tensor,
                          top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k (<= 0 disables) then nucleus (>= 1 disables; the token
    that crosses top_p is kept). logits [b, V] float32."""
    v = logits.shape[-1]
    neg = torch.full_like(logits, float("-inf"))
    sorted_x = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_x.gather(-1, (top_k.long().clamp(1, v) - 1)[:, None])
    logits = torch.where((top_k > 0)[:, None] & (logits < kth), neg, logits)
    probs = torch.softmax(logits, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(sp, dim=-1) - sp) < top_p[:, None]
    thr = torch.where(keep, sp, torch.full_like(sp, float("inf"))).min(
        dim=-1, keepdim=True).values
    return torch.where((top_p < 1.0)[:, None] & (probs < thr), neg, logits)


def sample_rows(logits: torch.Tensor, seeds: torch.Tensor, pos: torch.Tensor,
                temperature: torch.Tensor, top_k: torch.Tensor,
                top_p: torch.Tensor) -> torch.Tensor:
    """The per-row sampling policy, one batched draw for all rows:
    temperature, support truncation, then ``categorical`` keyed by (seed,
    pos). Rows with temperature <= 0 take the first-max argmax. All inputs
    are [b] tensors on the logits' device; returns [b] int64."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    x = truncate_support_rows(
        logits / temperature.clamp(min=1e-6)[:, None], top_k, top_p)
    sampled = categorical(x, seeds, pos)
    return torch.where(temperature <= 0.0, greedy, sampled)


def _chosen_logprob(x: torch.Tensor, nxt: torch.Tensor) -> torch.Tensor:
    """log p(chosen) under the raw model distribution, [b, 1]."""
    return torch.log_softmax(x, dim=-1).gather(-1, nxt)


# ------------------------------------------------------------ the programs
# Each body takes the model first (the admit bodies ignore it); the live
# surface calls them on a live model, export_lm traces them over a serving
# copy with its weights passed in. Caches are written in place; only the
# admits return them (a program needs an output, and these outputs are the
# caller's tensors, not copies).

def _prefill(model, tokens, meta: Dict[str, Any]):
    """tokens [b, t] into a fresh serving cache: (logits [b, t, V], cache)."""
    cache = zero_cache(meta, tokens.shape[0], tokens.device)
    return model(tokens, cache=cache, input_pos=0)


def _forward(model, tokens, cache, pos):
    """tokens [b, k] at positions pos.. (scalar or [b]) into ``cache``,
    dense or paged (the model routes on its arity): logits [b, k, V]."""
    return model(tokens, cache=cache, input_pos=pos)[0]


def _greedy_step(model, tok, cache, pos):
    """One step of the fused greedy chunk: (argmax [b, 1], its logprob)."""
    x = _forward(model, tok, cache, pos)[:, -1].float()
    nxt = torch.argmax(x, dim=-1, keepdim=True)
    return nxt, _chosen_logprob(x, nxt)


def _sampled_step(model, tok, cache, pos, seeds, temperature, top_k, top_p):
    """One step of the fused sampled chunk: (``sample_rows`` draw keyed by
    (seed, pos) [b, 1], its logprob under the raw model)."""
    x = _forward(model, tok, cache, pos)[:, -1].float()
    nxt = sample_rows(x, seeds, pos, temperature, top_k, top_p)[:, None]
    return nxt, _chosen_logprob(x, nxt)


def _admit(model, cache, row_cache, slot):
    """Row ``slot`` (0-dim) of the dense cache := the batch-1 row cache."""
    for (ck, cv), (rk, rv) in zip(cache, row_cache):
        ck.index_copy_(0, slot.reshape(1), rk.to(ck.dtype))
        cv.index_copy_(0, slot.reshape(1), rv.to(cv.dtype))
    return cache


def _admit_paged(model, cache, row_cache, pages):
    """A dense batch-1 row cache into the pool pages ``pages`` [max_pages]
    (trash-page repeats for the tail beyond the prompt are harmless:
    masked, then overwritten page by page as decode advances)."""
    for (pk, pv, _), (rk, rv) in zip(cache, row_cache):
        shape = (pages.shape[0],) + tuple(pk.shape[1:])
        pk[pages] = rk[0].reshape(shape).to(pk.dtype)
        pv[pages] = rv[0].reshape(shape).to(pv.dtype)
    return cache


def _bodies(meta: Dict[str, Any]) -> Dict[str, Callable]:
    return {
        "prefill": functools.partial(_prefill, meta=meta),
        "decode_step": _forward, "decode_rows": _forward,
        "admit": _admit, "extend": _forward, "extend_rows": _forward,
        "decode_k": _greedy_step, "decode_k_rows": _greedy_step,
        "decode_k_sample": _sampled_step, "decode_paged": _forward,
        "admit_paged": _admit_paged, "extend_paged": _forward,
        "decode_paged_k": _greedy_step,
        "decode_paged_k_sample": _sampled_step,
    }


_COPIES = ("admit", "admit_paged")  # programs that read no weights


def _meta(cfg, max_seq: int, decode_chunk: int, page_size: int,
          fmt: str) -> Dict[str, Any]:
    """The JAX package's meta keys (tempo_tpu/infer/export_lm.py)."""
    return {
        "vocab_size": cfg.in_size,
        "block_size": cfg.block_size,
        "max_seq": int(max_seq),
        "n_layer": cfg.n_layer,
        "n_head": cfg.n_head,
        "n_kv_head": cfg.kv_heads,
        "n_embd": cfg.n_embd,
        "n_experts": cfg.n_experts,
        "quantize": cfg.quantize,
        "compute_dtype": cfg.compute_dtype,
        "format": fmt,
        "continuous": True,
        "speculative": True,
        "decode_chunk": int(decode_chunk),
        "decode_k_logprobs": decode_chunk > 0,
        "page_size": int(page_size),
    }


class _Surface:
    """The serving calls over one set of programs on one device:
    ``program(name)`` gives a program's callable over its inputs (the
    weights already bound), exported (``_Artifacts``) or a body over a live
    model (``_live_surface``). On CUDA the fixed-shape decode calls replay
    graphs of one ``GraphSet``; on the CPU (or with ``captured=False``,
    which only the on-card comparison of chip_smoke.py asks for:
    ``uncaptured``) every call runs eagerly."""

    def __init__(self, meta: Dict[str, Any], device: torch.device,
                 program: Callable[[str], Callable], captured: bool = True):
        self.device = device
        self.meta = dict(meta, device=str(device))
        self.program = program
        self.max_seq = int(meta["max_seq"])
        self.k = int(meta["decode_chunk"])
        self.page = int(meta["page_size"])
        self.graphs = (GraphSet(device)
                       if captured and device.type == "cuda" else None)
        n_head = int(meta["n_head"])
        self._kv_hd = (int(meta.get("n_kv_head") or n_head),
                       int(meta["n_embd"]) // n_head)
        self._dtype = getattr(torch, meta["compute_dtype"])

    def uncaptured(self) -> "_Surface":
        """The same programs with every call run eagerly."""
        return _Surface(self.meta, self.device, self.program, captured=False)

    def tensor(self, x, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _run(self, name: str, k: int, cache, fn, inputs):
        if self.graphs is None:
            return fn(*inputs)
        key = (name, int(inputs[0].shape[0]), k, cache_key(cache))
        return self.graphs.run(key, fn, inputs)

    def _check_cache(self, name: str, cache, batch: int) -> None:
        """``cache`` is one the programs take: a layer each, dense (k, v)
        [batch, max_seq, kv, hd] or paged (pool_k, pool_v, table) with
        pools [P, page, kv, hd] and a table [batch, max_seq // page], in
        the compute type on this device. (The loaded programs skip
        torch.export's own input checks, whose symbolic evaluation costs
        milliseconds a call.)"""
        if len(cache) != int(self.meta["n_layer"]):
            raise ValueError(f"{name}: {len(cache)} cache layers, want "
                             f"{self.meta['n_layer']}")
        dev = self.device
        for layer in cache:
            if len(layer) == 3:
                want = [(self.page,) + self._kv_hd] * 2
                got = [tuple(t.shape[1:]) for t in layer[:2]]
                table = layer[2]
                if (tuple(table.shape) != (batch, self.max_seq
                                           // max(self.page, 1))
                        or table.dtype != torch.int32
                        or table.device.type != dev.type):
                    raise ValueError(f"{name}: block table "
                                     f"{tuple(table.shape)} {table.dtype} "
                                     f"on {table.device}")
            else:
                want = [(batch, self.max_seq) + self._kv_hd] * 2
                got = [tuple(t.shape) for t in layer]
            types = {(t.dtype, t.device.type) for t in layer[:2]}
            if got != want or types != {(self._dtype, dev.type)}:
                raise ValueError(f"{name}: cache tensors {got} {types}, "
                                 f"want {want} in {self._dtype} on {dev}")

    def _tok_pos(self, name, tok, pos, rows: bool, cache):
        tok = self.tensor(tok)
        pos = self.tensor(pos, torch.int32)
        if tok.ndim != 2 or tok.shape[1] != 1:
            raise ValueError(f"{name}: tokens must be [b, 1], got "
                             f"{tuple(tok.shape)}")
        want = (tok.shape[0],) if rows else ()
        if tuple(pos.shape) != want:
            raise ValueError(f"{name}: pos must have shape {want}, got "
                             f"{tuple(pos.shape)}")
        self._check_cache(name, cache, tok.shape[0])
        return tok, pos

    # ------------------------------------------------------ eager calls
    @torch.no_grad()
    def prefill(self, tokens):
        tokens = self.tensor(tokens)
        if tokens.ndim != 2 or not 0 < tokens.shape[1] <= self.max_seq:
            raise ValueError(f"prefill: tokens must be [b, t <= "
                             f"{self.max_seq}], got {tuple(tokens.shape)}")
        return self.program("prefill")(tokens)

    @torch.no_grad()
    def extend(self, tokens, cache, pos):
        """tokens [b, k] at positions pos.. (scalar or [b]) into an
        existing cache, dense or paged: ``extend``, ``extend_rows`` or
        ``extend_paged`` by the cache's arity and pos's shape."""
        tokens = self.tensor(tokens)
        pos = self.tensor(pos, torch.int32)
        name = ("extend_paged" if len(cache[0]) == 3 else
                "extend_rows" if pos.ndim == 1 else "extend")
        b, k = tokens.shape
        if not 0 < k <= self.max_seq or pos.shape not in ((), (b,)):
            raise ValueError(f"{name}: tokens {tuple(tokens.shape)}, pos "
                             f"{tuple(pos.shape)}")
        self._check_cache(name, cache, b)
        return self.program(name)(tokens, cache, pos), cache

    @torch.no_grad()
    def admit(self, cache, row_cache, slot):
        self._check_cache("admit", cache, cache[0][0].shape[0])
        self._check_cache("admit", row_cache, 1)
        self.program("admit")(cache, row_cache, self.tensor(slot))
        return cache

    @torch.no_grad()
    def admit_paged(self, cache, row_cache, pages):
        self._check_cache("admit_paged", cache, cache[0][2].shape[0])
        self._check_cache("admit_paged", row_cache, 1)
        self.program("admit_paged")(cache, row_cache, self.tensor(pages))
        return cache

    # --------------------------------------------------- captured calls
    @torch.no_grad()
    def _step(self, name, tok, cache, pos, rows: bool):
        tok, pos = self._tok_pos(name, tok, pos, rows, cache)
        step = self.program(name)

        def fn(t, p):
            return step(t, cache, p)

        return self._run(name, 1, cache, fn, (tok, pos)), cache

    def decode_step(self, tok, cache, pos):
        return self._step("decode_step", tok, cache, pos, rows=False)

    def decode_rows(self, tok, cache, pos):
        return self._step("decode_rows", tok, cache, pos, rows=True)

    def decode_paged(self, tok, cache, pos):
        return self._step("decode_paged", tok, cache, pos, rows=True)

    @torch.no_grad()
    def _chunk(self, name, tok, cache, pos, rows: bool, policy=None):
        """k steps of the program ``name`` (one model step, then the argmax
        or ``sample_rows`` keyed by (seed, position) when ``policy``
        (seeds, temperature, top_k, top_p) is given), fed back on the
        device. Returns (tokens [b, k], chosen-token logprobs [b, k],
        cache)."""
        if self.k <= 0:
            raise FileNotFoundError(f"{name}: exported with decode_chunk=0")
        tok, pos = self._tok_pos(name, tok, pos, rows, cache)
        inputs = [tok, pos]
        if policy is not None:
            seeds, temperature, top_k, top_p = policy
            inputs += [self.tensor(seeds), self.tensor(temperature,
                                                       torch.float32),
                       self.tensor(top_k), self.tensor(top_p, torch.float32)]
        step, k = self.program(name), self.k

        def fn(t, p, *pol):
            steps, lps = [], []
            for _ in range(k):
                t, lp = step(t, cache, p, *pol)
                steps.append(t)
                lps.append(lp)
                p = p + 1
            return torch.cat(steps, 1), torch.cat(lps, 1)

        chunk, lps = self._run(name, k, cache, fn, inputs)
        return chunk, lps, cache

    def decode_k(self, tok, cache, pos):
        return self._chunk("decode_k", tok, cache, pos, rows=False)

    def decode_k_rows(self, tok, cache, pos):
        return self._chunk("decode_k_rows", tok, cache, pos, rows=True)

    def decode_k_sample(self, tok, cache, pos, keys, temperature, top_k,
                        top_p):
        return self._chunk("decode_k_sample", tok, cache, pos, rows=True,
                           policy=(keys, temperature, top_k, top_p))

    def decode_paged_k(self, tok, cache, pos):
        return self._chunk("decode_paged_k", tok, cache, pos, rows=True)

    def decode_paged_k_sample(self, tok, cache, pos, keys, temperature,
                              top_k, top_p):
        return self._chunk("decode_paged_k_sample", tok, cache, pos,
                           rows=True, policy=(keys, temperature, top_k,
                                              top_p))

    def paged_dict(self) -> Dict[str, Any]:
        """PagedLMServer's surface dict."""
        return {
            "prefill": self.prefill,
            "decode_paged": self.decode_paged,
            "admit_paged": self.admit_paged,
            "extend_paged": self.extend,
            "decode_paged_k": self.decode_paged_k,
            "decode_paged_k_sample": self.decode_paged_k_sample,
            "meta": self.meta,
        }


def _live_surface(model, max_seq: Optional[int], decode_chunk: int,
                  page_size: int, device: Device,
                  captured: bool = True) -> _Surface:
    dev = resolve_device(device)
    wdev = model.device
    if wdev.type != dev.type or dev.index not in (None, wdev.index):
        raise ValueError(f"the model is on {wdev}, the surface on {dev}")
    cfg = model.config
    max_seq = cfg.block_size if max_seq is None else int(max_seq)
    assert 0 < max_seq <= cfg.block_size, (max_seq, cfg.block_size)
    assert max_seq % page_size == 0, (max_seq, page_size)
    assert decode_chunk > 0, decode_chunk
    meta = _meta(cfg, max_seq, decode_chunk, page_size, "live torch model")
    bodies = _bodies(meta)

    def program(name: str) -> Callable:
        return functools.partial(bodies[name], model)

    return _Surface(meta, wdev, program, captured)


def live_paged_surface(model, max_seq: Optional[int] = None,
                       decode_chunk: int = 8, page_size: int = 128,
                       device: Device = None) -> Dict[str, Any]:
    """PagedLMServer's serving surface over a live model on ``device``
    (None means CUDA; the model must already be there): ``prefill``,
    ``decode_paged``, ``admit_paged``, ``extend_paged``,
    ``decode_paged_k``, ``decode_paged_k_sample`` and ``meta``, the same
    calls as the loaded artifacts over the same bodies (captured on CUDA,
    see the module docstring)."""
    return _live_surface(model, max_seq, decode_chunk, page_size,
                         device).paged_dict()


# ------------------------------------------------------------------ export

class _Bound(nn.Module):
    """A body over a model, as one module (for functional_call)."""

    def __init__(self, model: nn.Module, body: Callable):
        super().__init__()
        self.model = model
        self.body = body

    def forward(self, *args):
        return self.body(self.model, *args)


class _Traced(nn.Module):
    """What torch.export traces for one program: ``forward(weights,
    *inputs)`` runs the body over the model with its parameters replaced
    by ``weights`` (a tuple in ``names`` order; empty for the copies), so
    the program holds no weight of its own. The model is kept out of this
    module's tree: export lifts nothing of it."""

    def __init__(self, model: nn.Module, body: Callable,
                 names: Tuple[str, ...]):
        super().__init__()
        self._bound = (_Bound(model, body), names)

    def forward(self, weights, *args):
        bound, names = self._bound
        if not names:
            return bound(*args)
        return torch.func.functional_call(
            bound, {f"model.{n}": w for n, w in zip(names, weights)}, args,
            strict=True)


def _examples(name: str, meta: Dict[str, Any], dev: torch.device):
    """(example inputs after the weights, their dynamic shapes) of one
    program: batch 2, t and k 2 and a pool of 3 pages, so that no symbolic
    dimension specializes to 0 or 1."""
    max_seq, page = int(meta["max_seq"]), int(meta["page_size"])
    b = torch.export.Dim("b", min=1)
    t = torch.export.Dim("t", min=1, max=max_seq)   # prefill's prompt
    k = torch.export.Dim("k", min=1, max=max_seq)   # extend's block
    p = torch.export.Dim("p", min=1)                # pool pages
    i32 = dict(dtype=torch.int32, device=dev)
    tok1 = torch.zeros((2, 1), dtype=torch.int64, device=dev)
    tok2 = torch.zeros((2, 2), dtype=torch.int64, device=dev)
    dense = zero_cache(meta, 2, dev)
    dense_dims = tuple(({0: b}, {0: b}) for _ in dense)
    row = zero_cache(meta, 1, dev)
    row_dims = tuple((None, None) for _ in row)
    if page > 0:
        pools = zero_cache(dict(meta, max_seq=page), 3, dev)
        # a table for each layer: one tensor passed for all of them would
        # be traced once and its batch specialized (callers may share it)
        paged = tuple((pk, pv, torch.zeros((2, max_seq // page), **i32))
                      for pk, pv in pools)
        paged_dims = tuple(({0: p}, {0: p}, {0: b}) for _ in paged)
    pos0, pos2 = torch.zeros((), **i32), torch.zeros((2,), **i32)
    policy = (torch.zeros(2, dtype=torch.int64, device=dev),
              torch.zeros(2, device=dev),
              torch.zeros(2, dtype=torch.int64, device=dev),
              torch.ones(2, device=dev))
    pol_dims = tuple({0: b} for _ in policy)
    if name == "prefill":
        return (tok2,), ({0: b, 1: t},)
    if name in ("decode_step", "decode_k"):
        return (tok1, dense, pos0), ({0: b}, dense_dims, None)
    if name in ("decode_rows", "decode_k_rows"):
        return (tok1, dense, pos2), ({0: b}, dense_dims, {0: b})
    if name == "decode_k_sample":
        return ((tok1, dense, pos2) + policy,
                ({0: b}, dense_dims, {0: b}) + pol_dims)
    if name == "extend":
        return (tok2, dense, pos0), ({0: b, 1: k}, dense_dims, None)
    if name in ("extend_rows", "extend_paged"):
        cache, dims = (dense, dense_dims) if name == "extend_rows" else (
            paged, paged_dims)
        return (tok2, cache, pos2), ({0: b, 1: k}, dims, {0: b})
    if name == "admit":
        return (dense, row, pos0.long()), (dense_dims, row_dims, None)
    if name == "admit_paged":
        pages = torch.zeros(max_seq // page, dtype=torch.int64, device=dev)
        return (paged, row, pages), (paged_dims, row_dims, None)
    if name in ("decode_paged", "decode_paged_k"):
        return (tok1, paged, pos2), ({0: b}, paged_dims, {0: b})
    if name == "decode_paged_k_sample":
        return ((tok1, paged, pos2) + policy,
                ({0: b}, paged_dims, {0: b}) + pol_dims)
    raise KeyError(name)


def program_names(meta: Dict[str, Any]) -> Tuple[str, ...]:
    """The programs an export with ``meta``'s decode_chunk and page_size
    holds, as the JAX package's export writes them."""
    chunk, paged = int(meta["decode_chunk"]) > 0, int(meta["page_size"]) > 0
    return (PROGRAMS + (CHUNK_PROGRAMS if chunk else ())
            + (PAGED_PROGRAMS if paged else ())
            + (PAGED_CHUNK_PROGRAMS if chunk and paged else ()))


def trace_program(name: str, model: nn.Module, meta: Dict[str, Any]):
    """The ``torch.export`` program ``name`` over ``model`` (a
    nn/transformer.py ``serving_copy``), traced on the model's device with
    the examples of ``_examples``: an ExportedProgram whose first input is
    the weights (in ``model.named_parameters()`` order; empty for the
    copies), holding no tensor of its own."""
    named = () if name in _COPIES else tuple(model.named_parameters())
    dev = model.device
    inputs, dims = _examples(name, meta, dev)
    traced = _Traced(model, _bodies(meta)[name], tuple(n for n, _ in named))
    with torch.no_grad():
        program = torch.export.export(
            traced, (tuple(p for _, p in named),) + inputs,
            dynamic_shapes=((None,) * len(named), dims), strict=False)
    # the examples would be saved with the program: the weights among them
    program.example_inputs = None
    return program


def export_lm(state_dict: Dict[str, torch.Tensor], config,
              out_dir: Union[str, Path], max_seq: Optional[int] = None,
              decode_chunk: int = 8, page_size: int = 0) -> Path:
    """Write the artifact directory of a trained GPT (``config`` a
    nn/transformer.py TransformerConfig): the ``torch.export`` programs,
    traced on the state dict's device, ``weights.pt`` and ``meta.json``
    (which also records each program's export seconds). ``max_seq``
    (default block_size) sizes the serving KV cache (a shorter one is exact
    for the requests that fit it); ``decode_chunk`` is the K of the fused
    decode calls (0: none); ``page_size`` > 0 adds the paged programs. The
    state dict is checked against the config before anything is written.
    Returns the directory."""
    from tempo_tpu_torch.nn.transformer import serving_copy

    if not config.tokenized:
        raise ValueError("export_lm requires a tokenized model")
    if config.n_experts > 0:
        raise NotImplementedError(
            "an MoE model's expert capacity ceil(k * n / E * cf) depends on "
            "the call's token count n, which the programs keep symbolic: "
            "the JAX package's export cannot trace it either")
    out_dir = Path(out_dir)
    max_seq = config.block_size if max_seq is None else int(max_seq)
    assert 0 < max_seq <= config.block_size, (max_seq, config.block_size)
    if page_size > 0:
        assert max_seq % page_size == 0, (max_seq, page_size)
    model = serving_copy(state_dict, config)
    meta = _meta(config, max_seq, decode_chunk, page_size, FORMAT)
    meta["devices"] = list(DEVICES)
    meta["programs"] = list(program_names(meta))
    meta["weights"] = [n for n, _ in model.named_parameters()]
    meta["config"] = dataclasses.asdict(config)
    out_dir.mkdir(parents=True, exist_ok=True)
    seconds = {}
    for name in meta["programs"]:
        t0 = time.perf_counter()
        torch.export.save(trace_program(name, model, meta),
                          out_dir / f"{name}.pt2")
        seconds[name] = time.perf_counter() - t0
    torch.save({n: w.detach().cpu() for n, w in model.named_parameters()},
               out_dir / "weights.pt")
    meta["export_seconds"] = seconds
    (out_dir / "meta.json").write_text(json.dumps(meta, indent=2))
    return out_dir


# ------------------------------------------------------------------ loaders

def _unchecked(module: torch.fx.GraphModule) -> None:
    """Drop what a loaded program checks at every call: torch.export's
    input constraints (a symbolic evaluation over every input) and the
    type and device asserts before each cast, a dispatched op each (~100 a
    program): together milliseconds of host time a call, where the live
    model's call has none. ``_Surface._check_cache`` checks what the
    programs take instead; every tensor inside a program has the type it
    was traced with."""
    module.validate_inputs = False
    for node in module.graph.find_nodes(
            op="call_function",
            target=torch.ops.aten._assert_tensor_metadata.default):
        module.graph.erase_node(node)
    module.recompile()


class _Artifacts:
    """The programs of one artifact directory on one device, each loaded
    once (by the loader that returns it) and moved to the device; the
    weights are loaded once and bound to every program that reads them."""

    def __init__(self, out_dir: Path, meta: Dict[str, Any],
                 device: torch.device):
        self.out_dir, self.device = out_dir, device
        stored = torch.load(out_dir / "weights.pt", map_location="cpu",
                            weights_only=True)
        self.weights = tuple(stored.pop(n).to(device)
                             for n in meta["weights"])
        self.names = set(meta["programs"])
        self.loaded: Dict[str, Callable] = {}

    def __call__(self, name: str) -> Callable:
        fn = self.loaded.get(name)
        if fn is None:
            from torch.export.passes import move_to_device_pass

            if name not in self.names:
                raise FileNotFoundError(f"{self.out_dir} holds no {name} "
                                        f"program")
            program = torch.export.load(self.out_dir / f"{name}.pt2")
            module = move_to_device_pass(program, self.device).module()
            _unchecked(module)
            fn = self.loaded[name] = functools.partial(
                module, () if name in _COPIES else self.weights)
        return fn


# (resolved artifact dir, device) -> its surface, while anything holds it
_LOADED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _programs(surface: _Surface, *names: str) -> _Surface:
    """``surface`` with the programs ``names`` loaded now, at the loader
    that returns them, not at their first call (a program missing from
    the export raises FileNotFoundError)."""
    for name in names:
        surface.program(name)
    return surface


def _load(out_dir: Union[str, Path], device: Device,
          *programs: str) -> _Surface:
    """The surface of ``out_dir`` on ``device`` (one a process while held),
    with ``programs`` loaded."""
    out_dir = Path(out_dir).resolve()
    dev = resolve_device(device)
    key = (str(out_dir), str(dev))
    surface = _LOADED.get(key)
    if surface is None:
        meta = json.loads((out_dir / "meta.json").read_text())
        if meta.get("format") != FORMAT:
            raise ValueError(
                f"{out_dir}: not an export of this package (format "
                f"{meta.get('format')!r}, want {FORMAT!r}): export it again "
                f"with tempo_tpu_torch.infer.export_lm.export_lm")
        surface = _Surface(meta, dev, _Artifacts(out_dir, meta, dev))
        _LOADED[key] = surface
    return _programs(surface, *programs)


def zero_cache(meta: dict, batch: int, device: Device = None):
    """An empty dense serving cache for an artifact set, on ``device``
    (None: CUDA): per layer (k, v) [batch, max_seq, kv, hd] zeros. Extending
    it from position 0 is prefill (the absolute-position mask hides the
    slots never written)."""
    shape = (batch, int(meta["max_seq"]),
             int(meta.get("n_kv_head") or meta["n_head"]),
             int(meta["n_embd"]) // int(meta["n_head"]))
    dt = getattr(torch, meta["compute_dtype"])
    dev = resolve_device(device)
    return tuple((torch.zeros(shape, dtype=dt, device=dev),
                  torch.zeros(shape, dtype=dt, device=dev))
                 for _ in range(int(meta["n_layer"])))


def load_exported_lm(out_dir: Union[str, Path], device: Device = None):
    """(prefill, decode_step, meta): callable at any batch and prompt
    length within the window."""
    s = _load(out_dir, device, "prefill", "decode_step")
    return s.prefill, s.decode_step, s.meta


def load_exported_continuous(out_dir: Union[str, Path],
                             device: Device = None):
    """(prefill, decode_rows, admit, meta): the continuous-batching
    surface."""
    s = _load(out_dir, device, "prefill", "decode_rows", "admit")
    return s.prefill, s.decode_rows, s.admit, s.meta


def load_exported_extend_rows(out_dir: Union[str, Path],
                              device: Device = None):
    """extend_rows(tokens [b, k], cache, pos [b]): the per-row block
    extend."""
    return _load(out_dir, device, "extend_rows").extend


def _need_chunk(s: _Surface, out_dir, what: str) -> int:
    if s.k <= 0:
        raise FileNotFoundError(f"{out_dir} was exported without {what}")
    return s.k


def load_exported_decode_k(out_dir: Union[str, Path], device: Device = None):
    """(decode_k, decode_k_rows, K): K greedy steps in one call, returning
    (tokens [b, K], chosen-token logprobs [b, K], cache). Raises
    FileNotFoundError for an export with decode_chunk=0."""
    s = _load(out_dir, device)
    k = _need_chunk(s, out_dir, "the decode_k pair")
    _programs(s, "decode_k", "decode_k_rows")
    return s.decode_k, s.decode_k_rows, k


def load_exported_decode_k_sample(out_dir: Union[str, Path],
                                  device: Device = None):
    """(decode_k_sample, K): K sampled steps, the policy per row (seeds,
    temperature, top_k, top_p), keyed by (seed, absolute position)."""
    s = _load(out_dir, device)
    k = _need_chunk(s, out_dir, "decode_k_sample")
    _programs(s, "decode_k_sample")
    return s.decode_k_sample, k


def _need_paged(s: _Surface, out_dir) -> None:
    if s.page <= 0:
        raise FileNotFoundError(
            f"{out_dir} was exported without the paged calls "
            "(export_lm(..., page_size=N))")


def load_exported_paged(out_dir: Union[str, Path], device: Device = None):
    """(prefill, decode_paged, admit_paged, meta): the paged-cache serving
    surface (the pool's page count is the caller's)."""
    s = _load(out_dir, device)
    _need_paged(s, out_dir)
    _programs(s, "prefill", "decode_paged", "admit_paged")
    return s.prefill, s.decode_paged, s.admit_paged, s.meta


def load_exported_extend_paged(out_dir: Union[str, Path],
                               device: Device = None):
    """extend_paged(tokens [b, k], paged_cache, pos [b])."""
    s = _load(out_dir, device)
    _need_paged(s, out_dir)
    _programs(s, "extend_paged")
    return s.extend


def load_exported_paged_k(out_dir: Union[str, Path], device: Device = None):
    """(decode_paged_k, decode_paged_k_sample, K): the fused pair over the
    paged cache. The caller allocates every page the K writes touch."""
    s = _load(out_dir, device)
    _need_paged(s, out_dir)
    k = _need_chunk(s, out_dir, "the paged decode_k pair")
    _programs(s, "decode_paged_k", "decode_paged_k_sample")
    return s.decode_paged_k, s.decode_paged_k_sample, k


def load_exported_speculative(out_dir: Union[str, Path],
                              device: Device = None):
    """(prefill, extend, meta): block extend into an existing cache, for
    the target's verify pass of infer/serving.py's SpeculativeLMServer,
    chunked prefill and the prefix cache. ``extend`` takes a scalar or a
    per-row position (the extend or the extend_rows program)."""
    s = _load(out_dir, device, "prefill", "extend", "extend_rows")
    return s.prefill, s.extend, s.meta


def greedy_decode_exported(out_dir: Union[str, Path], prompt,
                           max_new_tokens: int, device: Device = None):
    """Reference serving loop over the artifacts: prefill once, then one
    decode_step per token, greedy. Returns [b, t + max_new_tokens] on the
    host."""
    prefill, decode_step, meta = load_exported_lm(out_dir, device)
    prompt = np.asarray(prompt, np.int64)
    if max_new_tokens <= 0:
        return prompt
    limit = meta.get("max_seq", meta["block_size"])
    if prompt.shape[1] + max_new_tokens > limit:
        raise ValueError(
            f"prompt {prompt.shape[1]} + {max_new_tokens} new tokens "
            f"exceeds the exported serving window {limit}")
    logits, cache = prefill(prompt)
    pos = prompt.shape[1]
    toks = [prompt]
    tok = torch.argmax(logits[:, -1:].float(), dim=-1)
    for _ in range(max_new_tokens - 1):
        toks.append(tok.cpu().numpy())
        logits, cache = decode_step(tok, cache, pos)
        tok = torch.argmax(logits[:, -1:].float(), dim=-1)
        pos += 1
    toks.append(tok.cpu().numpy())
    return np.concatenate(toks, axis=1)
