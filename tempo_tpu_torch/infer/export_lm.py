"""Export of a trained GPT for serving, its loaders, the serving calls over
a live model, and the on-device sampling policy.

Counterpart of tempo_tpu/infer/export_lm.py. ``export_lm`` writes an
artifact directory: ``weights.pt`` (the model's state dict, fp32, on the
host) and ``meta.json`` (the JAX package's meta keys, the whole
``TransformerConfig`` under ``config``, ``"format": "torch state_dict"``).
A deliberate difference: the JAX artifacts are StableHLO programs with the
weights baked in, so a serving host needs no model code; the port's loaders
rebuild the ``Transformer`` from ``meta.json`` and load the weights into it.
``torch.export`` of the programs waits for K3, K4 and K5 to be registered
as ``torch.library`` ops, as K1 and K2 are for infer/export_codec.py
(ROADMAP Queue 1, M12).

The loaders (``load_exported_*``, ``zero_cache``, ``greedy_decode_exported``)
keep the JAX contracts: the same calls, arguments and returns, with
``device=None`` meaning CUDA. Loads of one artifact directory on one device
share one model, so a server that calls four loaders holds the weights
once. What differs on the device:

- The fixed-shape decode calls (``decode_step``, ``decode_rows``,
  ``decode_k``, ``decode_k_rows``, ``decode_k_sample``, ``decode_paged``,
  ``decode_paged_k``, ``decode_paged_k_sample``) are captured as CUDA
  graphs (infer/graphs.py), one per (call, batch, k, cache), and replayed:
  a ``decode_k`` of K model steps is one replay, as JAX's scan is one
  dispatch. Their outputs are the graph's static tensors, valid until the
  same call's next replay.
- ``prefill`` and ``extend`` / ``extend_rows`` / ``extend_paged``, whose
  lengths are symbolic in JAX, run eagerly (one graph per length would not
  pay for a call made once a request), and so do ``admit`` /
  ``admit_paged``, which are copies.
- Caches are updated IN PLACE and returned (JAX returns new arrays): the
  caller's cache tensors are the ones a graph writes, so a server keeps
  its caches for its lifetime and copies prefilled rows into them.
- Sampled rows are keyed by integer seeds [b] instead of threefry keys.

On the CPU nothing is captured: the same calls run eagerly.

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
import json
import weakref
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.graphs import GraphSet, cache_key
from tempo_tpu_torch.nn.transformer import (Transformer, TransformerConfig,
                                           init_cache)

Device = Union[str, torch.device, None]

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




def _meta(cfg: TransformerConfig, max_seq: int, decode_chunk: int,
          page_size: int, fmt: str) -> Dict[str, Any]:
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
    """The serving calls over one model on one device. On CUDA the
    fixed-shape decode calls replay graphs of one ``GraphSet``; on the CPU
    (or with ``captured=False``, which only the on-card comparison of
    chip_smoke.py asks for) every call runs eagerly."""

    def __init__(self, model: Transformer, meta: Dict[str, Any],
                 captured: bool = True):
        self.model = model
        self.cfg = model.config
        self.device = model.transformer["wte"].weight.device
        self.meta = dict(meta, device=str(self.device))
        self.max_seq = int(meta["max_seq"])
        self.k = int(meta["decode_chunk"])
        self.page = int(meta["page_size"])
        self.graphs = (GraphSet(self.device)
                       if captured and self.device.type == "cuda" else None)

    def tensor(self, x, dtype=torch.int64) -> torch.Tensor:
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    def _run(self, name: str, k: int, cache, fn, inputs):
        if self.graphs is None:
            return fn(*inputs)
        key = (name, int(inputs[0].shape[0]), k, cache_key(cache))
        return self.graphs.run(key, fn, inputs)

    def _tok_pos(self, name, tok, pos, rows: bool):
        tok = self.tensor(tok)
        pos = self.tensor(pos, torch.int32)
        if tok.ndim != 2 or tok.shape[1] != 1:
            raise ValueError(f"{name}: tokens must be [b, 1], got "
                             f"{tuple(tok.shape)}")
        want = (tok.shape[0],) if rows else ()
        if tuple(pos.shape) != want:
            raise ValueError(f"{name}: pos must have shape {want}, got "
                             f"{tuple(pos.shape)}")
        return tok, pos

    # ------------------------------------------------------ eager calls
    @torch.no_grad()
    def prefill(self, tokens):
        tokens = self.tensor(tokens)
        cache = init_cache(self.cfg, tokens.shape[0], self.cfg.dtype,
                           cache_len=self.max_seq, device=self.device)
        return self.model(tokens, cache=cache, input_pos=0)

    @torch.no_grad()
    def extend(self, tokens, cache, pos):
        """tokens [b, k] at positions pos.. (scalar or [b]) into an
        existing cache, dense or paged (the model routes on its arity)."""
        return self.model(self.tensor(tokens), cache=cache,
                          input_pos=self.tensor(pos, torch.int32))

    @torch.no_grad()
    def admit(self, cache, row_cache, slot):
        slot = int(slot)
        for (ck, cv), (rk, rv) in zip(cache, row_cache):
            ck[slot].copy_(rk[0])
            cv[slot].copy_(rv[0])
        return cache

    @torch.no_grad()
    def admit_paged(self, cache, row_cache, pages):
        pages = self.tensor(pages)
        mp = self.max_seq // self.page
        for (pk, pv, _), (rk, rv) in zip(cache, row_cache):
            kvh, hd = pk.shape[2], pk.shape[3]
            pk[pages] = rk[0].reshape(mp, self.page, kvh, hd).to(pk.dtype)
            pv[pages] = rv[0].reshape(mp, self.page, kvh, hd).to(pv.dtype)
        return cache

    # --------------------------------------------------- captured calls
    @torch.no_grad()
    def _step(self, name, tok, cache, pos, rows: bool):
        tok, pos = self._tok_pos(name, tok, pos, rows)
        model = self.model

        def fn(t, p):
            return model(t, cache=cache, input_pos=p)[0]

        return self._run(name, 1, cache, fn, (tok, pos)), cache

    def decode_step(self, tok, cache, pos):
        return self._step("decode_step", tok, cache, pos, rows=False)

    def decode_rows(self, tok, cache, pos):
        return self._step("decode_rows", tok, cache, pos, rows=True)

    def decode_paged(self, tok, cache, pos):
        return self._step("decode_paged", tok, cache, pos, rows=True)

    @torch.no_grad()
    def _chunk(self, name, tok, cache, pos, rows: bool, policy=None):
        """k model steps with the next token chosen on the device: the
        argmax, or ``sample_rows`` keyed by (seed, position) when
        ``policy`` (seeds, temperature, top_k, top_p) is given. Returns
        (tokens [b, k], chosen-token logprobs [b, k], cache)."""
        if self.k <= 0:
            raise FileNotFoundError(f"{name}: exported with decode_chunk=0")
        tok, pos = self._tok_pos(name, tok, pos, rows)
        inputs = [tok, pos]
        if policy is not None:
            seeds, temperature, top_k, top_p = policy
            inputs += [self.tensor(seeds), self.tensor(temperature,
                                                       torch.float32),
                       self.tensor(top_k), self.tensor(top_p, torch.float32)]
        model, k = self.model, self.k

        def fn(t, p, *pol):
            steps, lps = [], []
            for _ in range(k):
                logits, _ = model(t, cache=cache, input_pos=p)
                x = logits[:, -1].float()
                if pol:
                    t = sample_rows(x, pol[0], p, *pol[1:])[:, None]
                else:
                    t = torch.argmax(x, dim=-1, keepdim=True)
                steps.append(t)
                lps.append(_chosen_logprob(x, t))
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


def _live_surface(model: Transformer, max_seq: Optional[int],
                  decode_chunk: int, page_size: int, device: Device,
                  captured: bool = True) -> _Surface:
    dev = resolve_device(device)
    wdev = model.transformer["wte"].weight.device
    if wdev.type != dev.type or dev.index not in (None, wdev.index):
        raise ValueError(f"the model is on {wdev}, the surface on {dev}")
    cfg = model.config
    max_seq = cfg.block_size if max_seq is None else int(max_seq)
    assert 0 < max_seq <= cfg.block_size, (max_seq, cfg.block_size)
    assert max_seq % page_size == 0, (max_seq, page_size)
    assert decode_chunk > 0, decode_chunk
    return _Surface(model, _meta(cfg, max_seq, decode_chunk, page_size,
                                 "live torch model"), captured)


def live_paged_surface(model: Transformer, max_seq: Optional[int] = None,
                       decode_chunk: int = 8, page_size: int = 128,
                       device: Device = None) -> Dict[str, Any]:
    """PagedLMServer's serving surface over a live model on ``device``
    (None means CUDA; the model must already be there): ``prefill``,
    ``decode_paged``, ``admit_paged``, ``extend_paged``,
    ``decode_paged_k``, ``decode_paged_k_sample`` and ``meta``, the same
    calls as the loaded artifacts (captured on CUDA, see the module
    docstring)."""
    return _live_surface(model, max_seq, decode_chunk, page_size,
                         device).paged_dict()


# ------------------------------------------------------------------ export

def export_lm(state_dict: Dict[str, torch.Tensor], config: TransformerConfig,
              out_dir: Union[str, Path], max_seq: Optional[int] = None,
              decode_chunk: int = 8, page_size: int = 0) -> Path:
    """Write the artifact directory of a trained GPT: ``weights.pt`` and
    ``meta.json``. ``max_seq`` (default block_size) sizes the serving KV
    cache (a shorter one is exact for the requests that fit it);
    ``decode_chunk`` is the K of the fused decode calls (0: none);
    ``page_size`` > 0 enables the paged calls. The state dict is checked
    against the config before anything is written."""
    out_dir = Path(out_dir)
    max_seq = config.block_size if max_seq is None else int(max_seq)
    assert 0 < max_seq <= config.block_size, (max_seq, config.block_size)
    if page_size > 0:
        assert max_seq % page_size == 0, (max_seq, page_size)
    weights = {k: v.detach().to("cpu", torch.float32)
               for k, v in state_dict.items()}
    Transformer(config, device="meta").load_state_dict(weights, assign=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.save(weights, out_dir / "weights.pt")
    meta = _meta(config, max_seq, decode_chunk, page_size,
                 "torch state_dict")
    meta["platforms"] = ["cpu", "cuda"]
    meta["config"] = dataclasses.asdict(config)
    (out_dir / "meta.json").write_text(json.dumps(meta, indent=2))
    return out_dir


# (resolved artifact dir, device) -> its surface, while anything holds it
_LOADED: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def _load(out_dir: Union[str, Path], device: Device) -> _Surface:
    out_dir = Path(out_dir).resolve()
    dev = resolve_device(device)
    key = (str(out_dir), str(dev))
    surface = _LOADED.get(key)
    if surface is None:
        meta = json.loads((out_dir / "meta.json").read_text())
        if meta.get("format") != "torch state_dict":
            raise ValueError(f"{out_dir}: not an export of this package "
                             f"(format {meta.get('format')!r})")
        model = Transformer(TransformerConfig(**meta["config"]),
                            device="meta")
        model.load_state_dict(torch.load(out_dir / "weights.pt",
                                         map_location="cpu",
                                         weights_only=True), assign=True)
        model.requires_grad_(False).to(dev)
        surface = _Surface(model, meta)
        _LOADED[key] = surface
    return surface


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
    s = _load(out_dir, device)
    return s.prefill, s.decode_step, s.meta


def load_exported_continuous(out_dir: Union[str, Path],
                             device: Device = None):
    """(prefill, decode_rows, admit, meta): the continuous-batching
    surface."""
    s = _load(out_dir, device)
    return s.prefill, s.decode_rows, s.admit, s.meta


def load_exported_extend_rows(out_dir: Union[str, Path],
                              device: Device = None):
    """extend_rows(tokens [b, k], cache, pos [b]): the per-row block
    extend."""
    return _load(out_dir, device).extend


def _need_chunk(s: _Surface, out_dir, what: str) -> int:
    if s.k <= 0:
        raise FileNotFoundError(f"{out_dir} was exported without {what}")
    return s.k


def load_exported_decode_k(out_dir: Union[str, Path], device: Device = None):
    """(decode_k, decode_k_rows, K): K greedy steps in one call, returning
    (tokens [b, K], chosen-token logprobs [b, K], cache). Raises
    FileNotFoundError for an export with decode_chunk=0."""
    s = _load(out_dir, device)
    return s.decode_k, s.decode_k_rows, _need_chunk(s, out_dir,
                                                    "the decode_k pair")


def load_exported_decode_k_sample(out_dir: Union[str, Path],
                                  device: Device = None):
    """(decode_k_sample, K): K sampled steps, the policy per row (seeds,
    temperature, top_k, top_p), keyed by (seed, absolute position)."""
    s = _load(out_dir, device)
    return s.decode_k_sample, _need_chunk(s, out_dir, "decode_k_sample")


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
    return s.prefill, s.decode_paged, s.admit_paged, s.meta


def load_exported_extend_paged(out_dir: Union[str, Path],
                               device: Device = None):
    """extend_paged(tokens [b, k], paged_cache, pos [b])."""
    s = _load(out_dir, device)
    _need_paged(s, out_dir)
    return s.extend


def load_exported_paged_k(out_dir: Union[str, Path], device: Device = None):
    """(decode_paged_k, decode_paged_k_sample, K): the fused pair over the
    paged cache. The caller allocates every page the K writes touch."""
    s = _load(out_dir, device)
    _need_paged(s, out_dir)
    return (s.decode_paged_k, s.decode_paged_k_sample,
            _need_chunk(s, out_dir, "the paged decode_k pair"))


def load_exported_speculative(out_dir: Union[str, Path],
                              device: Device = None):
    """(prefill, extend, meta): block extend into an existing cache, for
    chunked prefill and the prefix cache (the speculative servers are not
    ported yet)."""
    s = _load(out_dir, device)
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
