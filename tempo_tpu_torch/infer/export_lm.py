"""The paged LM serving surface and the on-device sampling policy.

Counterpart of tempo_tpu/infer/export_lm.py: ``truncate_support_rows``,
``sample_rows`` and ``live_paged_surface``. The StableHLO export and the
artifact loaders are not ported: the surface is built from a live model.

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

from typing import Any, Dict, Optional, Union

import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.nn.transformer import Transformer, init_cache

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


def live_paged_surface(model: Transformer, max_seq: Optional[int] = None,
                       decode_chunk: int = 8, page_size: int = 128,
                       device: Union[str, torch.device, None] = None
                       ) -> Dict[str, Any]:
    """PagedLMServer's serving surface over a live model on ``device``
    (None means CUDA; the model must already be there). Same dict contract
    as tempo_tpu's: ``prefill``, ``decode_paged``, ``admit_paged``,
    ``extend_paged``, ``decode_paged_k``, ``decode_paged_k_sample`` and
    ``meta``.

    Differences from the JAX surface: the paged pools are updated IN PLACE
    (JAX returns new arrays; the returned cache holds the same tensors);
    ``decode_paged_k`` / ``decode_paged_k_sample`` are Python loops of k
    model steps whose tokens and chosen-token logprobs stay on the device
    (the caller syncs once per chunk); sampled rows are keyed by integer
    seeds [b] instead of threefry keys [b, 2]."""
    dev = resolve_device(device)
    wdev = model.transformer["wte"].weight.device
    if wdev.type != dev.type or dev.index not in (None, wdev.index):
        raise ValueError(f"the model is on {wdev}, the surface on {dev}")
    dev = wdev
    cfg = model.config
    max_seq = cfg.block_size if max_seq is None else int(max_seq)
    assert 0 < max_seq <= cfg.block_size, (max_seq, cfg.block_size)
    assert max_seq % page_size == 0, (max_seq, page_size)
    assert decode_chunk > 0, decode_chunk
    mp = max_seq // page_size

    def tensor(x, dtype=torch.int64):
        return torch.as_tensor(x, device=dev).to(dtype)

    @torch.no_grad()
    def prefill(tokens):
        tokens = tensor(tokens)
        cache = init_cache(cfg, tokens.shape[0], cfg.dtype,
                           cache_len=max_seq, device=dev)
        return model(tokens, cache=cache, input_pos=0)

    @torch.no_grad()
    def decode_paged(tok, cache, pos):
        # also serves as extend_paged: the model routes on the token width
        return model(tensor(tok), cache=cache,
                     input_pos=tensor(pos, torch.int32))

    @torch.no_grad()
    def admit_paged(cache, row_cache, pages):
        pages = tensor(pages)
        for (pk, pv, _), (rk, rv) in zip(cache, row_cache):
            kvh, hd = pk.shape[2], pk.shape[3]
            pk[pages] = rk[0].reshape(mp, page_size, kvh, hd).to(pk.dtype)
            pv[pages] = rv[0].reshape(mp, page_size, kvh, hd).to(pv.dtype)
        return cache

    @torch.no_grad()
    def decode_k(tok, cache, pos):
        t, p = tensor(tok), tensor(pos, torch.int32)
        steps, lps = [], []
        for _ in range(decode_chunk):
            logits, cache = model(t, cache=cache, input_pos=p)
            x = logits[:, -1].float()
            t = torch.argmax(x, dim=-1, keepdim=True)
            steps.append(t)
            lps.append(_chosen_logprob(x, t))
            p = p + 1
        return torch.cat(steps, 1), torch.cat(lps, 1), cache

    @torch.no_grad()
    def decode_k_sample(tok, cache, pos, keys, temperature, top_k, top_p):
        t, p = tensor(tok), tensor(pos, torch.int32)
        keys, top_k = tensor(keys), tensor(top_k)
        temperature = tensor(temperature, torch.float32)
        top_p = tensor(top_p, torch.float32)
        steps, lps = [], []
        for _ in range(decode_chunk):
            logits, cache = model(t, cache=cache, input_pos=p)
            x = logits[:, -1].float()
            t = sample_rows(x, keys, p, temperature, top_k, top_p)[:, None]
            steps.append(t)
            lps.append(_chosen_logprob(x, t))
            p = p + 1
        return torch.cat(steps, 1), torch.cat(lps, 1), cache

    meta = {
        "vocab_size": cfg.in_size,
        "block_size": cfg.block_size,
        "max_seq": max_seq,
        "n_layer": cfg.n_layer,
        "n_head": cfg.n_head,
        "n_kv_head": cfg.kv_heads,
        "n_embd": cfg.n_embd,
        "n_experts": cfg.n_experts,
        "quantize": cfg.quantize,
        "compute_dtype": cfg.compute_dtype,
        "format": "live torch model",
        "device": str(dev),
        "continuous": True,
        "speculative": False,
        "decode_chunk": int(decode_chunk),
        "decode_k_logprobs": True,
        "page_size": int(page_size),
    }
    return {
        "prefill": prefill,
        "decode_paged": decode_paged,
        "admit_paged": admit_paged,
        "extend_paged": decode_paged,
        "decode_paged_k": decode_k,
        "decode_paged_k_sample": decode_k_sample,
        "meta": meta,
    }
