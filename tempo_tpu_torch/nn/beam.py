"""Beam-search decoding over the port's dense KV cache.

Counterpart of tempo_tpu/nn/beam.py with the same semantics:

- one prefill over the [b, t0] prompts, then single-token steps (K3, the
  t == 1 cache call) on the flattened [b*k] beam batch, beam j of row i at
  i*k + j;
- beams are reordered by a batch-axis gather of the cache: the layers'
  (k, v) buffers are views of one [L, 2, b*k, S, kv, hd] tensor, so the
  expand after the prefill and each step's reorder are one gather each;
- a finished beam (it emitted ``eos_id``) is frozen: its only continuation
  is eos at zero added log-probability, so it keeps competing at its final
  score; positions after the first eos are eos-padded in the output;
- the GNMT length penalty ((5 + len) / 6)^alpha ranks the final
  hypotheses (len counts the tokens up to and including the first eos);
- scores are fp32 log-probabilities whatever the compute type;
- ties go to the lowest flat index (parent beam, then token id), as
  ``lax.top_k``: a stable descending sort.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tempo_tpu_torch.nn.transformer import (Transformer, init_cache,
                                           require_tokenized, top_k)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax's formulation, in fp32: shift by the row max,
    then subtract the log of the sum of the exponentials."""
    x = x.float()
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


def _length_penalty(lengths: torch.Tensor, alpha: float) -> torch.Tensor:
    """GNMT ((5 + len) / 6)^alpha; alpha = 0 disables it."""
    if alpha == 0.0:
        return torch.ones(lengths.shape, device=lengths.device)
    return ((5.0 + lengths.float()) / 6.0) ** alpha


def stacked_cache(cache, width: int) -> Tuple[torch.Tensor, tuple]:
    """The per-layer (k, v) caches of batch b, each row repeated ``width``
    times in place (row i's copies at i*width ..), as one [L, 2, b*width,
    S, kv, hd] tensor (one gather) and the layers' views of it."""
    src = torch.stack([t for layer in cache for t in layer])
    rows = torch.arange(src.shape[1], device=src.device)
    buf = src.index_select(1, rows.repeat_interleave(width))
    buf = buf.view(len(cache), 2, *buf.shape[1:])
    return buf, tuple((buf[i, 0], buf[i, 1]) for i in range(len(cache)))


@torch.no_grad()
def beam_search(model: Transformer, idx, max_new_tokens: int,
                beam_width: int, eos_id: Optional[int] = None,
                length_penalty: float = 0.0,
                cache_dtype: Optional[torch.dtype] = None,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Deterministic beam decode of ``max_new_tokens`` continuations of
    idx [b, t0] (one length for all rows), ``beam_width`` hypotheses a row.
    Returns (sequences [b, k, t0 + max_new_tokens] best first, the
    length-penalized scores [b, k] sorted to match; the raw
    log-probabilities when alpha is 0), on the model's device. The cache
    defaults to fp32 and to the request rounded up to 64 slots;
    ``cache_len`` overrides that (e.g. a serving window), as in
    ``generate``."""
    require_tokenized(model, "beam_search")
    cfg = model.config
    dev = model.device
    idx = torch.as_tensor(idx, device=dev).long()
    b, t0 = idx.shape
    k, vocab = int(beam_width), cfg.in_size
    if not 1 <= k <= vocab:
        raise ValueError(f"beam_width {k} outside [1, {vocab}]")
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if t0 + max_new_tokens > cfg.block_size:
        raise ValueError(f"prompt {t0} + {max_new_tokens} new tokens exceeds "
                         f"block size {cfg.block_size}")
    if cache_len is None:
        cache_len = min(cfg.block_size,
                        -((t0 + max_new_tokens) // -64) * 64)
    cache = init_cache(cfg, b, dtype=cache_dtype or torch.float32,
                       cache_len=cache_len, device=dev)
    logits, cache = model(idx, cache=cache, input_pos=0)
    scores, tok = top_k(log_softmax(logits[:, -1]), k)        # [b, k]
    buf, cache = stacked_cache(cache, k)
    del logits

    toks = torch.zeros((b, k, max_new_tokens), dtype=torch.long, device=dev)
    toks[:, :, 0] = tok
    finished = (tok == eos_id) if eos_id is not None else torch.zeros(
        (b, k), dtype=torch.bool, device=dev)
    lengths = torch.ones((b, k), dtype=torch.long, device=dev)
    if eos_id is not None:
        frozen = torch.full((vocab,), float("-inf"), device=dev)
        frozen[eos_id] = 0.0
    rows = torch.arange(b, device=dev)[:, None] * k
    for i in range(1, max_new_tokens):
        logits, _ = model(tok.reshape(b * k, 1), cache=cache,
                          input_pos=t0 + i - 1)
        logp = log_softmax(logits[:, -1]).reshape(b, k, vocab)
        if eos_id is not None:
            logp = torch.where(finished[:, :, None], frozen, logp)
        scores, flat = top_k((scores[:, :, None] + logp).reshape(b, -1), k)
        parent, tok = flat // vocab, flat % vocab
        toks = toks.gather(1, parent[:, :, None].expand(-1, -1,
                                                        max_new_tokens))
        finished = finished.gather(1, parent)
        lengths = lengths.gather(1, parent)
        buf.copy_(buf.index_select(2, (rows + parent).reshape(-1)))
        toks[:, :, i] = tok
        lengths = lengths + (~finished).long()
        if eos_id is not None:
            finished = finished | (tok == eos_id)

    scores = scores / _length_penalty(lengths, length_penalty)
    if length_penalty != 0.0:
        # re-rank: the steps ordered by the raw score
        order = torch.sort(scores, dim=-1, descending=True,
                           stable=True).indices
        scores = scores.gather(1, order)
        toks = toks.gather(1, order[:, :, None].expand_as(toks))
    if eos_id is not None:
        past_eos = torch.cumsum((toks == eos_id).long(), dim=-1) > 1
        toks = torch.where(past_eos, eos_id, toks)
    prompts = idx[:, None, :].expand(b, k, t0)
    return torch.cat([prompts, toks], dim=-1), scores
