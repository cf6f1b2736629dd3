"""Decoder-style Transformer (GPT), PyTorch.

Counterpart of tempo_tpu/nn/transformer.py with the same math:

- pre-LN blocks: LayerNorm (eps 1e-5, fp32 statistics, optional bias) ->
  causal self-attention -> residual; LayerNorm -> MLP (exact-erf GELU) ->
  residual; final LayerNorm; weight-tied head (or ``lm_head``);
- learned position table ``wpe`` and/or RoPE (adjacent-pair rotation in
  fp32); grouped-query attention through ``n_kv_head``, q heads kv-major
  (q head h*g + i shares kv head h, transformer.py:435);
- KV caches: a dense [b, S, kv, hd] buffer per layer written at a scalar or
  per-row position, or a paged cache (shared pools [P, page, kv, hd] and a
  block table [b, max_pages]) written by one flat scatter through the
  table. Caches are updated IN PLACE and returned (JAX returns new arrays).
- attention: the no-cache forward (training) goes through K5
  (ops/flash_attention.py) where ``_flash_ok`` picks it, GQA's K/V repeated
  per group first, and otherwise runs the plain masked attention (the XLA
  path); every cache call with t > 1 runs the plain masked attention; a
  t == 1 cache call goes through K3 (ops/cuda_decode.py decode_attention,
  the op ``tempo::decode_attention``) on a dense cache and K4
  (``tempo::paged_decode_attention``) on a paged one, whatever
  ``decode_attn`` says: all its values compute the same function.
- ``remat`` recomputes each block in the backward (torch.utils.checkpoint),
  as nn.remat does.

Parameters stay fp32 and are cast to ``compute_dtype`` at use, as flax's
``dtype`` does; the cast is cached until the parameter changes.
``serving_copy`` holds each parameter in the type its use reads instead,
for the programs of infer/export_lm.py, which must not cast. Names
follow the reference toolkit's torch GPT (``transformer.h.{i}.attn.c_attn``
...), so tempo_tpu/interop/gpt_ckpt.py reads ``state_dict()`` as it is.

Training: ``gpt_decay_mask`` / ``make_gpt_optimizer`` (AdamW, two
parameter groups, no clipping) and ``estimate_mfu``.

Not ported yet (raise NotImplementedError): ``seq_axis``, ``n_experts >
0``, ``quantize="int8"``, dropout in training, activation taps and
capture, and the untokenized / embedder modes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops import cuda_decode, flash_attention
from tempo_tpu_torch.ops.norms import gelu_exact
from tempo_tpu_torch.train.state import Optimizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Same fields and defaults as tempo_tpu's TransformerConfig (the
    reference GPTConfig; GPT-2-small by default)."""

    in_size: int = 50304
    block_size: int = 1024
    n_layer: int = 12
    n_head: int = 12
    n_embd: int = 768
    rmlp: float = 4
    dropout: float = 0.0
    bias: bool = True
    causal: bool = True
    pos_embed: bool = True
    rope: bool = False
    tokenized: bool = True
    mlp: bool = True
    ln: bool = True
    tie_emb: bool = True
    rope_base: float = 10_000.0
    compute_dtype: str = "float32"
    n_experts: int = 0
    expert_capacity_factor: float = 1.25
    expert_top_k: int = 1
    quantize: str = "none"
    attn_impl: str = "auto"
    seq_axis: Optional[str] = None
    seq_zigzag: bool = False
    n_kv_head: int = 0
    decode_attn: str = "xla"
    remat: bool = False

    @property
    def head_dim(self) -> int:
        assert self.n_embd % self.n_head == 0
        return self.n_embd // self.n_head

    @property
    def kv_heads(self) -> int:
        kv = self.n_kv_head or self.n_head
        assert self.n_head % kv == 0, (self.n_head, kv)
        return kv

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.compute_dtype]


def _check_supported(cfg: TransformerConfig) -> None:
    unsupported = [
        (cfg.seq_axis is not None, "seq_axis (context parallelism)"),
        (cfg.n_experts > 0, "n_experts > 0 (MoE)"),
        (cfg.quantize != "none", f"quantize={cfg.quantize!r}"),
        (not cfg.tokenized, "untokenized input"),
    ]
    for bad, what in unsupported:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")
    if cfg.attn_impl not in ("auto", "xla", "flash"):
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")


def _flash_ok(cfg: TransformerConfig, q: torch.Tensor) -> bool:
    """Resolve cfg.attn_impl for a no-cache attention call on q [b, t, n,
    hd]: 'flash' is K5 (its plain version on the CPU; a shape the kernels
    refuse raises there), 'xla' the plain masked attention, 'auto' K5 when
    q is on CUDA and the kernels take its head dim and type. The TPU's
    512-multiple rule is a tiling limit the port does not have."""
    if cfg.attn_impl == "flash":
        return True
    if cfg.attn_impl == "xla":
        return False
    return q.is_cuda and flash_attention.supported(q)


def _capturing(device: torch.device) -> bool:
    """Whether a CUDA graph is being captured on ``device``'s current
    stream (infer/graphs.py): what a call sets up lazily must then exist
    already, made by the capture's warm-up, or it would live in the
    graph's memory and hold nothing until a replay."""
    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def _refuse_setup_in_capture(device: torch.device, what: str) -> None:
    if _capturing(device):
        raise RuntimeError(f"{what} would be made inside a CUDA graph "
                           f"capture: make a warm-up call first")


def cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype``: ``x`` itself where it is already, so that a
    traced program holds no node for a cast that does nothing."""
    return x if x.dtype == dtype else x.to(dtype)


def cast_param(owner: nn.Module, p: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``p`` in ``dtype``, cached on ``owner`` until ``p`` changes (in
    place, or moved) or another type is asked for. Not cached where a
    graph is being built, nor for a parameter made under
    torch.inference_mode() (no version count). A cast missing from the
    cache inside a CUDA graph capture raises, and so does any cast under
    torch.export (export ``serving_copy``)."""
    if p.dtype == dtype:
        return p
    if torch.compiler.is_exporting():
        raise RuntimeError(
            "a parameter's cast inside torch.export would run at every call "
            "of the program: export a serving_copy, whose parameters are in "
            "the types their uses read")
    if (torch.is_grad_enabled() and p.requires_grad) or p.is_inference():
        return p.to(dtype)
    cache = owner.__dict__.setdefault("_cast_cache", {})
    key = (p.device, p.data_ptr(), p._version, dtype)
    hit = cache.get(id(p))
    if hit is None or hit[0] != key:
        _refuse_setup_in_capture(p.device, "a parameter's cast")
        hit = (key, p.detach().to(dtype))
        cache[id(p)] = hit
    return hit[1]


class Linear(nn.Linear):
    """nn.Linear whose fp32 parameters are cast to ``compute_dtype`` at use
    (flax nn.Dense with ``dtype``)."""

    def __init__(self, cin: int, cout: int, bias: bool,
                 compute_dtype: torch.dtype):
        super().__init__(cin, cout, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else cast_param(self, self.bias, dt)
        return F.linear(cast(x, dt), cast_param(self, self.weight, dt), b)


class LayerNorm(nn.Module):
    """eps 1e-5, optional bias, fp32 statistics, output in ``dtype``."""

    def __init__(self, c: int, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.layer_norm(cast(x, torch.float32), x.shape[-1:], self.weight,
                         self.bias, 1e-5)
        return cast(h, self.dtype)


def rope_cache(seq_len: int, head_dim: int, base: float = 10_000.0,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """[seq_len, head_dim // 2, 2] (cos, sin) table, fp32."""
    theta = torch.exp(torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device)
                      * (-math.log(base) / head_dim))
    idx_theta = (torch.arange(seq_len, dtype=torch.float32,
                              device=device)[:, None] * theta[None])
    return torch.stack([torch.cos(idx_theta), torch.sin(idx_theta)], dim=-1)


def apply_rope(x: torch.Tensor, cache: torch.Tensor) -> torch.Tensor:
    """Rotate adjacent feature pairs of x [B, T, n, hd] by cache
    [T, hd//2, 2] or, per row, [B, T, hd//2, 2]; fp32, cast back."""
    b, t, n, d = x.shape
    xs = cast(x, torch.float32).reshape(b, t, n, d // 2, 2)
    if cache.ndim == 4:
        cos, sin = cache[:, :, None, :, 0], cache[:, :, None, :, 1]
    else:
        cos, sin = cache[None, :, None, :, 0], cache[None, :, None, :, 1]
    out = torch.stack([xs[..., 0] * cos - xs[..., 1] * sin,
                       xs[..., 1] * cos + xs[..., 0] * sin], dim=-1)
    return cast(out.reshape(b, t, n, d), x.dtype)


def _token_positions(input_pos: Optional[torch.Tensor], b: int, t: int,
                     device: torch.device) -> Optional[torch.Tensor]:
    """Absolute positions of this call's tokens: [b, t] for per-row
    positions, [1, t] for a scalar one, None without positions."""
    if input_pos is None:
        return None
    steps = torch.arange(t, device=device)
    if input_pos.ndim == 1:
        return input_pos[:, None] + steps[None]
    return (input_pos + steps)[None]


Cache = Tuple[torch.Tensor, ...]


class SelfAttention(nn.Module):
    """Causal multi-head (or grouped-query) attention with an optional
    dense or paged KV cache."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        c, hd, kv = cfg.n_embd, cfg.head_dim, cfg.kv_heads
        self.c_attn = Linear(c, c + 2 * kv * hd, cfg.bias, cfg.dtype)
        self.c_proj = Linear(c, c, cfg.bias, cfg.dtype)
        self._rope: Optional[torch.Tensor] = None

    def _rope_table(self, device: torch.device) -> torch.Tensor:
        cfg = self.config
        if self._rope is None or self._rope.device != device:
            _refuse_setup_in_capture(device, "the RoPE table")
            self._rope = rope_cache(cfg.block_size, cfg.head_dim,
                                    cfg.rope_base, device)
        return self._rope

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                input_pos: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        cfg = self.config
        b, t, c = x.shape
        n, hd, kv = cfg.n_head, cfg.head_dim, cfg.kv_heads
        qkv = self.c_attn(x)
        q = qkv[..., :c].reshape(b, t, n, hd)
        k = qkv[..., c:c + kv * hd].reshape(b, t, kv, hd)
        v = qkv[..., c + kv * hd:].reshape(b, t, kv, hd)
        tok_pos = _token_positions(input_pos, b, t, x.device)
        if cfg.rope:
            full = self._rope_table(x.device)
            rc = full[:t] if tok_pos is None else full[tok_pos]
            if rc.ndim == 4 and rc.shape[0] == 1:
                rc = rc[0]  # one scalar position: [t, hd//2, 2]
            q = apply_rope(q, rc)
            k = apply_rope(k, rc)

        new_cache = None
        if cache is None and _flash_ok(cfg, q):
            if kv < n:  # GQA trains at MHA FLOPs: K/V repeated per group
                k = k.repeat_interleave(n // kv, dim=2)
                v = v.repeat_interleave(n // kv, dim=2)
            y = flash_attention.flash_attention(q, k, v, cfg.causal,
                                                1.0 / math.sqrt(hd))
        elif cache is None:
            q_idx = (torch.arange(t, device=x.device)[None] if cfg.causal
                     else None)
            y = cuda_decode.masked_attention(q, k, v, q_idx)
        else:
            if tok_pos is None:
                input_pos = torch.zeros((), dtype=torch.int32,
                                        device=x.device)
                tok_pos = _token_positions(input_pos, b, t, x.device)
            if len(cache) == 3:
                y, new_cache = self._paged(q, k, v, cache, input_pos,
                                           tok_pos)
            else:
                ck, cv = cache
                if input_pos.ndim == 1:
                    rows = torch.arange(b, device=x.device)[:, None]
                    ck[rows, tok_pos] = cast(k, ck.dtype)
                    cv[rows, tok_pos] = cast(v, cv.dtype)
                else:
                    ck.index_copy_(1, tok_pos[0], cast(k, ck.dtype))
                    cv.index_copy_(1, tok_pos[0], cast(v, cv.dtype))
                new_cache = (ck, cv)
                if t == 1:
                    y = cuda_decode.decode_attention(q.contiguous(), ck, cv,
                                                     input_pos)
                else:
                    y = cuda_decode.masked_attention(q, ck, cv, tok_pos)
        y = cast(y, cfg.dtype).reshape(b, t, c)
        return self.c_proj(y), new_cache

    def _paged(self, q, k, v, cache, input_pos, tok_pos):
        """One flat scatter of this call's keys/values through the table,
        then K4 (t == 1) or attention over the gathered logical window."""
        pk, pv, table = cache
        if input_pos.ndim != 1:
            raise ValueError("paged decode is slot-scheduled: positions are "
                             "per-row")
        b, t = tok_pos.shape
        n_pages, pg, kv, hd = pk.shape
        page_ids = table.long().gather(1, tok_pos // pg)
        flat = (page_ids * pg + tok_pos % pg).reshape(-1)
        pk.view(n_pages * pg, kv, hd).index_copy_(
            0, flat, cast(k, pk.dtype).reshape(b * t, kv, hd))
        pv.view(n_pages * pg, kv, hd).index_copy_(
            0, flat, cast(v, pv.dtype).reshape(b * t, kv, hd))
        if t == 1:
            y = cuda_decode.paged_decode_attention(q.contiguous(), pk, pv,
                                                   table, input_pos)
        else:
            ck = pk[table.long()].reshape(b, -1, kv, hd)
            cv = pv[table.long()].reshape(b, -1, kv, hd)
            y = cuda_decode.masked_attention(q, ck, cv, tok_pos)
        return y, (pk, pv, table)


class MLPBlock(nn.Module):
    """fc -> exact GELU -> proj."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        d_hidden = int(cfg.rmlp * cfg.n_embd)
        assert d_hidden == cfg.rmlp * cfg.n_embd, "rmlp*n_embd must be int"
        self.c_fc = Linear(cfg.n_embd, d_hidden, cfg.bias, cfg.dtype)
        self.c_proj = Linear(d_hidden, cfg.n_embd, cfg.bias, cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(gelu_exact(self.c_fc(x)))


class TransformerBlock(nn.Module):
    """pre-LN attention + MLP residual block."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        if cfg.ln:
            self.ln_1 = LayerNorm(cfg.n_embd, cfg.bias, cfg.dtype)
        self.attn = SelfAttention(cfg)
        if cfg.mlp:
            if cfg.ln:
                self.ln_2 = LayerNorm(cfg.n_embd, cfg.bias, cfg.dtype)
            self.mlp = MLPBlock(cfg)

    def forward(self, x, cache=None, input_pos=None):
        cfg = self.config
        h = self.ln_1(x) if cfg.ln else x
        attn_res, new_cache = self.attn(h, cache, input_pos)
        x = x + attn_res
        if cfg.mlp:
            h = self.ln_2(x) if cfg.ln else x
            x = x + self.mlp(h)
        return x, new_cache


def _as_positions(input_pos, device: torch.device) -> Optional[torch.Tensor]:
    """None, an int, or an int tensor (scalar or [b]) -> an int32 tensor on
    ``device`` (a tensor already there is used as it is)."""
    if input_pos is None:
        return None
    if isinstance(input_pos, int):
        return torch.full((), input_pos, dtype=torch.int32, device=device)
    p = torch.as_tensor(input_pos)
    if p.ndim > 1:
        raise NotImplementedError(
            "per-token [b, t] positions (zigzag context parallelism) are "
            "not ported")
    if p.device == device and p.dtype == torch.int32:
        return p
    return p.to(device=device, dtype=torch.int32)


class Transformer(nn.Module):
    """GPT (tokenized, weight-tied head by default), on ``device`` (None
    means CUDA; raises without it unless "cpu" is asked for), weights drawn
    from ``seed`` with the JAX package's init distributions: normal(0.02)
    matmuls and embeddings, residual projections scaled by 1/sqrt(2L),
    zero biases, LayerNorm ones."""

    def __init__(self, config: TransformerConfig,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, embedders=None, unembedders=None):
        super().__init__()
        if embedders is not None or unembedders is not None:
            raise NotImplementedError("embedder modes are not ported yet")
        _check_supported(config)
        dev = resolve_device(device)
        self.config = cfg = config
        # device "meta" builds the shapes only (parameter counts, no memory)
        with torch.device("meta" if dev.type == "meta" else "cpu"):
            parts = {"wte": nn.Embedding(cfg.in_size, cfg.n_embd)}
            if cfg.pos_embed:
                parts["wpe"] = nn.Embedding(cfg.block_size, cfg.n_embd)
            parts["h"] = nn.ModuleList(TransformerBlock(cfg)
                                       for _ in range(cfg.n_layer))
            if cfg.ln:
                parts["ln_f"] = LayerNorm(cfg.n_embd, cfg.bias, cfg.dtype)
            self.transformer = nn.ModuleDict(parts)
            if not cfg.tie_emb:
                self.lm_head = Linear(cfg.n_embd, cfg.in_size, False,
                                      cfg.dtype)
        if dev.type != "meta":
            self.init_weights(seed)
            self.to(dev)

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        gen = torch.Generator().manual_seed(seed)
        resid_std = 0.02 / math.sqrt(2 * self.config.n_layer)
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)
            if isinstance(self.get_submodule(leaf[0]), LayerNorm):
                p.fill_(1.0 if leaf[1] == "weight" else 0.0)
            elif leaf[1] == "bias":
                p.zero_()
            else:
                std = resid_std if name.endswith("c_proj.weight") else 0.02
                p.copy_(torch.randn(p.shape, generator=gen) * std)

    def forward(self, x: torch.Tensor, cache: Optional[Sequence] = None,
                input_pos=None, deterministic: bool = True, taps=None,
                capture: bool = False):
        """Logits [b, t, vocab] in compute_dtype; with ``cache``, also the
        (in-place updated) caches. ``input_pos``: None, an int, or an int
        tensor, scalar or [b] (per-row positions)."""
        cfg = self.config
        if cfg.dropout > 0.0 and not deterministic:
            raise NotImplementedError("dropout is not ported")
        if taps or capture:
            raise NotImplementedError("activation taps and capture are not "
                                      "ported yet")
        wte = self.transformer["wte"].weight
        dev = wte.device
        x = cast(torch.as_tensor(x, device=dev), torch.int64)
        b, t = x.shape
        if t > cfg.block_size:
            raise ValueError(f"sequence length {t} > block size "
                             f"{cfg.block_size}")
        input_pos = _as_positions(input_pos, dev)
        h = cast(F.embedding(x, wte), cfg.dtype)
        if cfg.pos_embed:
            pos = _token_positions(input_pos, b, t, dev)
            if pos is None:
                pos = torch.arange(t, device=dev)[None]
            wpe = self.transformer["wpe"].weight
            h = h + cast(F.embedding(pos, wpe), cfg.dtype)
        remat = cfg.remat and cache is None and torch.is_grad_enabled()
        new_caches = []
        for i, block in enumerate(self.transformer["h"]):
            if remat:
                h, layer_cache = torch.utils.checkpoint.checkpoint(
                    block, h, None, input_pos, use_reentrant=False)
            else:
                h, layer_cache = block(h, None if cache is None
                                       else cache[i], input_pos)
            new_caches.append(layer_cache)
        if cfg.ln:
            h = self.transformer["ln_f"](h)
        if cfg.tie_emb:
            out = h @ cast_param(self, wte, cfg.dtype).T
        else:
            out = self.lm_head(h)
        if cache is not None:
            return out, tuple(new_caches)
        return out


def serving_copy(state_dict, config: TransformerConfig) -> Transformer:
    """A model over ``state_dict`` (on its tensors' device, grad off) whose
    parameters are each in the type its use reads, so that no call casts
    a weight (what infer/export_lm.py traces): the Linear weights and
    biases and the embedding tables in ``compute_dtype``, the LayerNorms'
    in fp32. The tied token table is read twice, gathered by the embedding
    (then cast to compute_dtype) and cast whole for the head; one copy in
    compute_dtype serves both bit for bit, since a cast is elementwise and
    the gather of the cast table is the cast of the gather. The same holds
    for ``wpe``. The state dict must fit the config (strict load)."""
    model = Transformer(config, device="meta")
    model.load_state_dict({k: v.detach() for k, v in state_dict.items()},
                          assign=True)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            m.to(config.dtype)
    return model.requires_grad_(False)


def init_cache(config: TransformerConfig, batch_size: int,
               dtype: torch.dtype = torch.float32,
               cache_len: Optional[int] = None,
               device: Union[str, torch.device, None] = None) -> Tuple:
    """Per-layer (k, v) buffers [B, cache_len, kv_heads, hd] on ``device``
    (None means CUDA). A buffer shorter than block_size is exact for
    requests that fit it (absolute-position mask)."""
    s = config.block_size if cache_len is None else cache_len
    assert s <= config.block_size, (s, config.block_size)
    dev = resolve_device(device)
    shape = (batch_size, s, config.kv_heads, config.head_dim)
    return tuple((torch.zeros(shape, dtype=dtype, device=dev),
                  torch.zeros(shape, dtype=dtype, device=dev))
                 for _ in range(config.n_layer))


def init_paged_cache(config: TransformerConfig, batch_size: int,
                     n_pages: int, page_size: int,
                     dtype: torch.dtype = torch.float32,
                     window: Optional[int] = None,
                     device: Union[str, torch.device, None] = None
                     ) -> Tuple:
    """Per layer (pool_k, pool_v, table): pools [n_pages, page_size,
    kv_heads, hd] and an all-zero (trash page) table [batch, window //
    page_size] int32. The table tensor is shared by the layers."""
    w = config.block_size if window is None else window
    assert w % page_size == 0, (w, page_size)
    dev = resolve_device(device)
    shape = (n_pages, page_size, config.kv_heads, config.head_dim)
    table = torch.zeros((batch_size, w // page_size), dtype=torch.int32,
                        device=dev)
    return tuple((torch.zeros(shape, dtype=dtype, device=dev),
                  torch.zeros(shape, dtype=dtype, device=dev), table)
                 for _ in range(config.n_layer))


def nucleus_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Mask logits outside the top-p probability mass to -inf, keeping the
    token that crosses the boundary (the nucleus is never empty)."""
    logits = logits.float()
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cumulative = torch.cumsum(sorted_probs, dim=-1)
    keep_sorted = (cumulative - sorted_probs) < top_p
    threshold = torch.where(keep_sorted, sorted_probs,
                            torch.full_like(sorted_probs, float("inf"))
                            ).min(dim=-1, keepdim=True).values
    return torch.where(probs < threshold,
                       torch.full_like(logits, float("-inf")), logits)


@torch.no_grad()
def generate(model: Transformer, idx, max_new_tokens: int, seed: int = 0,
             temperature: float = 1.0, top_k: Optional[int] = None,
             top_p: Optional[float] = None,
             cache_dtype: Optional[torch.dtype] = None,
             cache_len: Optional[int] = None) -> torch.Tensor:
    """Continue idx [b, t0] by max_new_tokens with a dense KV cache: one
    prefill, then one single-token step (K3) per new token, all on the
    model's device with no host sync until the caller reads the result.
    On CUDA the step (model, draw, position increment) is captured once as
    a CUDA graph and replayed for each token after the first, whose eager
    run is the graph's warm-up (infer/graphs.py); on the CPU it runs
    eagerly (``_generate_eager``). Both give the same tokens.

    temperature 0 is greedy (first-max argmax). Otherwise the draw is
    infer/export_lm.py ``sample_rows``: temperature, top-k, then nucleus,
    then a counter-based categorical draw that is a pure function of (row
    seed, absolute position, logits); row r's seed is ``seed + r``. JAX's
    threefry stream cannot be reproduced, so only greedy output equals
    tempo_tpu's. The cache defaults to fp32 and to the request rounded up
    to 64 slots; ``cache_len`` overrides that (e.g. a full serving window)."""
    out, step = _generate_start(model, idx, max_new_tokens, seed,
                                temperature, top_k, top_p, cache_dtype,
                                cache_len)
    if max_new_tokens > 1 and out.is_cuda:
        from tempo_tpu_torch.infer.graphs import CapturedCall

        graph = CapturedCall(step, stream=torch.cuda.Stream(out.device))
        for _ in range(max_new_tokens - 2):
            graph()
    else:
        for _ in range(max_new_tokens - 1):
            step()
    return out


@torch.no_grad()
def _generate_eager(model: Transformer, idx, max_new_tokens: int,
                    seed: int = 0, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    cache_dtype: Optional[torch.dtype] = None,
                    cache_len: Optional[int] = None) -> torch.Tensor:
    """``generate`` with every step run eagerly, on any device: the CPU's
    path, and the reference the captured steps are held to on the card."""
    out, step = _generate_start(model, idx, max_new_tokens, seed,
                                temperature, top_k, top_p, cache_dtype,
                                cache_len)
    for _ in range(max_new_tokens - 1):
        step()
    return out


def _generate_start(model, idx, max_new_tokens, seed, temperature, top_k,
                    top_p, cache_dtype, cache_len):
    """Prefill, the first new token, and the single-token step. Returns
    (out, step): out [b, t0 + max_new_tokens] holds the prompt and the
    tokens so far (column = absolute position); step() feeds out[:, pos],
    writes the drawn token to out[:, pos + 1] and advances pos (a 0-dim
    device tensor), all on the device with fixed shapes."""
    from tempo_tpu_torch.infer.export_lm import sample_rows

    cfg = model.config
    dev = model.transformer["wte"].weight.device
    idx = torch.as_tensor(idx, device=dev).long()
    b, t0 = idx.shape
    if t0 + max_new_tokens > cfg.block_size:
        raise ValueError(f"prompt {t0} + {max_new_tokens} new tokens exceeds "
                         f"block size {cfg.block_size}")
    if cache_len is None:
        cache_len = min(cfg.block_size, -((t0 + max_new_tokens) // -64) * 64)
    if not t0 + max_new_tokens <= cache_len <= cfg.block_size:
        raise ValueError(f"cache_len {cache_len} outside [{t0 + max_new_tokens}"
                         f", {cfg.block_size}]")
    cache = init_cache(cfg, b, dtype=cache_dtype or torch.float32,
                       cache_len=cache_len, device=dev)
    seeds = seed + torch.arange(b, device=dev)
    temp = torch.full((b,), float(temperature), device=dev)
    topk = torch.full((b,), int(top_k or 0), device=dev)
    topp = torch.full((b,), 1.0 if top_p is None else float(top_p),
                      device=dev)

    def sample(logits_last, pos):
        if temperature == 0.0:
            return torch.argmax(logits_last.float(), dim=-1)
        return sample_rows(logits_last, seeds, pos.expand(b), temp, topk,
                           topp)

    out = torch.zeros((b, t0 + max_new_tokens), dtype=torch.long, device=dev)
    out[:, :t0] = idx
    pos = torch.full((), t0, dtype=torch.int32, device=dev)
    logits, cache = model(idx, cache=cache, input_pos=torch.zeros_like(pos))
    out[:, t0] = sample(logits[:, -1], pos - 1)

    def step():
        col = pos.long().reshape(1)
        logits, _ = model(out.index_select(1, col), cache=cache,
                          input_pos=pos)
        out.index_copy_(1, col + 1, sample(logits[:, -1], pos)[:, None])
        pos.add_(1)

    return out, step


def num_params(model: nn.Module, non_embedding: bool = True) -> int:
    """Parameter count; subtracts the learned position table by default."""
    total = sum(p.numel() for p in model.parameters())
    if non_embedding and "wpe" in model.transformer:
        total -= model.transformer["wpe"].weight.numel()
    return total


def estimate_mfu(config: TransformerConfig, n_params: int,
                 fwdbwd_per_iter: float, dt: float,
                 peak_flops: float) -> float:
    """Model FLOPs utilization, PaLM appendix-B accounting (as
    tempo_tpu's estimate_mfu): 6 N + 12 L H Q T FLOPs per token, T tokens
    per sequence, ``fwdbwd_per_iter`` sequences per iteration of ``dt``
    seconds, over ``peak_flops`` (the card's peak, which the caller
    states: there is no default)."""
    L, H, Q, T = (config.n_layer, config.n_head, config.head_dim,
                  config.block_size)
    flops_per_token = 6 * n_params + 12 * L * H * Q * T
    return flops_per_token * T * fwdbwd_per_iter / dt / peak_flops


def gpt_decay_mask(model: nn.Module) -> dict:
    """{parameter name: decays}: Linear weights and the wte/wpe tables
    decay; biases and LayerNorm weights (norm scales, named ``weight`` in
    torch) do not. tempo_tpu's name-keyed rule (``kernel``, ``wte``,
    ``wpe``) on the port's modules."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = leaf == "weight" and isinstance(
                mod, (nn.Linear, nn.Embedding))
    return out


def make_gpt_optimizer(model: nn.Module, weight_decay: float, learning_rate,
                       betas: Tuple[float, float],
                       moments_dtype: Optional[str] = None) -> Optimizer:
    """AdamW (eps 1e-8, no gradient clipping) with weight decay only on the
    ``gpt_decay_mask`` parameters: two parameter groups, as the reference's
    two optimizer groups. ``learning_rate`` is a float or a function of the
    update count (train/schedules.py lr_schedule)."""
    if moments_dtype is not None:
        raise NotImplementedError("optimizer.moments_dtype is not ported")
    mask = gpt_decay_mask(model)

    def groups(m: nn.Module) -> list:
        named = list(m.named_parameters())
        return [{"params": [p for k, p in named if mask[k]],
                 "weight_decay": weight_decay},
                {"params": [p for k, p in named if not mask[k]],
                 "weight_decay": 0.0}]

    return Optimizer(learning_rate, groups, betas, eps=1e-8,
                     max_grad_norm=None)
