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
  per group first, and otherwise (the XLA path, taps, live dropout) runs
  the materialized attention (``_materialized_attention``, the plain
  masked attention's ops); every cache call with t > 1 runs the plain
  masked attention; a
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

Options (the JAX package's): ``n_experts`` > 0 swaps each block's MLP for
an MoE FFN (nn/moe.py; ``with_aux=True`` also returns the mean Switch
loss over the blocks); ``quantize="int8"`` holds the block matmuls, the
token table and the expert kernels int8 with fp32 scales (nn/quant.py:
inference only, weights from ``quantize_lm_params``); ``dropout`` > 0 with
``deterministic=False`` drops at JAX's five sites (the embeddings, the
attention weights, the attention output after ``c_proj``, the MLP after
``c_proj``, the MoE hidden) drawing from ``generator``: live attention
dropout needs the weights, so that forward takes the materialized
attention, never K5, as JAX does.

Interpretability (JAX's ``tap``, transformer.py:172, 276-310, 549-570,
614-716): ``forward(taps=, capture=, suffix=)`` records and patches the
named activations (``tok_emb``, ``pos_emb``, ``x_0``, ``kT``/``qT``,
``q_rope``/``k_rope``/``v`` or ``q``/``k``/``v`` as [b, heads, t, hd],
``attn_um``, ``attn``, ``y_out``, ``y_out_proj``, ``attn_res``,
``x_attn``, ``mlp_res``, ``x_i``, ``x_ln_f``, block names with ``^i``); a
patch (array, w) makes the value x + w * (patch - x); ``capture=True``
returns the flat dict of what was recorded last (``cached_forward``).
Without a cache, taps take the materialized attention, which exposes the
scores (JAX's ``:454-473``) and is the ``attn_impl="xla"`` path itself, so
with nothing patched the logits are bitwise an xla forward's, and K5 is
never used.
With a cache the cache branch runs as always (K3 at t == 1) and
``attn_um``/``attn`` are not tapped. Remat is off under taps.

Input modes (the reference's three, networks.py:405-527): tokenized (the
token table ``wte`` and the tied head), untokenized (``TiedLinear``: one
[n_embd, in_size] weight ``transformer.wte.lin.weight`` used forward and
transposed), and dicts of named ``embedders`` / ``unembedders`` modules
(the input a dict of tensors whose embeddings are summed, an embedder
named ``pos`` in place of ``wpe``, ``unembedders["x"]`` the head).
``generate``, ``beam_search`` and ``export_lm`` take tokenized models only,
as in JAX.

Training: ``gpt_decay_mask`` / ``make_gpt_optimizer`` (AdamW, two
parameter groups, no clipping; ``moments_dtype="bfloat16"`` stores the
first moment in bf16, as optax's ``mu_dtype``) and ``estimate_mfu``.

Not ported yet (raise NotImplementedError): ``seq_axis``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops import cuda_decode, flash_attention
from tempo_tpu_torch.ops.norms import gelu_exact
from tempo_tpu_torch.parallel import tensor
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
    if cfg.seq_axis is not None:
        raise NotImplementedError("seq_axis (context parallelism) is not "
                                  "ported yet")
    if cfg.quantize not in ("none", "int8"):
        raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
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
    torch.inference_mode() (no version count), nor for a tensor that is
    not a Parameter. A cast missing from the cache inside a CUDA graph
    capture raises, and so does any cast under torch.export (export
    ``serving_copy``)."""
    if p.dtype == dtype:
        return p
    if torch.compiler.is_exporting():
        raise RuntimeError(
            "a parameter's cast inside torch.export would run at every call "
            "of the program: export a serving_copy, whose parameters are in "
            "the types their uses read")
    if ((torch.is_grad_enabled() and p.requires_grad) or p.is_inference()
            or not isinstance(p, nn.Parameter)):
        # a weight computed in the call (nn/lora.py's adapted weights
        # through functional_call) is new at every call: nothing to cache
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
        return tensor.sharded_call(
            self, lambda t: F.linear(t, cast_param(self, self.weight, dt), b),
            cast(x, dt))


def make_linear(cin: int, cout: int, bias: bool, cfg: TransformerConfig
                ) -> nn.Module:
    """The block matmul layer: Linear, or its int8 twin (nn/quant.py
    QuantLinear) when cfg.quantize == 'int8' (JAX's ``_dense``)."""
    if cfg.quantize == "int8":
        from tempo_tpu_torch.nn.quant import QuantLinear

        return QuantLinear(cin, cout, bias, cfg.dtype)
    return Linear(cin, cout, bias, cfg.dtype)


class Dropout:
    """Live dropout at rate ``p`` (flax nn.Dropout): keep each element with
    probability 1 - p, kept values scaled by 1 / (1 - p), the draws from
    ``generator`` (None: the device's default generator)."""

    def __init__(self, p: float, generator: Optional[torch.Generator]):
        self.p = p
        self.generator = generator

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) < 1.0 - self.p
        return torch.where(keep, x / (1.0 - self.p),
                           torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.Module):
    """eps 1e-5, optional bias, fp32 statistics, output in ``dtype``."""

    def __init__(self, c: int, bias: bool, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c)) if bias else None
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight, bias = tensor.affine(self)
        h = F.layer_norm(cast(x, torch.float32), x.shape[-1:], weight, bias,
                         1e-5)
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
Patches = Dict[str, Tuple[torch.Tensor, float]]
Tap = Callable[[torch.Tensor, str], torch.Tensor]


class Taps:
    """The taps of one forward: ``tap(x, name)`` records x under ``name``
    in ``hiddens`` when capturing (the value before its patch, as JAX's
    ``sow``), and returns x + w * (patch - x) where ``patches`` holds
    (patch, w) under ``name`` (reference network_tools.py:65-76), x
    itself elsewhere."""

    def __init__(self, patches: Optional[Patches], capture: bool):
        self.patches = patches or {}
        self.hiddens: Optional[Dict[str, torch.Tensor]] = (
            {} if capture else None)

    def __call__(self, x: torch.Tensor, name: str) -> torch.Tensor:
        if self.hiddens is not None:
            self.hiddens[name] = x
        hit = self.patches.get(name)
        if hit is None:
            return x
        patch, w = hit
        patch = cast(torch.as_tensor(patch, device=x.device), x.dtype)
        return x + w * (patch - x)

    def suffixed(self, suffix: str) -> Tap:
        return lambda x, name: self(x, name + suffix)


def _tap(tap: Optional[Tap], x: torch.Tensor, name: str) -> torch.Tensor:
    return x if tap is None else tap(x, name)


def _tap_heads(tap: Optional[Tap], x: torch.Tensor,
               name: str) -> torch.Tensor:
    """Tap x [b, t, heads, hd] in the reference's [b, heads, t, hd]."""
    if tap is None:
        return x
    return tap(x.transpose(1, 2), name).transpose(1, 2)


def _materialized_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool,
                            tap: Optional[Tap],
                            drop: Optional[Dropout]) -> torch.Tensor:
    """The no-cache attention outside K5 (the XLA path, taps, live
    dropout): the grouped einsum of cuda_decode.masked_attention in its
    order, with ``attn_um`` (the scaled scores before the mask) and
    ``attn`` (the weights) tapped as [b, n_head, t, t] (GQA's heads
    kv-major, as JAX's repeated K/V give them), then attention-weight
    dropout. With nothing patched the taps change no bit. Returns [b, t,
    n, hd] in fp32."""
    b, t, n, hd = q.shape
    kv = k.shape[2]
    g = n // kv

    def tapped(a: torch.Tensor, name: str) -> torch.Tensor:
        if tap is None:
            return a
        return tap(a.reshape(b, n, t, t), name).reshape(b, kv, g, t, t)

    qg = cuda_decode._f32(q.reshape(b, t, kv, g, hd))
    scores = tapped(torch.einsum("bqkgh,bskh->bkgqs", qg,
                                 cuda_decode._f32(k)) / math.sqrt(hd),
                    "attn_um")
    if causal:
        steps = torch.arange(t, device=q.device)
        mask = steps[None, None, :] <= steps[None][:, :, None]
        scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    weights = tapped(torch.softmax(scores, dim=-1), "attn")
    if drop is not None:
        weights = drop(weights)
    y = torch.einsum("bkgqs,bskh->bqkgh", weights, cuda_decode._f32(v))
    return y.reshape(b, t, n, hd)


class SelfAttention(nn.Module):
    """Causal multi-head (or grouped-query) attention with an optional
    dense or paged KV cache."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        c, hd, kv = cfg.n_embd, cfg.head_dim, cfg.kv_heads
        self.c_attn = make_linear(c, c + 2 * kv * hd, cfg.bias, cfg)
        self.c_proj = make_linear(c, c, cfg.bias, cfg)
        self._rope: Optional[torch.Tensor] = None

    def _rope_table(self, device: torch.device) -> torch.Tensor:
        cfg = self.config
        if self._rope is None or self._rope.device != device:
            _refuse_setup_in_capture(device, "the RoPE table")
            self._rope = rope_cache(cfg.block_size, cfg.head_dim,
                                    cfg.rope_base, device)
        return self._rope

    def forward(self, x: torch.Tensor, cache: Optional[Cache] = None,
                input_pos: Optional[torch.Tensor] = None,
                drop: Optional[Dropout] = None, tap: Optional[Tap] = None
                ) -> Tuple[torch.Tensor, Optional[Cache]]:
        """``tap``: the block's taps (names suffixed), or None."""
        cfg = self.config
        b, t, c = x.shape
        n, hd, kv = cfg.n_head, cfg.head_dim, cfg.kv_heads
        qkv = self.c_attn(x)
        q = qkv[..., :c].reshape(b, t, n, hd)
        k = qkv[..., c:c + kv * hd].reshape(b, t, kv, hd)
        v = qkv[..., c + kv * hd:].reshape(b, t, kv, hd)
        tok_pos = _token_positions(input_pos, b, t, x.device)
        if cfg.rope:
            k = _tap(tap, k, "kT")
            q = _tap(tap, q, "qT")
            full = self._rope_table(x.device)
            rc = full[:t] if tok_pos is None else full[tok_pos]
            if rc.ndim == 4 and rc.shape[0] == 1:
                rc = rc[0]  # one scalar position: [t, hd//2, 2]
            q = _tap_heads(tap, apply_rope(q, rc), "q_rope")
            k = _tap_heads(tap, apply_rope(k, rc), "k_rope")
        else:
            q = _tap_heads(tap, q, "q")
            k = _tap_heads(tap, k, "k")
        v = _tap_heads(tap, v, "v")

        new_cache = None
        if cache is None and tap is None and drop is None and _flash_ok(cfg,
                                                                       q):
            if kv < n:  # GQA trains at MHA FLOPs: K/V repeated per group
                k = k.repeat_interleave(n // kv, dim=2)
                v = v.repeat_interleave(n // kv, dim=2)
            y = flash_attention.flash_attention(q, k, v, cfg.causal,
                                                1.0 / math.sqrt(hd))
        elif cache is None:
            y = _materialized_attention(q, k, v, cfg.causal, tap, drop)
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
        y = _tap(tap, cast(y, cfg.dtype).reshape(b, t, c), "y_out")
        y = self.c_proj(y)
        if drop is not None:
            y = drop(y)
        return _tap(tap, y, "y_out_proj"), new_cache

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
        self.c_fc = make_linear(cfg.n_embd, d_hidden, cfg.bias, cfg)
        self.c_proj = make_linear(d_hidden, cfg.n_embd, cfg.bias, cfg)

    def forward(self, x: torch.Tensor,
                drop: Optional[Dropout] = None) -> torch.Tensor:
        h = self.c_proj(gelu_exact(self.c_fc(x)))
        return h if drop is None else drop(h)


class TransformerBlock(nn.Module):
    """pre-LN attention + MLP (or MoE) residual block; forward returns
    (x, the updated cache, the MoE block's Switch loss or None)."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.config = cfg
        if cfg.ln:
            self.ln_1 = LayerNorm(cfg.n_embd, cfg.bias, cfg.dtype)
        self.attn = SelfAttention(cfg)
        if cfg.mlp:
            if cfg.ln:
                self.ln_2 = LayerNorm(cfg.n_embd, cfg.bias, cfg.dtype)
            if cfg.n_experts > 0:
                from tempo_tpu_torch.nn.moe import MoEBlock

                self.moe = MoEBlock(cfg)
            else:
                self.mlp = MLPBlock(cfg)

    def forward(self, x, cache=None, input_pos=None, drop=None, tap=None):
        cfg = self.config
        h = self.ln_1(x) if cfg.ln else x
        attn_res, new_cache = self.attn(h, cache, input_pos, drop, tap)
        x = _tap(tap, x + _tap(tap, attn_res, "attn_res"), "x_attn")
        aux = None
        if cfg.mlp:
            h = self.ln_2(x) if cfg.ln else x
            if cfg.n_experts > 0:
                mlp_res, aux = self.moe(h, drop)
            else:
                mlp_res = self.mlp(h, drop)
            x = x + _tap(tap, mlp_res, "mlp_res")
        return x, new_cache, aux


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


class TiedLinear(nn.Module):
    """One weight [n_embd, in_size] used forward ([.., in] -> [.., embd])
    and transposed ([.., embd] -> [.., in]) for untokenized input and
    output (JAX's TiedLinear, whose kernel is this weight transposed;
    reference networks.py:405-416, ``transformer.wte.lin``)."""

    def __init__(self, in_size: int, n_embd: int,
                 compute_dtype: torch.dtype):
        super().__init__()
        self.lin = Linear(in_size, n_embd, False, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lin(x)

    def transposed(self, y: torch.Tensor) -> torch.Tensor:
        dt = self.lin.compute_dtype
        return cast(y, dt) @ cast_param(self.lin, self.lin.weight, dt)


def _apply(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module(x)`` with a floating x promoted to the type of the module's
    parameters where they differ, as a flax module without ``dtype``
    promotes its input and parameters to a common type."""
    p = next(module.parameters(), None)
    if p is not None and x.is_floating_point() and x.dtype != p.dtype:
        x = x.to(torch.promote_types(x.dtype, p.dtype))
    return module(x)


def _as_input(v, device: torch.device) -> torch.Tensor:
    """A model input on ``device``; fp64 becomes fp32, as jnp.asarray
    makes it."""
    v = torch.as_tensor(v, device=device)
    return v.float() if v.dtype == torch.float64 else v


class Transformer(nn.Module):
    """GPT (tokenized, weight-tied head by default), on ``device`` (None
    means CUDA; raises without it unless "cpu" is asked for), weights drawn
    from ``seed`` with the JAX package's init distributions: normal(0.02)
    matmuls and embeddings, residual projections scaled by 1/sqrt(2L),
    zero biases, LayerNorm ones.

    ``embedders`` / ``unembedders``: dicts of named modules (both or
    neither), kept with their own initialization and moved to ``device``;
    the input is then a dict of tensors, and ``unembedders["x"]`` maps the
    final hidden state out."""

    def __init__(self, config: TransformerConfig,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0, embedders=None, unembedders=None):
        super().__init__()
        if (embedders is None) != (unembedders is None):
            raise ValueError("embedders and unembedders go together")
        _check_supported(config)
        dev = resolve_device(device)
        self.config = cfg = config
        # device "meta" builds the shapes only (parameter counts, no memory)
        with torch.device("meta" if dev.type == "meta" else "cpu"):
            parts = {}  # in embedder mode the embedders take wte's place
            if embedders is None and not cfg.tokenized:
                parts["wte"] = TiedLinear(cfg.in_size, cfg.n_embd, cfg.dtype)
            elif embedders is None and cfg.quantize == "int8":
                from tempo_tpu_torch.nn.quant import QuantEmbedding

                parts["wte"] = QuantEmbedding(cfg.in_size, cfg.n_embd)
            elif embedders is None:
                parts["wte"] = nn.Embedding(cfg.in_size, cfg.n_embd)
            if cfg.pos_embed and "pos" not in (embedders or {}):
                parts["wpe"] = nn.Embedding(cfg.block_size, cfg.n_embd)
            parts["h"] = nn.ModuleList(TransformerBlock(cfg)
                                       for _ in range(cfg.n_layer))
            if cfg.ln:
                parts["ln_f"] = LayerNorm(cfg.n_embd, cfg.bias, cfg.dtype)
            self.transformer = nn.ModuleDict(parts)
            if not cfg.tie_emb and cfg.tokenized and embedders is None:
                self.lm_head = make_linear(cfg.n_embd, cfg.in_size, False,
                                           cfg)
        self.embedders = self.unembedders = None
        if embedders is not None:
            self.embedders = nn.ModuleDict(embedders)
            self.unembedders = nn.ModuleDict(unembedders)
        if dev.type != "meta":
            self.init_weights(seed)
            self.to(dev)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @torch.no_grad()
    def init_weights(self, seed: int = 0) -> None:
        """The int8 twin's placeholders as JAX's: kernels 0, scales 1."""
        gen = torch.Generator().manual_seed(seed)
        resid_std = 0.02 / math.sqrt(2 * self.config.n_layer)
        for name, p in self.named_parameters():
            if name.startswith(("embedders.", "unembedders.")):
                continue  # the caller's modules keep their own init
            leaf = name.rsplit(".", 1)
            if isinstance(self.get_submodule(leaf[0]), LayerNorm):
                p.fill_(1.0 if leaf[1] == "weight" else 0.0)
            elif leaf[1] in ("bias", "b1", "b2") or p.dtype == torch.int8:
                p.zero_()
            elif leaf[1].endswith("scale"):
                p.fill_(1.0)
            else:
                resid = name.endswith("c_proj.weight") or leaf[1] == "w2"
                std = resid_std if resid else 0.02
                p.copy_(torch.randn(p.shape, generator=gen) * std)

    def forward(self, x, cache: Optional[Sequence] = None,
                input_pos=None, deterministic: bool = True,
                taps: Optional[Patches] = None, capture: bool = False,
                generator: Optional[torch.Generator] = None,
                with_aux: bool = False, suffix: str = ""):
        """Logits [b, t, vocab] (or the unembedder's output) in
        compute_dtype; with ``cache``, also the (in-place updated) caches;
        with ``with_aux``, the mean of the MoE blocks' Switch losses (0
        without experts), JAX's ``'losses'`` collection; with ``capture``,
        last, the flat dict of the recorded activations. ``x``: token ids
        [b, t], features [b, t, in_size] (untokenized), or a dict of tensors
        (embedder mode). ``input_pos``: None, an int, or an int tensor,
        scalar or [b] (per-row positions). ``deterministic=False`` with
        ``dropout`` > 0 makes dropout live, drawing from ``generator``
        (None: the device's default generator). ``taps``: {name: (patch,
        w)}; ``suffix`` is appended to every tap name."""
        cfg = self.config
        taps_ = Taps(taps, capture) if (taps or capture) else None
        tap = None if taps_ is None else taps_.suffixed(suffix)
        drop = (Dropout(cfg.dropout, generator)
                if cfg.dropout > 0.0 and not deterministic else None)
        dev = self.device
        input_pos = _as_positions(input_pos, dev)
        if self.embedders is not None:
            h = self._embed_dict(x, dev)
        else:
            h = self._embed(x, input_pos, dev, tap)
        if drop is not None:
            h = drop(h)
        h = _tap(tap, h, "x_0")
        remat = (cfg.remat and cache is None and torch.is_grad_enabled()
                 and tap is None)
        new_caches, auxes = [], []
        for i, block in enumerate(self.transformer["h"]):
            if remat:
                h, layer_cache, aux = _remat_block(block, h, input_pos, drop)
            else:
                h, layer_cache, aux = block(
                    h, None if cache is None else cache[i], input_pos, drop,
                    None if tap is None else taps_.suffixed(
                        f"{suffix}^{i + 1}"))
            h = _tap(tap, h, f"x_{i + 1}")
            new_caches.append(layer_cache)
            auxes.append(aux)
        out = self.unembed(h, tap)
        result = (out,) if cache is None else (out, tuple(new_caches))
        if with_aux:
            from tempo_tpu_torch.nn.moe import moe_aux_mean

            aux = moe_aux_mean(auxes)
            result += (torch.zeros((), device=dev) if aux is None else aux,)
        if capture:
            result += (taps_.hiddens,)
        return result[0] if len(result) == 1 else result

    def unembed(self, h: torch.Tensor, tap: Optional[Tap] = None
                ) -> torch.Tensor:
        """The final LayerNorm and the head on the last block's output (the
        tied table's transpose, ``lm_head``, the int8 table, the
        untokenized TiedLinear's transpose, or the unembedder)."""
        cfg = self.config
        if cfg.ln:
            h = self.transformer["ln_f"](h)
        h = _tap(tap, h, "x_ln_f")
        wte = self.transformer["wte"] if "wte" in self.transformer else None
        if self.unembedders is not None:
            return _apply(self.unembedders["x"], h)
        if not cfg.tokenized:
            return wte.transposed(h)
        if not cfg.tie_emb:
            return self.lm_head(h)
        if cfg.quantize == "int8":
            return wte.head(h, cfg.dtype)
        # under TP the n_embd-sharded table is gathered for it
        return h @ tensor.gather_output(
            wte, cast_param(self, wte.weight, cfg.dtype), "weights").T

    def _embed(self, x, input_pos: Optional[torch.Tensor],
               dev: torch.device, tap: Optional[Tap]) -> torch.Tensor:
        """Token (or TiedLinear feature) embeddings plus the learned
        positions, tapped as ``tok_emb`` and ``pos_emb`` ([t, c] for one
        position origin, [b, t, c] for per-row positions, as JAX's)."""
        cfg = self.config
        wte = self.transformer["wte"]
        x = _as_input(x, dev)
        if cfg.tokenized:
            x = cast(x, torch.int64)
        b, t = x.shape[:2]
        if t > cfg.block_size:
            raise ValueError(f"sequence length {t} > block size "
                             f"{cfg.block_size}")
        if not cfg.tokenized:
            h = wte(x)
        elif cfg.quantize == "int8":
            h = wte.embed(x, cfg.dtype)
        else:
            h = tensor.gather_output(
                wte, cast(F.embedding(x, wte.weight), cfg.dtype))
        h = _tap(tap, h, "tok_emb")
        if cfg.pos_embed:
            wpe = self.transformer["wpe"]
            pos = _token_positions(input_pos, b, t, dev)

            def pos_emb(p: torch.Tensor) -> torch.Tensor:
                return _tap(tap, tensor.gather_output(wpe, cast(
                    F.embedding(p, wpe.weight), cfg.dtype)), "pos_emb")

            if pos is None or input_pos.ndim == 0:
                pos = torch.arange(t, device=dev) if pos is None else pos[0]
                h = h + pos_emb(pos)[None]
            else:
                h = h + pos_emb(pos)
        return h

    def _embed_dict(self, x, dev: torch.device) -> torch.Tensor:
        """Embedder mode: the embeddings of every key of ``x`` summed over
        zeros in compute_dtype, plus the positions of 0..t-1 (the ``pos``
        embedder's, or ``wpe``'s); type promotion as JAX's (an fp32
        embedder's output lifts a bf16 sum to fp32)."""
        cfg = self.config
        if not isinstance(x, dict):
            raise TypeError("a model with embedders takes a dict of inputs")
        xs = {k: _as_input(v, dev) for k, v in x.items()}
        if "pos" in xs:
            raise ValueError("'pos' names the position embedder, not an "
                             "input")
        b, t = next(iter(xs.values())).shape[:2]
        h = torch.zeros((b, t, cfg.n_embd), dtype=cfg.dtype, device=dev)
        if cfg.pos_embed:
            pos = torch.arange(t, device=dev)
            if "pos" in self.embedders:
                h = h + _apply(self.embedders["pos"], pos)
            else:
                h = h + cast(F.embedding(pos, self.transformer["wpe"].weight),
                             cfg.dtype)
        for key, v in xs.items():
            h = h + _apply(self.embedders[key], v)
        return h


def cached_forward(model: Transformer, x, **kwargs):
    """(out, flat dict of the activations) of one forward with capture:
    JAX's ``cached_forward`` (the reference's activation capture,
    networks.py:529-564). ``out`` is what the forward returns without
    capture: the logits, or (logits, caches) with a cache."""
    result = model(x, capture=True, **kwargs)
    out = result[:-1]
    return (out[0] if len(out) == 1 else out), result[-1]


def require_tokenized(model: nn.Module, what: str) -> None:
    """``what`` decodes tokens: refuse an untokenized or embedder-mode
    model (JAX asserts cfg.tokenized, transformer.py:849)."""
    if not model.config.tokenized or getattr(model, "embedders",
                                             None) is not None:
        raise ValueError(f"{what} requires a tokenized model")


def _remat_block(block: TransformerBlock, h: torch.Tensor, input_pos,
                 drop: Optional[Dropout]):
    """``block`` under torch.utils.checkpoint (nn.remat): its activations
    are recomputed in the backward. checkpoint restores the default
    generators' state for the recompute, not an explicit one's: live
    dropout from a generator draws from a copy of its state taken here, in
    the forward and again in the recompute, and the generator then moves
    on to where the forward's draws left it."""
    if drop is None or drop.generator is None:
        return torch.utils.checkpoint.checkpoint(
            block, h, None, input_pos, drop, use_reentrant=False)
    start, end = drop.generator.get_state(), {}

    def run(h):
        g = torch.Generator(device=h.device)
        g.set_state(start)
        out = block(h, None, input_pos, Dropout(drop.p, g))
        end.setdefault("state", g.get_state())
        return out

    out = torch.utils.checkpoint.checkpoint(run, h, use_reentrant=False)
    drop.generator.set_state(end["state"])
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
    for ``wpe``. The state dict must fit the config (strict load). An int8
    model keeps its int8 kernels (dequantized at each read, the point of
    them) and holds its scales and biases in compute_dtype; the MoE router
    stays fp32, the type it computes in."""
    model = Transformer(config, device="meta")
    model.load_state_dict({k: v.detach() for k, v in state_dict.items()},
                          assign=True)
    for m in model.modules():
        if isinstance(m, Linear):
            m.to(m.compute_dtype)
        elif isinstance(m, nn.Embedding):
            m.to(config.dtype)
        elif m is not model and not isinstance(m, LayerNorm):
            for name, p in m.named_parameters(recurse=False):
                if p.is_floating_point():
                    setattr(m, name, nn.Parameter(p.to(config.dtype)))
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


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row, best first,
    the lowest index first among ties, as ``lax.top_k`` orders them
    (``torch.topk`` promises no order among ties on CUDA): an argmax (the
    first max) for k = 1, a stable descending sort otherwise."""
    if k == 1:
        idx = torch.argmax(x, dim=-1, keepdim=True)
        return x.gather(-1, idx), idx
    order = torch.sort(x, dim=-1, descending=True, stable=True)
    return order.values[..., :k], order.indices[..., :k]


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

    require_tokenized(model, "generate")
    cfg = model.config
    dev = model.device
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


# leaf names that decay besides Linear / Embedding weights (JAX's
# ``kernel``, ``wte``, ``wpe``, ``embedding``): the stacked expert matmuls
DECAY_LEAVES = ("w1", "w2")


def gpt_decay_mask(model: nn.Module) -> dict:
    """{parameter name: decays}: Linear weights (the MoE router's too), the
    wte/wpe tables and the stacked expert kernels ``w1``/``w2`` decay;
    biases (the experts' ``b1``/``b2`` too), LayerNorm weights (norm
    scales, named ``weight`` in torch) and LoRA adapters (``a``/``b``) do
    not. tempo_tpu's name-keyed rule (``kernel``, ``w1``, ``w2``, ``wte``,
    ``wpe``, ``embedding``) on the port's modules."""
    out = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{leaf}" if mod_name else leaf
            out[name] = leaf in DECAY_LEAVES or (
                leaf == "weight" and isinstance(mod, (nn.Linear,
                                                      nn.Embedding)))
    return out


def make_gpt_optimizer(model: nn.Module, weight_decay: float, learning_rate,
                       betas: Tuple[float, float],
                       moments_dtype: Optional[str] = None) -> Optimizer:
    """AdamW (eps 1e-8, no gradient clipping) with weight decay only on the
    ``gpt_decay_mask`` parameters: two parameter groups, as the reference's
    two optimizer groups. ``learning_rate`` is a float or a function of the
    update count (train/schedules.py lr_schedule). ``moments_dtype``
    'bfloat16' keeps the first moment in bf16 (optax's ``mu_dtype``;
    train/state.py ``MuAdamW``), the second in fp32."""
    if moments_dtype not in (None, "float32", "bfloat16"):
        raise ValueError(f"unknown moments_dtype {moments_dtype!r} "
                         f"(bfloat16 | float32)")
    mask = gpt_decay_mask(model)

    def groups(m: nn.Module) -> list:
        named = list(m.named_parameters())
        return [{"params": [p for k, p in named if mask[k]],
                 "weight_decay": weight_decay},
                {"params": [p for k, p in named if not mask[k]],
                 "weight_decay": 0.0}]

    return Optimizer(learning_rate, groups, betas, eps=1e-8,
                     max_grad_norm=None,
                     moments_dtype=(None if moments_dtype == "float32"
                                    else moments_dtype))
