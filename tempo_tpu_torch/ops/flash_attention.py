"""K5: flash attention for training (forward K5f, backward K5dkv and K5dq).

Counterpart of tempo_tpu/nn/transformer.py ``_flash_attention``, which
calls the library Pallas TPU ``flash_attention`` (its forward, its
``_flash_attention_bwd_dkv`` and its ``_flash_attention_bwd_dq``). The CUDA
source is csrc/flash_attn.cu, whose header says what bounds the kernels on
the H100 and how they are laid out.

``flash_attention(q, k, v, causal, sm_scale)`` over q, k, v [b, t, n, hd]
(the same number of heads: the caller repeats GQA's K/V) is an autograd
Function. Its forward saves the output and the fp32 logsumexp [b, n, t];
its backward computes di = rowsum(dO * O) in fp32, as the library does
outside its kernels, then runs the dK/dV pass and the dQ pass, both of
which recompute the probabilities from q, k and the logsumexp.

The kernels (csrc/flash_attn.cu), bf16 operands with fp32 accumulation and
the score tile kept in registers:

- K5f runs on ``wgmma``: a block is one warpgroup that owns 64 query rows
  of one (batch, head) and walks 64-key tiles. q's A fragments are loaded
  once by ``ldmatrix`` and stay in registers; k and v tiles arrive by
  16-byte ``cp.async`` into a ring of 2 stages, the next tile in flight
  during this tile's products, in the swizzled layout the ``wgmma``
  descriptors read: k k-major for S = q.k^T, v n-major from its one
  row-major tile for O += P.v, P straight from the score registers. The
  softmax runs in the log2 domain with the scale folded into the
  exponent's FMA. 128 registers and 42 KB a block at hd 64, 4 blocks an SM.
- K5dq is K5f's block with three products: S = q.k^T and dP = dO.v^T in
  one ``wgmma`` group (q's and dO's A fragments resident, k and v tiles
  k-major from the same ring), then dQ += dS.k with dS packed to bf16 from
  the score registers and k read n-major from the tile S read k-major. Key
  tiles of 64 (32 at hd 128, where 64-key score tiles beside the 64
  accumulator registers spill). 174 registers and 51 KB at hd 64.
- K5dkv runs on ``mma.sync``: a block owns 64 key rows (4 warps of 16) and
  walks 64-query tiles (32 at hd 128). k's and v's A fragments stay in
  registers (hd <= 64); q, dO, lse and di tiles arrive through the same
  kind of ring; q and dO are read by ``ldmatrix.x4`` for S^T and dP^T and
  by ``ldmatrix.x4.trans`` for dV and dK. A tile goes S^T -> P -> dV ->
  dP^T -> dS -> dK, so one fp32 score tile is live beside the two
  accumulators (244 registers at hd 64, no spill).
- All three visit no tile wholly outside the causal triangle, mask only
  tiles that cross the diagonal or the ragged end of the sequence, and
  zero-fill rows past t in the copy itself. What bounds them: at hd 64 a
  call sits on the ridge between bytes and tensor-core operations; the
  kernels themselves are held by the serial chain of a tile (products,
  wait, softmax or dS, products) and, in K5dkv, by the instruction stream
  around its ``mma.sync`` products, not by memory. Left for later: K5dkv
  on ``wgmma``, overlapping a tile's elementwise step with the next tile's
  products, and TMA.

Each pass has a plain PyTorch version with the same math (the backward
recomputes P from q, k and lse; it is not autograd through a softmax). A
wrapper takes its plain version for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises. Each counts its launches in
``LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from tempo_tpu_torch.ops import _build
from tempo_tpu_torch.ops.cuda_gn import DTYPE_CODES, refuse_grad

HEAD_DIMS = (32, 64, 128)  # head dims the kernels are built for
# Launches of each kernel, counted by its wrapper where it launches it.
LAUNCHES = {"flash_fwd": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}


def supported(q: torch.Tensor) -> bool:
    """Whether the kernels take q's head dim and type."""
    return q.dtype in DTYPE_CODES and q.shape[-1] in HEAD_DIMS


def _scale(q: torch.Tensor, sm_scale: Optional[float]) -> float:
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else float(sm_scale)


# ----------------------------------------------------------- plain versions

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            sm_scale: float) -> torch.Tensor:
    """sm_scale * q.k^T [b, n, tq, tk] in fp32 (fp64 for fp64 inputs), keys
    after the query's position at -inf when causal."""
    ct = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bqnh,bknh->bnqk", q.to(ct), k.to(ct)) * sm_scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, float("-inf"))
    return s


def _probs(q, k, lse, causal, sm_scale) -> torch.Tensor:
    return torch.exp(_scores(q, k, causal, sm_scale) - lse[..., None])


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, sm_scale: Optional[float] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o [b, t, n, hd] in q's type, lse [b, n, t] fp32)."""
    _check(q, k, v)
    s = _scores(q, k, causal, _scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bnqk,bknh->bqnh", p, v.to(p.dtype))
    return o.to(q.dtype), lse


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) [b, n, t] in fp32 (fp64 for fp64 inputs)."""
    ct = torch.promote_types(o.dtype, torch.float32)
    return (o.to(ct) * do.to(ct)).sum(-1).transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, do, lse, di, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = scale * ds^T q, dv = p^T dO, with p = exp(s - lse) and
    ds = p * (dO v^T - di); in k's and v's types."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    p = _probs(q, k, lse, causal, scale)
    do32 = do.to(p.dtype)
    dv = torch.einsum("bnqk,bqnh->bknh", p, do32)
    ds = p * (torch.einsum("bqnh,bknh->bnqk", do32, v.to(p.dtype))
              - di[..., None])
    dk = torch.einsum("bnqk,bqnh->bknh", ds, q.to(p.dtype)) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, di, causal: bool = True,
                       sm_scale: Optional[float] = None) -> torch.Tensor:
    """dq = scale * ds k, in q's type."""
    _check(q, k, v)
    scale = _scale(q, sm_scale)
    p = _probs(q, k, lse, causal, scale)
    ds = p * (torch.einsum("bqnh,bknh->bnqk", do.to(p.dtype),
                           v.to(p.dtype)) - di[..., None])
    return (torch.einsum("bnqk,bknh->bqnh", ds, k.to(p.dtype))
            * scale).to(q.dtype)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash attention takes q, k, v of one shape "
                         f"[b, t, n, hd], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


# ------------------------------------------------------------ CUDA wrappers

def _kernel_input(x: torch.Tensor, like: torch.Tensor,
                  name: str) -> torch.Tensor:
    """x as the kernels read it: a CUDA view with the head dim contiguous
    and rows at 16-byte boundaries. The c_attn slices on the path are such
    views and go as they are; any other layout is copied once."""
    if x.device != like.device or x.device.type != "cuda":
        raise ValueError(f"{name} on {x.device}, q on {like.device}")
    if x.dtype != like.dtype:
        raise TypeError(f"{name} is {x.dtype}, q is {like.dtype}")
    align = 16 // x.element_size()
    if (x.stride(-1) != 1 or x.data_ptr() % 16
            or any(s % align for s in x.stride()[:3])):
        x = x.clone(memory_format=torch.contiguous_format)
    return x


def _launch(entry: str, counter: str, q, k, v, do, ptrs, causal,
            sm_scale) -> None:
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash attention takes float32 or bfloat16, got "
                        f"{q.dtype}")
    b, t, n, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in {HEAD_DIMS}")
    if not 0 < b * n <= 65535 or t < 1:  # grid.y is batch x head
        raise ValueError(f"flash attention: b * n = {b * n} outside "
                         f"[1, 65535] or t = {t} < 1")
    views = [x for x in (q, k, v, do) if x is not None]
    strides = (ctypes.c_longlong * 12)(
        *[s for x in views for s in x.stride()[:3]])
    err = getattr(_build.library(), entry)(
        *[x.data_ptr() for x in views], *ptrs, ctypes.addressof(strides),
        DTYPE_CODES[q.dtype], b, t, n, hd, _scale(q, sm_scale), int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    LAUNCHES[counter] += 1


def _cuda_inputs(q, k, v, do=None):
    _check(q, k, v)
    refuse_grad(q, k, v, do)
    ins = [_kernel_input(x, q, nm) for x, nm in ((q, "q"), (k, "k"), (v, "v"),
                                                (do, "do")) if x is not None]
    return ins + [None] * (4 - len(ins))


def _stats(x: torch.Tensor, q: torch.Tensor, name: str) -> torch.Tensor:
    b, t, n, _ = q.shape
    if x.shape != (b, n, t) or x.device != q.device:
        raise ValueError(f"{name} must be [{b}, {n}, {t}] on {q.device}, got "
                         f"{tuple(x.shape)} on {x.device}")
    return x.float().contiguous()


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True, sm_scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5f: (o [b, t, n, hd] in q's type, lse [b, n, t] fp32)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, causal, sm_scale)
    q, k, v, _ = _cuda_inputs(q, k, v)
    b, t, n, _ = q.shape
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, n, t), dtype=torch.float32, device=q.device)
    _launch("tempo_flash_fwd", "flash_fwd", q, k, v, None,
            (o.data_ptr(), lse.data_ptr()), causal, sm_scale)
    return o, lse


def flash_bwd_dkv(q, k, v, do, lse, di, causal: bool = True,
                  sm_scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5dkv: (dk, dv) [b, t, n, hd] in the inputs' type."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, do, lse, di, causal, sm_scale)
    q, k, v, do = _cuda_inputs(q, k, v, do)
    lse, di = _stats(lse, q, "lse"), _stats(di, q, "di")
    dk = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    _launch("tempo_flash_bwd_dkv", "flash_bwd_dkv", q, k, v, do,
            (lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr()),
            causal, sm_scale)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, causal: bool = True,
                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """K5dq: dq [b, t, n, hd] in q's type."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, do, lse, di, causal, sm_scale)
    q, k, v, do = _cuda_inputs(q, k, v, do)
    lse, di = _stats(lse, q, "lse"), _stats(di, q, "di")
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch("tempo_flash_bwd_dq", "flash_bwd_dq", q, k, v, do,
            (lse.data_ptr(), di.data_ptr(), dq.data_ptr()), causal, sm_scale)
    return dq


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        di = attention_di(o, do)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, ctx.causal, ctx.sm_scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """softmax(sm_scale * q.k^T) v over [b, t, n, hd] (causal: keys up to
    the query's position), differentiable through K5dkv and K5dq. sm_scale
    defaults to 1/sqrt(hd)."""
    return _FlashAttention.apply(q, k, v, causal, _scale(q, sm_scale))
