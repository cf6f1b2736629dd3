"""K3: dense active-length decode attention; K4: paged decode attention.

Counterpart of tempo_tpu/ops/pallas_decode.py (``decode_attention`` /
``_decode_kernel`` and ``paged_decode_attention`` / ``_paged_kernel``); the
CUDA source is csrc/decode.cu, whose header says what bounds the kernels
on the H100 and how they are laid out.

Both compute softmax(q.K^T / sqrt(hd)).V over the cache positions
kv_idx <= pos of each row, for one decode token: q [b, 1, n, hd], the
cache with kv <= n heads (q heads kv-major: q head h*g + i reads kv head
h), fp32 math, output in q's type. ``pos`` is an int or an int tensor,
one position or one per row.

On the card a call is one launch (csrc/decode.cu). A row of up to
2 * ``split_len()`` live positions is walked whole by one block per kv
head. A longer row is split: each block covers ``split_len()`` positions
of one (row, kv head) and writes its partial softmax state to a scratch
tensor this module allocates, and the last live split of a (row, kv head)
to finish folds the row's splits in split order, elected by a counter in
an int32 buffer this module keeps per device and stream (zero between
calls). A row's result depends on its own position, q and cache alone,
bit for bit.

K3 and K4 are the ``torch.library`` ops ``tempo::decode_attention`` and
``tempo::paged_decode_attention`` (registered as ops/cuda_gn.py registers
K1): their CPU kernel is the plain PyTorch version beside it, their CUDA
kernel launches the hand-written kernel or raises, and their fake gives
the output's shape and type, so ``torch.export`` carries them into the
serving programs of infer/export_lm.py and one program runs them on
whichever device it is loaded on. Everything that reads a concrete value
(pointers, the stream, the scratch, the counters, the capture rules)
stays inside the CUDA kernel. The wrappers ``decode_attention`` and
``paged_decode_attention`` keep the shape guards, turn a host ``pos``
into a tensor and call the ops. The CUDA kernels count their launches in
``LAUNCHES`` (ops/launches.py: a call recorded into a CUDA graph counts
at each replay of the graph). The ops have no backward: with grad on and
an input that requires grad they raise NotImplementedError.

Capture (infer/graphs.py). The kernel reads the positions and the table
from device memory, and its grid comes from the cache's capacity, so one
captured launch is valid at any position and table. While a graph is being
captured the wrapper takes only device tensors for ``pos`` (a host value
would be a copy from pageable memory, illegal there), and the counters of
the capture's stream must already exist: the warm-up call on that stream
makes them, and the library and ``split_len`` are loaded there too.
"""

from __future__ import annotations

import functools
import math
import sys
from typing import Optional, Union

import torch

from tempo_tpu_torch.ops import _build, launches
from tempo_tpu_torch.ops.cuda_gn import (DTYPE_CODES, check_cuda_input,
                                         refuse_grad, register)

HEAD_DIMS = (16, 32, 64, 128)  # head dims the kernels are built for
MAX_GROUP = 8                   # most q heads per kv head the kernels take
# Launches of each kernel, counted by its wrapper where it launches it.
LAUNCHES = {"decode_attention": 0, "paged_decode_attention": 0}

Pos = Union[int, torch.Tensor]


# ----------------------------------------------------------- plain versions

def pos_rows(pos: Pos, b: int, device: torch.device) -> torch.Tensor:
    """pos (int, scalar or [b] tensor) -> [b] int64 on ``device``."""
    p = torch.as_tensor(pos, device=device).to(torch.int64).reshape(-1)
    return p.expand(b)


def _f32(x: torch.Tensor) -> torch.Tensor:
    """x in fp32, itself where it is already (no node in a traced
    program)."""
    return x if x.dtype == torch.float32 else x.float()


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_idx: Optional[torch.Tensor]) -> torch.Tensor:
    """The cache-branch math of nn/transformer.py (transformer.py:424-453):
    GQA grouped einsum in fp32 over q [b, t, n, hd] and k/v [b, s, kv, hd],
    keys kv_idx <= q_idx [b|1, t] (no mask when None), softmax in fp32.
    Returns [b, t, n, hd] in fp32."""
    b, t, n, hd = q.shape
    kv = k.shape[2]
    g = n // kv
    qg = _f32(q.reshape(b, t, kv, g, hd))
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, _f32(k)) / math.sqrt(hd)
    if q_idx is not None:
        kv_idx = torch.arange(k.shape[1], device=q.device)
        mask = kv_idx[None, None, :] <= q_idx[:, :, None]       # [b|1, t, s]
        scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    y = torch.einsum("bkgqs,bskh->bqkgh", weights, _f32(v))
    return y.reshape(b, t, n, hd)


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  name: str) -> None:
    t, n, hd = q.shape[1], q.shape[2], q.shape[3]
    if t != 1:
        raise ValueError(f"{name} is the single-token path, got t={t}")
    if k.shape != v.shape or k.shape[3] != hd:
        raise ValueError(f"{name}: cache shapes {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if n % k.shape[2]:
        raise ValueError(f"{name}: {n} q heads not a multiple of "
                         f"{k.shape[2]} kv heads")


def decode_attention_plain(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, pos: Pos,
                           block_k: int = 256) -> torch.Tensor:
    """softmax(q.K^T/sqrt(hd)).V over kv_idx <= pos; q [b, 1, n, hd], ck/cv
    [b, S, kv, hd] -> [b, 1, n, hd] in q's type."""
    _check_dense(q, ck, cv, block_k)
    return _dense_plain(q, ck, cv, pos)


def _dense_plain(q, ck, cv, pos):
    q_idx = pos_rows(pos, q.shape[0], q.device)[:, None]
    return masked_attention(q, ck, cv, q_idx).to(q.dtype)


def paged_decode_attention_plain(q: torch.Tensor, pk: torch.Tensor,
                                 pv: torch.Tensor, table: torch.Tensor,
                                 pos: Pos) -> torch.Tensor:
    """The same over pools pk/pv [P, page, kv, hd]: logical position p of
    row r lives at pool slot (table[r, p // page], p % page). The plain
    version gathers each row's whole logical window."""
    _check_paged(q, pk, pv, table)
    b = q.shape[0]
    kv, hd = pk.shape[2], pk.shape[3]
    ck = pk[table.long()].reshape(b, -1, kv, hd)
    cv = pv[table.long()].reshape(b, -1, kv, hd)
    q_idx = pos_rows(pos, b, q.device)[:, None]
    return masked_attention(q, ck, cv, q_idx).to(q.dtype)


def _check_dense(q, ck, cv, block_k):
    _check_shapes(q, ck, cv, "decode_attention")
    if ck.shape[0] != q.shape[0]:
        raise ValueError(f"decode_attention: cache batch {ck.shape[0]} != "
                         f"q batch {q.shape[0]}")
    s_len = ck.shape[1]
    blk = min(block_k, s_len)
    if s_len % blk:
        raise ValueError(f"cache length {s_len} must divide by block_k {blk}")


def _check_paged(q, pk, pv, table):
    _check_shapes(q, pk, pv, "paged_decode_attention")
    if table.ndim != 2 or table.shape[0] != q.shape[0]:
        raise ValueError(f"table must be [b={q.shape[0]}, max_pages], got "
                         f"{tuple(table.shape)}")


# ------------------------------------------------------------ CUDA wrappers

@functools.cache
def split_len() -> int:
    """Positions one block of the kernel covers (csrc/decode.cu: kSplit)."""
    return int(_build.library().tempo_decode_split_len())


def scratch_numel(b: int, n: int, hd: int, cap: int) -> int:
    """fp32 values of the splits' partial state: for each (row, q head) and
    each of ceil(cap / split) splits, the [hd] numerator, max and sum."""
    return b * n * -(-cap // split_len()) * (hd + 2)


# (device, stream) -> the int32 arrival counters of the calls on that stream,
# zero between calls: each call leaves them zero, so a captured launch that
# holds them keeps the invariant across its replays. Calls that share
# counters must stay ordered on one stream: eager calls on the stream they
# were made for, and graphs captured on one stream, which hold that
# stream's counters, replayed one after another on the caller's stream.
# A grown buffer never frees the one it replaces: a captured graph may
# still hold it.
_COUNTERS: dict = {}
_RETIRED: list = []


def _counters(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """The kernel's per-(row, kv head) arrival counters for calls on
    ``stream``: zeroed once, left at zero by every call. Made by the first
    eager call on the stream, never inside a capture."""
    c = _COUNTERS.get((device, stream))
    if c is None or c.numel() < numel:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "decode attention: no counters for the capturing stream; "
                "make a warm-up call on that stream before the capture")
        if c is not None:
            _RETIRED.append(c)
        c = torch.zeros(numel, dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = c
    return c


def _launch(q, k, v, pos, table, cap, page, max_pages, name):
    for t, nm in ((q, "q"), (k, "k"), (v, "v")):
        check_cuda_input(t, nm)
        if t.device != q.device:
            raise ValueError(f"{name}: {nm} on {t.device}, q on {q.device}")
    refuse_grad(q, k, v)
    b, _, n, hd = q.shape
    kv = k.shape[2]
    if k.dtype != v.dtype:
        raise TypeError(f"{name}: k is {k.dtype}, v is {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {hd} not in {HEAD_DIMS}")
    if n // kv > MAX_GROUP:
        raise ValueError(f"{name}: {n // kv} q heads per kv head > "
                         f"{MAX_GROUP}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: k and v must be 16-byte aligned")
    if torch.cuda.is_current_stream_capturing() and pos.device != q.device:
        raise ValueError(f"{name}: while a CUDA graph is captured, pos must "
                         f"be a tensor on {q.device}")
    p = pos.to(device=q.device, dtype=torch.int32).reshape(-1)
    if p.numel() not in (1, b):
        raise ValueError(f"{name}: pos must be one position or [b={b}], got "
                         f"{p.numel()}")
    p = p.contiguous()
    table_ptr = None
    if table is not None:
        if table.device != q.device:
            raise ValueError(f"{name}: table on {table.device}")
        table = table.to(torch.int32).contiguous()
        table_ptr = table.data_ptr()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    out = torch.empty_like(q)
    scratch = torch.empty(scratch_numel(b, n, hd, cap), dtype=torch.float32,
                          device=q.device)
    counters = _counters(q.device, stream, b * kv)
    err = _build.library().tempo_decode_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        0 if p.numel() == 1 else 1, table_ptr, out.data_ptr(),
        scratch.data_ptr(), counters.data_ptr(), DTYPE_CODES[k.dtype],
        DTYPE_CODES[q.dtype], b, n, kv, hd, cap, page, max_pages, stream)
    _build.check(err, "tempo_decode_attention")
    launches.count(sys.modules[__name__].LAUNCHES, name)
    return out


def _decode_cuda(q, k, v, pos):
    """tempo::decode_attention's CUDA kernel: one launch of K3."""
    _check_shapes(q, k, v, "decode_attention")
    return _launch(q, k, v, pos, None, k.shape[1], 0, 0, "decode_attention")


def _decode_cpu(q, k, v, pos):
    """tempo::decode_attention's CPU kernel: the plain version, refusing a
    graph as the CUDA kernel does."""
    refuse_grad(q, k, v)
    _check_shapes(q, k, v, "decode_attention")
    return _dense_plain(q, k, v, pos)


def _paged_cuda(q, pk, pv, table, pos):
    """tempo::paged_decode_attention's CUDA kernel: one launch of K4."""
    _check_paged(q, pk, pv, table)
    mp, pg = table.shape[1], pk.shape[1]
    return _launch(q, pk, pv, pos, table, mp * pg, pg, mp,
                   "paged_decode_attention")


def _paged_cpu(q, pk, pv, table, pos):
    """tempo::paged_decode_attention's CPU kernel: the plain version,
    refusing a graph as the CUDA kernel does."""
    refuse_grad(q, pk, pv)
    return paged_decode_attention_plain(q, pk, pv, table, pos)


def _attention_fake(q, *_):
    return torch.empty_like(q)


register("decode_attention", "decode_attention(Tensor q, Tensor k, Tensor v, "
         "Tensor pos) -> Tensor", _decode_cpu, _decode_cuda, _attention_fake)
register("paged_decode_attention", "paged_decode_attention(Tensor q, "
         "Tensor pk, Tensor pv, Tensor table, Tensor pos) -> Tensor",
         _paged_cpu, _paged_cuda, _attention_fake)


def _device_pos(pos: Pos, q: torch.Tensor, name: str) -> torch.Tensor:
    """The op's pos: a tensor as given, a host int as an int32 tensor on
    q's device (made here, before the op: inside a capture that copy is
    illegal, and the CUDA kernel refuses it). Also the device check the
    kernels' dispatch would otherwise skip."""
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: q must be a CUDA or CPU tensor, got "
                         f"{q.device}")
    if isinstance(pos, torch.Tensor):
        return pos
    return torch.tensor(pos, dtype=torch.int32, device=q.device)


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: Pos, block_k: int = 256) -> torch.Tensor:
    """K3: softmax(q.K^T/sqrt(hd)).V over the dense cache prefix
    kv_idx <= pos. q [b, 1, n, hd]; ck/cv [b, S, kv, hd]; pos int or
    tensor, scalar or [b]. Returns [b, 1, n, hd] in q's type, through
    ``tempo::decode_attention``. ``block_k`` is the TPU kernel's tile; it
    only keeps the same shape guard here."""
    _check_dense(q, ck, cv, block_k)
    return torch.ops.tempo.decode_attention(
        q, ck, cv, _device_pos(pos, q, "decode_attention"))


def paged_decode_attention(q: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, table: torch.Tensor,
                           pos: Pos) -> torch.Tensor:
    """K4: the same over pools pk/pv [P, page, kv, hd] through the block
    table [b, max_pages] (int32), through ``tempo::paged_decode_attention``;
    only the row's live pages are read."""
    _check_paged(q, pk, pv, table)
    return torch.ops.tempo.paged_decode_attention(
        q, pk, pv, table, _device_pos(pos, q, "paged_decode_attention"))
