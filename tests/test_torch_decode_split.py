"""The split-and-merge walk of K3/K4 (tempo_tpu_torch/csrc/decode.cu:
``decode_split`` and the fold of its last live split, ``fold_splits``),
emulated in PyTorch on the CPU and held against ``decode_attention_plain``
and ``paged_decode_attention_plain``.

The CUDA kernels run only on the card; what can go wrong in them before any
instruction does is the index arithmetic, and that is plain integer code
this file repeats: the split length and the grid's split count, a split's
start, end and early exit, the keys a warp's lane groups load in each batch,
the page a position lives on, the offset of a split's partial state, the
short rows that split 0 walks whole and writes itself, the block the
arrival counter elects to fold and the splits the fold reads.
Those statements are read out of the ``.cu`` source as text and evaluated
here (``_find``, ``_c_eval``), so an edit to the kernel changes what this
file walks, and a pattern that no longer matches fails the import. What
runs between them (the dot products, the softmax of a split, the fold of
the splits) is this file's PyTorch: the kernels themselves are held against
their plain versions only on the card, by ``chip_smoke.py`` (phase 2').

The emulation asserts what the design relies on: the lane groups of a
split's block load every live position of the split once and nothing past
it; a block whose split holds no live position exits before it writes;
the counter elects exactly one block of a (row, kv head), the last live
split to arrive, in whatever order the splits finish, and leaves the
counter at zero; the fold reads only splits with a live position, each
after it was written (the partial state starts as NaN, so a read of an
unwritten split would show); and a row's output is bitwise the same alone
and inside a batch with other positions, another pool, another page order
and another order of arrival.

fp32 throughout: both sides differ in sum order only, atol 2e-5 on
unit-scale inputs.
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tempo_tpu_torch.ops import cuda_decode

torch.set_num_threads(1)

ATOL = 2e-5
LOG2E = 1.4426950408889634

SOURCE = (pathlib.Path(cuda_decode.__file__).resolve().parents[1] / "csrc"
          / "decode.cu").read_text()


def _find(pattern: str, text: str = SOURCE) -> str:
    """The one group of ``pattern`` in ``text``; the kernel's source must
    still hold the statement this file evaluates."""
    m = re.search(pattern, text, re.S)
    assert m, f"decode.cu no longer holds /{pattern}/"
    return " ".join(m.group(1).split())


def _ternaries(expr: str) -> str:
    """C conditionals as Python ones, innermost parenthesised first."""
    inner = re.compile(r"\(([^()?:]+)\?([^()?:]+):([^()?:]+)\)")
    while inner.search(expr):
        expr = inner.sub(r"((\2) if (\1) else (\3))", expr)
    m = re.fullmatch(r"([^?:]+)\?([^?:]+):(.+)", expr)
    return f"(({m[2]}) if ({m[1]}) else ({m[3]}))" if m else expr


def _c_eval(expr: str, **env):
    """An integer or boolean C expression of the kernel, evaluated with the
    names in ``env``: ``/`` is integer division."""
    for c, py in (("(size_t)", ""), ("tempo::", ""),
                  ("table != nullptr", "paged"),
                  ("table == nullptr", "not paged"), ("&&", " and "),
                  ("||", " or "), ("/", "//")):
        expr = expr.replace(c, py)
    return eval(_ternaries(expr), {"__builtins__": {}, "min": min,
                                   "max": max}, env)


def _body(name: str) -> str:
    return re.search(r"\b%s\((.*?)\n\}\n" % name, SOURCE, re.S).group(1)


SPLIT_LEN = int(_find(r"constexpr int kSplit = (\d+);"))
SPLIT_WARPS = _c_eval(_find(r"constexpr int kSplitWarps = ([^;]+);"))
SHORT_ROW = _c_eval(_find(r"constexpr int kShortRow = ([^;]+);"),
                    kSplit=SPLIT_LEN)
MERGE_CHUNK = _c_eval(_find(r"constexpr int kMergeChunk = ([^;]+);"))
SHAPE = dict(re.findall(r"static constexpr int (\w+) = ([^;]+);",
                        _find(r"struct SplitShape \{(.*?)\n\};")))
SPLIT = _body("decode_split")
MERGE = _body("fold_splits")
ENTRY = _body("tempo_decode_attention")

N_SPLIT = _find(r"const int n_split = ([^;]+);", ENTRY)
S0 = _find(r"const int s0 = ([^;]+);", SPLIT)
N_LIVE = _find(r"const int n_live = ([^;]+);", SPLIT)
SHORT = _find(r"const bool short_row = ([^;]+);", SPLIT)
DEAD = _find(r"exits\.\n\s*if \((.+?)\) return;", SPLIT)
S_PRE = _find(r"const int s_pre = ([^;]+);", SPLIT)
S_END = _find(r"const int s_end = ([^;]+);", SPLIT)
P0 = _find(r"const int p0 = ([^;]+);", SPLIT)
N_PAGES = _find(r"const int n_pages =\s*([^;]+);", SPLIT)
BASE = _find(r"for \(int base = ([^;]+);", SPLIT)
LOOP_END = _find(r"for \(int base = [^;]+; base < (\w+);", SPLIT)
STRIDE = _find(r"for \(int base = [^;]+;[^;]+;\s*base \+= ([^)]+)\)", SPLIT)
WARP_SPAN = _find(r"constexpr int kWarpSpan = ([^;]+);", SPLIT)
KEY = _find(r"const int j = ([^;]+);", SPLIT)
LOAD_IF = _find(r"if \((j < \w+)\) \{\s*const size_t row", SPLIT)
ROW = _find(r"const size_t row =\s*([^;]+);", SPLIT)
PART_AT = _find(r"part_at\(int r.*?return ([^;]+);")
LIVE_LEN = _find(r"live_len\(int row_pos, int cap\) \{\s*return ([^;]+);")
ROW_POS = _find(r"const int row_pos = ([^;]+);", SPLIT)
LIVE_SPLITS = _find(r"const int live_splits = ([^;]+);", SPLIT)
assert re.search(r"atom\.add\.acq_rel\.gpu\.s32 %0, \[%1\], 1;", SPLIT)
ELECT = _find(r"last = ticket (== [^;]+);", SPLIT)
CHUNK_LIVE = _find(r"const bool live = ([^;]+);", MERGE)
assert re.search(r"if \(short_row\) \{\s+store_out", SPLIT)
assert re.search(r"if \(short_row\) return;\s+// The last live split", SPLIT)
assert re.search(r"if \(last\) \*count = 0;", SPLIT)
assert re.search(r"if \(!last\) return;", SPLIT)
assert re.search(r"fold_splits<HD>\([^;]*part_at\(r, h, 0, kv, n_split, g\), "
                 r"live_splits\);", SPLIT)
assert re.search(r"for \(int c0 = 0; c0 < live_splits; c0 \+= kMergeChunk\)",
                 MERGE)
assert re.search(r"const dim3 grid\(a\.kv, a\.b, a\.n_split\);", SOURCE)


def shape(elem: int, hd: int, g: int) -> dict:
    """SplitShape's constants for a cache element of ``elem`` bytes."""
    group = 1 << max(0, math.ceil(math.log2(g)))   # G in {1, 2, 4, 8}
    env = dict(HD=hd, G=group, kSplit=SPLIT_LEN, kSplitWarps=SPLIT_WARPS)
    for name in ("VEC", "LPK", "KPW", "UMAX", "UFIT", "U"):
        env[name] = _c_eval(SHAPE[name].replace("sizeof(TC)", str(elem)),
                            **env)
    return env


def split_keys(sh: dict, s0: int, s_end: int) -> list:
    """The positions the block's lane groups load, in the kernel's loop:
    each warp from its base, a batch of U keys a lane group at a time."""
    span = _c_eval(WARP_SPAN, **sh)
    stride = _c_eval(STRIDE, kWarpSpan=span, **sh)
    assert LOOP_END == "s_end"
    used = []
    for warp in range(SPLIT_WARPS):
        base = _c_eval(BASE, s0=s0, warp=warp, kWarpSpan=span)
        while base < s_end:
            for sub in range(32 // sh["LPK"]):
                for u in range(sh["U"]):
                    j = _c_eval(KEY, base=base, u=u, sub=sub, **sh)
                    if _c_eval(LOAD_IF, j=j, s_end=s_end):
                        used.append(j)
            base += stride
    return used


def fold(acc_part, ml_part, at, g, hd, live_splits, read):
    """fold_splits: the live splits' states from ``at`` in split order;
    appends each split it reads to ``read``. Returns [g, hd]."""
    mx = torch.full((g, 1), -math.inf)
    den, num = torch.zeros((g, 1)), torch.zeros((g, hd))
    for c0 in range(0, live_splits, MERGE_CHUNK):
        for u in range(MERGE_CHUNK):
            if not _c_eval(CHUNK_LIVE, c0=c0, u=u, live_splits=live_splits):
                continue
            s = c0 + u
            read.append(s)
            a = [at + s * g + i for i in range(g)]
            ms = ml_part[[2 * x for x in a]][:, None]
            ls = ml_part[[2 * x + 1 for x in a]][:, None]
            acc = torch.stack([acc_part[x * hd:(x + 1) * hd] for x in a])
            mn = torch.maximum(mx, ms)
            fa, fb = torch.exp2(mx - mn), torch.exp2(ms - mn)
            den, num, mx = den * fa + ls * fb, num * fa + acc * fb, mn
    return num / den


def emulate(q, ck, cv, pos, table=None, arrival=None):
    """decode_split over q [b, 1, n, hd] and the dense cache [b, cap, kv,
    hd] (table None) or the pools [P, page, kv, hd] with table [b,
    max_pages], its blocks of a (row, kv head) finishing in split order, or
    shuffled by ``arrival`` (a numpy Generator); the block the counter
    elects folds the row. Returns (out, {row: splits the fold read, in
    order, for kv head 0})."""
    b, _, n, hd = q.shape
    kv = ck.shape[2]
    g = n // kv
    paged = table is not None
    page = ck.shape[1] if paged else 0
    cap = table.shape[1] * page if paged else ck.shape[1]
    max_pages = table.shape[1] if paged else 0
    n_split = _c_eval(N_SPLIT, cap=cap, kSplit=SPLIT_LEN)
    sh = shape(ck.element_size(), hd, g)
    scale = LOG2E / math.sqrt(hd)
    acc_part = torch.full((b * kv * n_split * g * hd,), math.nan)
    ml_part = torch.full((b * kv * n_split * g * 2,), math.nan)
    out = torch.full((b, 1, n, hd), math.nan)
    pos = pos.reshape(-1).tolist()
    stride = 0 if len(pos) == 1 else 1
    read = {}
    for r in range(b):
        row_pos = _c_eval(ROW_POS, pos=pos, r=r, pos_stride=stride)
        assert N_LIVE == "live_len(row_pos, cap)"
        n_live = _c_eval(LIVE_LEN, row_pos=row_pos, cap=cap)
        short_row = _c_eval(SHORT, n_live=n_live, kShortRow=SHORT_ROW)
        live_splits = _c_eval(LIVE_SPLITS, n_live=n_live, kSplit=SPLIT_LEN)
        read[r] = []
        for h in range(kv):
            qf = q[r, 0, h * g:(h + 1) * g].float() * scale     # [g, hd]
            order = list(range(n_split))
            if arrival is not None:
                arrival.shuffle(order)
            count, folds = 0, 0
            for split in order:
                env = dict(split=split, kSplit=SPLIT_LEN, cap=cap, page=page,
                           paged=paged, row_pos=row_pos, short_row=short_row,
                           n_live=n_live)
                s0 = _c_eval(S0, **env)
                s_pre = _c_eval(S_PRE, kShortRow=SHORT_ROW, **env)
                p0 = _c_eval(P0, s0=s0, **env)
                pages = [int(table[r, p0 + i]) for i in range(_c_eval(
                    N_PAGES, s0=s0, p0=p0, s_pre=s_pre, **env))] \
                    if paged else []
                if _c_eval(DEAD, s0=s0, **env):
                    assert s0 >= n_live or (short_row and split > 0)
                    continue
                s_end = _c_eval(S_END, s0=s0, **env)
                assert s0 < s_end <= n_live
                assert s_end - s0 <= (SHORT_ROW if short_row else SPLIT_LEN)
                used = split_keys(sh, s0, s_end)
                assert sorted(used) == list(range(s0, s_end))
                rows = [_c_eval(ROW, j=j, pages=pages, p0=p0, r=r, **env)
                        for j in used]
                src_k = ck.reshape(-1, kv, hd) if paged else ck[r]
                src_v = cv.reshape(-1, kv, hd) if paged else cv[r]
                if not paged:
                    rows = [j for j in used]
                kk = src_k[rows, h].float()
                vv = src_v[rows, h].float()
                s = qf @ kk.T                                   # [g, keys]
                mx = s.amax(-1)
                p = torch.exp2(s - mx[:, None])
                den, num = p.sum(-1), p @ vv
                if short_row:
                    assert split == 0 and s_end == n_live
                    out[r, 0, h * g:(h + 1) * g] = num / den[:, None]
                    continue
                at = _c_eval(PART_AT, r=r, h=h, s=split, kv=kv,
                             n_split=n_split, g=g)
                for i in range(g):
                    acc_part[(at + i) * hd:(at + i + 1) * hd] = num[i]
                    ml_part[2 * (at + i)] = mx[i]
                    ml_part[2 * (at + i) + 1] = den[i]
                last = _c_eval(f"count {ELECT}", count=count,
                               live_splits=live_splits)
                count += 1
                if last:
                    count, folds = 0, folds + 1
                    at0 = _c_eval(PART_AT, r=r, h=h, s=0, kv=kv,
                                  n_split=n_split, g=g)
                    out[r, 0, h * g:(h + 1) * g] = fold(
                        acc_part, ml_part, at0, g, hd, live_splits,
                        read[r] if h == 0 else [])
            assert count == 0 and folds == (not short_row)
    return out.to(q.dtype), read


# ------------------------------------------------------------------- cases

L = SPLIT_LEN
PAGE, MAX_PAGES = 32, 12                   # cap 384: three splits of 128
CAP = PAGE * MAX_PAGES
POSITIONS = [0, L - 1, L, L + 1, 2 * PAGE - 1, 2 * PAGE, SHORT_ROW - 1,
             SHORT_ROW, SHORT_ROW + 1, CAP - 1]


def _qkv(b, n, kv, hd, cap, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return f(b, 1, n, hd), f(b, cap, kv, hd), f(b, cap, kv, hd)


def _paged(ck, cv, seed, trash_dead=None):
    """The dense rows as pools of PAGE positions behind a shuffled table
    (pool page 0 is the trash page); with ``trash_dead`` ([b] positions)
    the pages past each row's position point at page 0, which holds
    garbage."""
    b, cap, kv, hd = ck.shape
    pages = cap // PAGE
    rng = np.random.default_rng(seed)
    where = 1 + rng.permutation(b * pages)
    pk = torch.full((1 + b * pages, PAGE, kv, hd), 1e3)
    pv = torch.full((1 + b * pages, PAGE, kv, hd), -1e3)
    pk[where] = ck.reshape(-1, PAGE, kv, hd)
    pv[where] = cv.reshape(-1, PAGE, kv, hd)
    table = torch.from_numpy(where.reshape(b, pages).astype(np.int32))
    if trash_dead is not None:
        for r, p in enumerate(trash_dead):
            table[r, p // PAGE + 1:] = 0
    return pk, pv, table


@pytest.mark.parametrize("n,kv,hd", [(4, 4, 16), (12, 4, 16), (12, 12, 64)],
                         ids=["mha_hd16", "gqa12_4_hd16", "mha_hd64"])
def test_dense_split_walk(n, kv, hd):
    q, ck, cv = _qkv(len(POSITIONS), n, kv, hd, CAP, seed=0)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    out, read = emulate(q, ck, cv, pos)
    want = cuda_decode.decode_attention_plain(q, ck, cv, pos, block_k=CAP)
    assert torch.allclose(out, want, atol=ATOL, rtol=0)
    for r, p in enumerate(POSITIONS):
        live = -(-(p + 1) // L)
        assert read[r] == ([] if p + 1 <= SHORT_ROW else list(range(live)))


@pytest.mark.parametrize("n,kv,hd", [(4, 4, 16), (12, 4, 16), (12, 12, 64)],
                         ids=["mha_hd16", "gqa12_4_hd16", "mha_hd64"])
def test_paged_split_walk_with_dead_pages_on_trash(n, kv, hd):
    q, ck, cv = _qkv(len(POSITIONS), n, kv, hd, CAP, seed=1)
    pk, pv, table = _paged(ck, cv, seed=2, trash_dead=POSITIONS)
    pos = torch.tensor(POSITIONS, dtype=torch.int32)
    out, read = emulate(q, pk, pv, pos, table,
                        arrival=np.random.default_rng(7))
    want = cuda_decode.paged_decode_attention_plain(q, pk, pv, table, pos)
    assert torch.allclose(out, want, atol=ATOL, rtol=0)
    assert all(s * L <= POSITIONS[r] for r, ss in read.items() for s in ss)


def test_scalar_position_broadcasts():
    q, ck, cv = _qkv(3, 4, 2, 16, CAP, seed=3)
    out, _ = emulate(q, ck, cv, torch.tensor(L + 5, dtype=torch.int32))
    want = cuda_decode.decode_attention_plain(q, ck, cv, L + 5, block_k=CAP)
    assert torch.allclose(out, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_row_alone_equals_row_in_a_batch(paged):
    """Row 0 (position kShortRow + 1: three splits and a fold) alone, its
    splits finishing in split order, then as row 2 of a batch of 4 with
    other positions (short rows among them), the
    splits finishing in a shuffled order; paged, the batch reads another,
    larger pool in which the row's pages lie elsewhere. Bitwise equal."""
    q, ck, cv = _qkv(4, 12, 4, 16, CAP, seed=4)
    pos = torch.tensor([5, CAP - 1, SHORT_ROW + 1, L], dtype=torch.int32)
    if paged:
        pk, pv, table = _paged(ck[2:3], cv[2:3], seed=5)
        alone, _ = emulate(q[2:3], pk, pv, pos[2:3], table)
        pk, pv, table = _paged(ck, cv, seed=6)
        batch, _ = emulate(q, pk, pv, pos, table,
                           arrival=np.random.default_rng(8))
    else:
        alone, _ = emulate(q[2:3], ck[2:3], cv[2:3], pos[2:3])
        batch, _ = emulate(q, ck, cv, pos, arrival=np.random.default_rng(8))
    assert torch.equal(alone[0], batch[2])


@pytest.mark.parametrize("elem", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("hd", cuda_decode.HEAD_DIMS)
@pytest.mark.parametrize("g", [1, 2, 3, 8])
def test_lane_groups_load_each_live_position_once(elem, hd, g):
    """At every cache type, head dim and group width the kernel is built
    for: the warps' lane groups cover [s0, s_end) once, for a full split and
    for ragged ends."""
    sh = shape(elem, hd, g)
    assert sh["LPK"] * sh["VEC"] == hd and 32 % sh["LPK"] == 0
    assert 1 <= sh["U"] <= sh["UMAX"]
    for s_end in (1, 7, L // 2 + 3, L - 1, L, L + 5, SHORT_ROW):
        used = split_keys(sh, 0, s_end)
        assert sorted(used) == list(range(s_end))
