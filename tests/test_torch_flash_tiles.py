"""The tile walk of the redesigned K5f, K5dkv and K5dq (tempo_tpu_torch/
csrc/flash_attn.cu: ``fwd_bf16``, ``dkv_bf16`` / ``dkv_tile`` and
``dq_bf16``), emulated in PyTorch on the CPU and held against
``flash_fwd_plain``, ``flash_bwd_dkv_plain`` and ``flash_bwd_dq_plain``.

The CUDA kernels run only on the card; what can go wrong in them before
any instruction does is the index arithmetic, and that is plain integer
code this file repeats step by step: the rows a block and a warp own, the
causal loop bounds, the tiles a K5dkv warp skips, the split into unmasked
and masked tiles, the zero-filled rows past t, the online softmax in the log2
domain with the scale folded into the exponent (a negative scale moved
into q's sign), and K5dkv's order S^T -> P -> dV -> dP^T -> dS -> dK with
one score tile live. The emulation asserts what the kernel relies on: a
tile taken as unmasked holds no masked element, a skipped tile no visible
one, and every row of a visited tile sees a key (so the running maximum
is finite).

The index arithmetic is not copied by hand: the tile sizes, the loop bounds,
the skip and the mask conditions and the swizzle are read out of the ``.cu``
source as text and evaluated here (``_kernel_body``, ``_c_eval``), so an
edit to a bound in the kernel changes what this file walks, and a pattern
that no longer matches fails the import. What runs between those bounds
(the products, the softmax, the order of K5dkv's steps) is this file's
PyTorch, not the kernel's instructions: the kernels themselves are held
against their plain versions only on the card, by ``chip_smoke.py``
(phase 2''). In the forward the walk does not depend on the head dim; its
hd cases differ in the scale and the width of the products only.

fp32 throughout, so both sides differ in sum order only: atol 2e-5 on
unit-scale inputs.
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tempo_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

ATOL = 2e-5
LOG2E, LN2 = 1.4426950408889634, 0.6931471805599453
T_VALUES = (1, 63, 65, 129, 200, 640, 1000)
HEAD_DIMS = (32, 64, 128)
WARP_ROWS = 16                          # rows of one mma / wgmma A fragment

SOURCE = (pathlib.Path(fa.__file__).resolve().parents[1] / "csrc"
          / "flash_attn.cu").read_text()


def _find(pattern: str, text: str = SOURCE) -> str:
    """The one group of ``pattern`` in ``text``; the kernel's source must
    still hold the statement this file evaluates."""
    m = re.search(pattern, text, re.S)
    assert m, f"flash_attn.cu no longer holds /{pattern}/"
    return " ".join(m.group(1).split())


def _kernel_body(name: str) -> str:
    return re.search(r"__global__ void[^\n]*\b%s\(Params p\) \{\n(.*?)\n\}\n"
                     % name, SOURCE, re.S).group(1)


def _c_eval(expr: str, **env):
    """An integer or boolean C expression of the kernel, evaluated with the
    names in ``env``: ``/`` is integer division, one ``?:`` level."""
    for c, py in (("p.causal", "causal"), ("gridDim.y", "grid_y"),
                  ("blockIdx.y", "block_y"), ("kDkvTile<HD>", "kDkvTile"),
                  ("&&", " and "), ("||", " or "), ("/", "//")):
        expr = expr.replace(c, py)
    m = re.fullmatch(r"([^?]+)\?([^:]+):(.+)", expr)
    if m:
        expr = f"(({m[2]}) if ({m[1]}) else ({m[3]}))"
    return eval(expr, {"__builtins__": {}, "min": min}, env)


K_ROWS = _c_eval(_find(r"constexpr int kRows = ([^;]+);"))
KEY_TILE = _c_eval(_find(r"constexpr int kTile = ([^;]+);"))
DKV_WARPS = _c_eval(_find(r"constexpr int kDkvWarps = ([^;]+);"), kRows=K_ROWS)
DKV_TILE = _find(r"constexpr int kDkvTile = ([^;]+);")
SIZES = dict(kRows=K_ROWS, kTile=KEY_TILE)

FWD = _kernel_body("fwd_bf16")
FWD_Q0 = _find(r"const int q0 = ([^;]+);", FWD)
FWD_TILES = _find(r"\n  int n_tiles = ([^;]+);", FWD)
FWD_TILES_CAUSAL = _find(r"if \(p\.causal\) n_tiles = ([^;]+);", FWD)
FWD_MASKED = _find(r"if \((\(p\.causal && k0[^{]+)\) \{", FWD)
assert re.search(r"const int wr = warp \* %d;" % WARP_ROWS, FWD)
assert re.search(r"launch<fwd_bf16<HD>, fwd_smem<HD>\(\), %d, kRows,"
                 % (32 * K_ROWS // WARP_ROWS), SOURCE)

DQ = _kernel_body("dq_bf16")
DQ_TILE = _find(r"constexpr int kDqTile = ([^;]+);")
assert re.search(r"constexpr int BK = kDqTile<HD>;", DQ)
assert re.search(r"const int wr = warp \* %d;" % WARP_ROWS, DQ)
DQ_Q0 = _find(r"const int q0 = ([^;]+);", DQ)
DQ_TILES = _find(r"\n  int n_tiles = ([^;]+);", DQ)
DQ_TILES_CAUSAL = _find(r"if \(p\.causal\) n_tiles = ([^;]+);", DQ)
DQ_MASKED = _find(r"const bool masked = ([^;]+);", DQ)
DQ_MASK = _find(r"if \((col >= t[^)]+\))\) ds = 0\.f;", DQ)
# The element mask of a masked K5dq tile, held against its vectorised form
# (_killed below) over every case of its comparisons.
assert all(_c_eval(DQ_MASK, col=c, row=r, t=t, causal=cz)
           == (c >= t or (cz and c > r))
           for c in range(4) for r in range(4) for t in range(4)
           for cz in (False, True))
assert re.search(r"launch<dq_bf16<HD>, dq_smem<HD>\(\), %d, kRows, true>"
                 % (32 * K_ROWS // WARP_ROWS), SOURCE)

DKV = _kernel_body("dkv_bf16")
assert re.search(r"constexpr int BK = kRows, BI = kDkvTile<HD>,", DKV)
assert re.search(r"const int k0 = blockIdx\.y \* BK;", DKV)
assert re.search(r"wk = warp \* %d;" % WARP_ROWS, DKV)
DKV_TILES = _find(r"const int n_tiles = ([^;]+);", DKV)
DKV_FIRST = _find(r"const int it0 = ([^;]+);", DKV)
DKV_SKIP = _find(r"if \((p\.causal && wkey0[^;]+)\) continue;", DKV)
DKV_MASKED = _find(r"if \((\(p\.causal && wkey0[^;]+?)\)\s+dkv_tile<HD, RES, true>",
                   DKV)


def dkv_tile_rows(hd: int) -> int:
    """kDkvTile: queries per staged tile in K5dkv."""
    return _c_eval(DKV_TILE, HD=hd)


def dq_tile_rows(hd: int) -> int:
    """kDqTile: keys per staged tile in K5dq."""
    return _c_eval(DQ_TILE, HD=hd)


def _inputs(t: int, hd: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(
        rng.standard_normal((1, t, 2, hd)).astype(np.float32))
        for _ in range(4))


def _staged(x: torch.Tensor, r0: int, rows: int) -> torch.Tensor:
    """Rows [r0, r0 + rows) of x [b, t, n, ...] as the asynchronous copies
    stage them: rows at or past t are zeros. Returns [b, n, rows, ...]."""
    t = x.shape[1]
    tile = torch.zeros((x.shape[0], rows) + tuple(x.shape[2:]), dtype=x.dtype)
    live = max(0, min(rows, t - r0))
    tile[:, :live] = x[:, r0:r0 + live]
    return tile.transpose(1, 2)


def _killed(rows: torch.Tensor, cols: torch.Tensor, t: int,
            causal: bool) -> torch.Tensor:
    """[len(rows), len(cols)]: K5dq's mask zeroes the pair (DQ_MASK)."""
    kill = (cols[None, :] >= t).expand(len(rows), len(cols))
    if causal:
        kill = kill | (cols[None, :] > rows[:, None])
    return kill


def _visible(rows: torch.Tensor, cols: torch.Tensor, t: int,
             causal: bool) -> torch.Tensor:
    """[len(rows), len(cols)]: query ``row`` may read key ``col``."""
    ok = (rows[:, None] < t) & (cols[None, :] < t)
    if causal:
        ok &= cols[None, :] <= rows[:, None]
    return ok


def emulate_fwd(q, k, v, causal: bool, sm_scale: float):
    """fwd_bf16's walk, one warp at a time; (o, lse, tiles visited). The
    four warps of the block's warpgroup run every tile of the block (the
    products are the warpgroup's); only the masking is a warp's own."""
    b, t, n, hd = q.shape
    o = torch.zeros_like(q)
    lse = torch.zeros((b, n, t))
    sl2 = max(abs(sm_scale) * LOG2E, 1e-30)
    visited = 0
    grid_y = (t + K_ROWS - 1) // K_ROWS
    starts = []
    for block_y in range(grid_y):
        q0 = _c_eval(FWD_Q0, grid_y=grid_y, block_y=block_y, **SIZES)
        starts.append(q0)
        env = dict(SIZES, t=t, q0=q0, causal=causal)
        n_tiles = _c_eval(FWD_TILES, **env)
        if causal:
            n_tiles = _c_eval(FWD_TILES_CAUSAL, n_tiles=n_tiles, **env)
        assert n_tiles >= 1
        for warp in range(K_ROWS // WARP_ROWS):
            wrow0 = q0 + warp * WARP_ROWS
            rows = torch.arange(wrow0, wrow0 + WARP_ROWS)
            qw = _staged(q, wrow0, WARP_ROWS)           # resident A frags
            if sm_scale < 0:
                qw = -qw
            acc = torch.zeros((b, n, WARP_ROWS, hd))
            m = torch.full((b, n, WARP_ROWS), -math.inf)
            l = torch.zeros((b, n, WARP_ROWS))
            for j in range(n_tiles):
                k0 = j * KEY_TILE
                cols = torch.arange(k0, k0 + KEY_TILE)
                # rows past t see keys as any causal row does (the kernel
                # masks by col >= t and col > row only)
                vis = cols[None, :] < t
                if causal:
                    vis = vis & (cols[None, :] <= rows[:, None])
                else:
                    vis = vis.expand(WARP_ROWS, KEY_TILE)
                masked = _c_eval(FWD_MASKED, k0=k0, wrow0=wrow0, **env)
                s = qw @ _staged(k, k0, KEY_TILE).transpose(-1, -2)
                if masked:
                    s = s.masked_fill(~vis, -math.inf)
                else:
                    assert vis.all()
                visited += 1
                mn = torch.maximum(m, s.amax(-1))
                assert torch.isfinite(mn).all()
                alpha = torch.exp2((m - mn) * sl2)
                p = torch.exp2(s * sl2 - (mn * sl2)[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + p @ _staged(v, k0, KEY_TILE)
                m = mn
            live = max(0, min(WARP_ROWS, t - wrow0))
            out = (acc / l[..., None]).transpose(1, 2)
            o[:, wrow0:wrow0 + live] = out[:, :live]
            lse[:, :, wrow0:wrow0 + live] = (
                (m * sl2 + torch.log2(l)) * LN2)[..., :live]
    # every block of rows once, the heaviest (last rows) first
    assert starts == sorted(range(0, t, K_ROWS), reverse=True)
    return o, lse, visited


def emulate_dkv(q, k, v, do, lse, di, causal: bool, sm_scale: float):
    """dkv_bf16's walk, one warp (16 keys) at a time; (dk, dv)."""
    b, t, n, hd = q.shape
    bk, bi = K_ROWS, dkv_tile_rows(hd)
    assert bk == DKV_WARPS * WARP_ROWS
    dk_out, dv_out = torch.zeros_like(k), torch.zeros_like(v)
    sl2 = sm_scale * LOG2E
    stats = lambda x, i0: _staged(x.transpose(1, 2), i0, bi)
    for bx in range((t + bk - 1) // bk):
        k0 = bx * bk
        env = dict(t=t, k0=k0, BI=bi, causal=causal)
        n_tiles = _c_eval(DKV_TILES, **env)
        it0 = _c_eval(DKV_FIRST, **env)
        assert 0 <= it0 < n_tiles
        for warp in range(DKV_WARPS):
            wkey0 = k0 + warp * WARP_ROWS
            keys = torch.arange(wkey0, wkey0 + WARP_ROWS)
            kw, vw = _staged(k, wkey0, WARP_ROWS), _staged(v, wkey0, WARP_ROWS)
            dk = torch.zeros((b, n, WARP_ROWS, hd))
            dv = torch.zeros((b, n, WARP_ROWS, hd))
            for it in range(it0, n_tiles):
                i0 = it * bi
                qs_rows = torch.arange(i0, i0 + bi)
                vis = _visible(qs_rows, keys, t, causal).T      # [16, bi]
                if _c_eval(DKV_SKIP, wkey0=wkey0, i0=i0, **env):
                    assert not vis.any()
                    continue
                masked = _c_eval(DKV_MASKED, wkey0=wkey0, i0=i0, **env)
                qt, dot = _staged(q, i0, bi), _staged(do, i0, bi)
                lse_s, di_s = stats(lse, i0), stats(di, i0)     # [b, n, bi]
                s = kw @ qt.transpose(-1, -2)                   # S^T
                p = torch.exp2(s * sl2 - (lse_s * LOG2E)[..., None, :])
                if masked:
                    p = torch.where(vis, p, torch.zeros(()))
                else:
                    # keys past t are not masked there: their rows of dk and
                    # dv are never stored and feed no other row
                    assert vis[keys < t].all()
                dv = dv + p @ dot                               # P^T.dO
                dp = vw @ dot.transpose(-1, -2)                 # dP^T
                ds = p * (dp - di_s[..., None, :])
                dk = dk + ds @ qt                               # dS^T.Q
            live = max(0, min(WARP_ROWS, t - wkey0))
            dk_out[:, wkey0:wkey0 + live] = (
                dk * sm_scale).transpose(1, 2)[:, :live]
            dv_out[:, wkey0:wkey0 + live] = dv.transpose(1, 2)[:, :live]
    return dk_out, dv_out


def emulate_dq(q, k, v, do, lse, di, causal: bool, sm_scale: float):
    """dq_bf16's walk, one warp (16 query rows) at a time; (dq, tiles
    visited). The block's warpgroup runs every key tile of the block (the
    products are the warpgroup's); only the masking is a warp's own."""
    b, t, n, hd = q.shape
    bk = dq_tile_rows(hd)
    dq = torch.zeros_like(q)
    sl2 = sm_scale * LOG2E
    visited = 0
    grid_y = (t + K_ROWS - 1) // K_ROWS
    starts = []
    for block_y in range(grid_y):
        q0 = _c_eval(DQ_Q0, grid_y=grid_y, block_y=block_y, **SIZES)
        starts.append(q0)
        env = dict(SIZES, t=t, q0=q0, causal=causal, BK=bk)
        n_tiles = _c_eval(DQ_TILES, **env)
        if causal:
            n_tiles = _c_eval(DQ_TILES_CAUSAL, n_tiles=n_tiles, **env)
        assert n_tiles >= 1
        block_rows = torch.arange(q0, q0 + K_ROWS)
        for j in range(n_tiles):
            k0 = j * bk
            cols = torch.arange(k0, k0 + bk)
            # no visited tile lies wholly outside the triangle: the block's
            # rows see at least one of its keys
            assert _visible(block_rows, cols, t, causal).any()
            visited += 1
        for warp in range(K_ROWS // WARP_ROWS):
            wrow0 = q0 + warp * WARP_ROWS
            rows = torch.arange(wrow0, wrow0 + WARP_ROWS)
            qw, dow = _staged(q, wrow0, WARP_ROWS), _staged(do, wrow0,
                                                            WARP_ROWS)
            live = max(0, min(WARP_ROWS, t - wrow0))
            lse2 = torch.zeros((b, n, WARP_ROWS))
            di_w = torch.zeros((b, n, WARP_ROWS))
            lse2[..., :live] = lse[..., wrow0:wrow0 + live] * LOG2E
            di_w[..., :live] = di[..., wrow0:wrow0 + live]
            acc = torch.zeros((b, n, WARP_ROWS, hd))
            for j in range(n_tiles):
                k0 = j * bk
                cols = torch.arange(k0, k0 + bk)
                kill = _killed(rows, cols, t, causal)
                masked = _c_eval(DQ_MASKED, k0=k0, wrow0=wrow0, **env)
                kt = _staged(k, k0, bk)
                s = qw @ kt.transpose(-1, -2)
                dp = dow @ _staged(v, k0, bk).transpose(-1, -2)
                pe = torch.exp2(s * sl2 - lse2[..., None])
                ds = pe * (dp - di_w[..., None])
                if masked:
                    ds = torch.where(kill, torch.zeros(()), ds)
                else:
                    assert not kill.any()   # an unmasked tile: no masked pair
                acc = acc + ds @ kt                             # dS.K
            dq[:, wrow0:wrow0 + live] = (acc * sm_scale).transpose(
                1, 2)[:, :live]
    assert starts == sorted(range(0, t, K_ROWS), reverse=True)
    return dq, visited


def _scale(hd: int) -> float:
    return 1.0 / math.sqrt(hd)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("t", T_VALUES)
def test_fwd_tile_walk(t, hd, causal):
    q, k, v, _ = _inputs(t, hd)
    o, lse, visited = emulate_fwd(q, k, v, causal, _scale(hd))
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    assert visited >= 1
    assert torch.allclose(o, o_p, atol=ATOL, rtol=0)
    assert torch.allclose(lse, lse_p, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("t", T_VALUES)
def test_dkv_tile_walk(t, hd, causal):
    q, k, v, do = _inputs(t, hd, seed=1)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    di = fa.attention_di(o_p, do)
    dk, dv = emulate_dkv(q, k, v, do, lse_p, di, causal, _scale(hd))
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, di, causal)
    assert torch.allclose(dk, dk_p, atol=ATOL, rtol=0)
    assert torch.allclose(dv, dv_p, atol=ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("t", T_VALUES)
def test_dq_tile_walk(t, hd, causal):
    q, k, v, do = _inputs(t, hd, seed=3)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, causal)
    di = fa.attention_di(o_p, do)
    dq, visited = emulate_dq(q, k, v, do, lse_p, di, causal, _scale(hd))
    dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, di, causal)
    assert visited >= 1
    assert torch.allclose(dq, dq_p, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_causal_dq_visits_only_tiles_with_a_visible_pair(hd):
    """At t = 1024: the block of rows q0 .. q0 + 63 walks the key tiles up
    to its last row's, (q0 + 64) / BK of them; counted against the closed
    form."""
    t, bk = 1024, dq_tile_rows(hd)
    q, k, v, do = _inputs(t, hd, seed=4)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True)
    _, visited = emulate_dq(q, k, v, do, lse_p, fa.attention_di(o_p, do),
                            True, _scale(hd))
    assert visited == sum((q0 + K_ROWS) // bk for q0 in range(0, t, K_ROWS))


@pytest.mark.parametrize("sm_scale", [-0.2, 0.0, 0.37])
def test_fwd_scale_sign_and_zero(sm_scale):
    """The scale folded into the exponent: a negative one moves into q's
    sign (the row maximum is taken before scaling), a zero one is floored."""
    q, k, v, _ = _inputs(200, 64, seed=2)
    o, lse, _ = emulate_fwd(q, k, v, True, sm_scale)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, True, sm_scale)
    assert torch.allclose(o, o_p, atol=ATOL, rtol=0)
    assert torch.allclose(lse, lse_p, atol=ATOL, rtol=0)


def test_causal_fwd_visits_only_tiles_with_a_visible_pair():
    """At t = 1024: block i of 16 walks i + 1 key tiles, each of its 4 warps
    all of them; counted against the closed form, so a loop bound that
    visits a tile too many (or stops one short) shows even where the masks
    hide it."""
    t = 1024
    q, k, v, _ = _inputs(t, 64)
    _, _, visited = emulate_fwd(q, k, v, True, _scale(64))
    blocks = t // K_ROWS
    assert visited == 4 * blocks * (blocks + 1) // 2


def test_wgmma_tile_swizzle_is_a_permutation_within_128_byte_lines():
    """WgTile::offset, the byte offset the copies write a 16-byte chunk to:
    panels of min(hd, 64) columns, each dense, the chunk index XORed with
    bits 7.. of the linear offset. It must be a bijection onto the tile that
    keeps every chunk inside its own 128-byte line (so a row's chunks stay in
    the 8-row group the descriptor's stride names) and leaves the first row
    of every 8-row group (1024 bytes at 128-byte rows) in place."""
    tile = _find(r"struct WgTile \{(.*?)\n\};")
    consts = dict(re.findall(r"(\w+) = ([^,;]+)[,;]", tile))
    off_src = _find(r"const int off = ([^;]+);", tile)
    ret_src = _find(r"return ([^;]+);", tile)
    cases = {(hd, rows) for hd in HEAD_DIMS
             for rows in (KEY_TILE, dq_tile_rows(hd))}
    for hd, rows in sorted(cases):
        pw = _c_eval(consts["PW"], HD=hd)
        env = dict(PW=pw, kTile=KEY_TILE, ROWS=rows)
        for name in ("kRowBytes", "kBits", "kPanelBytes"):
            env[name] = _c_eval(consts[name], **env)
        row_bytes, bits = env["kRowBytes"], env["kBits"]
        assert (row_bytes, bits) == (pw * 2, 3 if pw == 64 else 2)
        assert env["kPanelBytes"] % 1024 == 0  # panels keep the alignment
        seen = set()
        for r in range(rows):
            for col in range(0, hd, 8):
                off = _c_eval(off_src, r=r, col=col, **env)
                at = _c_eval(ret_src, off=off, col=col, **env)
                swz = at - (col // pw) * env["kPanelBytes"]
                assert swz // 128 == off // 128
                if off % 1024 < row_bytes and bits == 3:
                    assert swz == off
                seen.add(at)
        assert seen == set(range(0, rows * hd * 2, 16))
