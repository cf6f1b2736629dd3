"""The work split and fold of K1a and the (pack, row) mapping of K1b
(tempo_tpu_torch/csrc/gn.cu: ``gn_stats_kernel`` and ``gn_apply_kernel``),
emulated in PyTorch on the CPU and held against ``gn_stats_plain``,
``gn_apply_plain`` and the Pallas statistics kernel in interpret mode.

The CUDA kernels run only on the card; what can go wrong in them before any
instruction does is the index arithmetic and the order of the sums, and
that is plain code this file repeats: the wrapper's split of a sample into
blocks (``choose_stats_split``, which never sees B), the fixed 16-byte
channel pack of each of a block's ``kThreads`` threads and its ``kLoads``
loads in flight, the fold of a block's per-thread sums over row lanes and
then over a group's channels by one warp and a butterfly, the election of
the last block of a sample to arrive and its fold of the partials in block
order, and K1b's threads, each with one channel pack's constants for up to
``kApplyRows`` rows. The kernel's constants and the statements that size
its walk are read out of the ``.cu`` source as text, so an edit there
changes what this file walks, and a pattern that no longer matches fails
the import.

Tolerances: the emulation sums in fp32 in the kernel's order, the plain
version in torch's, and the Pallas kernel in XLA's: ``STATS_TOL`` (atol
1e-5, rtol 1e-4) on unit-scale inputs, as ``chip_smoke.py`` holds the
kernel to the plain version on the card. What depends on the order alone
(the arrival of blocks, a sample alone or in a batch) is held bitwise, as
is K1b's mapping, whose arithmetic is the plain version's element by
element.
"""

from __future__ import annotations

import functools
import inspect
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from tempo_tpu.ops import pallas_gn
from tempo_tpu_torch.ops import cuda_gn
from tempo_tpu_torch.ops.norms import ACTIVATIONS

torch.set_num_threads(1)

STATS_TOL = {"atol": 1e-5, "rtol": 1e-4}
SOURCE = (pathlib.Path(cuda_gn.__file__).resolve().parents[1] / "csrc"
          / "gn.cu").read_text()


def _find(pattern: str) -> str:
    m = re.search(pattern, SOURCE, re.S)
    assert m, f"gn.cu no longer holds /{pattern}/"
    return " ".join(m.group(1).split())


THREADS = int(_find(r"constexpr int kThreads = (\d+);"))
LOADS = int(_find(r"constexpr int kLoads = (\d+);"))
APPLY_ROWS = int(_find(r"constexpr int kApplyRows = (\d+);"))
APPLY_BLOCKS = int(_find(r"constexpr int kApplyBlocks = (\d+);"))
MAX_CHANNELS = int(_find(r"constexpr int kMaxChannels = (\d+);"))
WARP = 32
# The statements that size the walks, as the kernel writes them.
VEC_LANES = _find(r"lanes = (kThreads \* VEC / c);")
VEC_STEP = _find(r"v0 < n_vec; v0 \+= ([^)]+)\)")
APPLY_LANE_ROWS = _find(r"const long long lane_rows = ([^;]+);")
APPLY_THREAD_ROWS = _find(r"const int rows = (\(int\)std::min[^;]+);")
APPLY_RPB = _find(r"const int rows_per_block = ([^;]+);")

# Every K1a shape of the main path (the tile batch and the granule at each
# level's resolution, with every width of the model), and edge shapes.
PATH = [(b, h, w, c) for b, res in ((8, ((64, 64), (32, 32), (16, 16))),
                                    (1, ((128, 2048), (64, 1024),
                                         (32, 512))))
        for h, w in res for c in (128, 256, 512)]
EDGE = [(b, h, w, c) for b in (1, 8)
        for h, w, c in ((1, 1, 128), (7, 9, 128), (3, 1000, 128),
                        (1, 1, 40), (7, 9, 40), (3, 1000, 40))]
DTYPES = [torch.bfloat16, torch.float32]


def _elem(dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def _c_eval(expr: str, **env) -> int:
    """An integer C expression of the kernel: ``/`` is integer division,
    ``std::max`` and ``std::min`` are Python's."""
    for c, py in (("(long long)", ""), ("(int)", ""), ("std::max", "max"),
                  ("std::min<long long>", "min"), ("std::min", "min"),
                  ("/", "//")):
        expr = expr.replace(c, py)
    return eval(expr, {"__builtins__": {"max": max, "min": min}},
                dict(env, kThreads=THREADS, kLoads=LOADS,
                     kApplyRows=APPLY_ROWS, kApplyBlocks=APPLY_BLOCKS))


def _x(shape, dtype, seed=0, offset=0.5):
    """Unit-scale inputs with a mean away from 0, as the path's activations."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32) + offset
    return torch.from_numpy(x).to(dtype)


def _butterfly(v: torch.Tensor) -> torch.Tensor:
    """warp_sum: lane i adds lane i ^ o for o = 16, 8, 4, 2, 1 (every lane
    ends with the same value); v is [..., 32]."""
    lane = torch.arange(WARP)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., lane ^ o]
    return v[..., 0]


def _strided_sum(v: torch.Tensor) -> torch.Tensor:
    """Lane i of a warp sums v[i], v[i + 32], ... in order from 0; then the
    butterfly. v is [..., n] -> [...]."""
    n = v.shape[-1]
    pad = torch.zeros(v.shape[:-1] + (-(-n // WARP) * WARP,))
    pad[..., :n] = v
    lanes = torch.zeros(v.shape[:-1] + (WARP,))
    for m in range(pad.shape[-1] // WARP):
        lanes = lanes + pad[..., m * WARP:(m + 1) * WARP]
    return _butterfly(lanes)


# ------------------------------------------------------------ K1a emulated

def block_sums(xb: torch.Tensor, vectorized: bool, dtype) -> tuple:
    """One block's per-thread sums laid out as the kernel's ``red``:
    ([lanes, C] Σx, [lanes, C] Σx²) for the block's rows xb [rows, C] fp32.
    The vector path walks each thread's packs tid, tid + kThreads, ... in
    steps of kLoads packs; the plain path one channel at a time, its row
    lanes strided."""
    rows, c = xb.shape
    if vectorized:
        vec = 16 // _elem(dtype)
        lanes = _c_eval(VEC_LANES.replace("VEC", str(vec)), c=c)
        flat = xb.reshape(-1, vec)              # the block's 16-byte packs
        n_vec = flat.shape[0]
        s = torch.zeros(THREADS, vec)
        q = torch.zeros(THREADS, vec)
        tid = torch.arange(THREADS)
        for v0 in range(0, n_vec, _c_eval(VEC_STEP)):
            for u in range(LOADS):
                v = v0 + tid + u * THREADS
                live = v < n_vec
                assert torch.equal(v[live] * vec % c, tid[live] * vec % c), \
                    "a thread's pack moved to another channel"
                p = flat[v[live]]
                s[live] = s[live] + p
                q[live] = q[live] + p * p
        return s.reshape(lanes, c), q.reshape(lanes, c)
    tc = min(c, THREADS)
    lanes = THREADS // tc
    s = torch.zeros(lanes, c)
    q = torch.zeros(lanes, c)
    for lane in range(lanes):
        for r in range(lane, rows, lanes):
            s[lane] = s[lane] + xb[r]
            q[lane] = q[lane] + xb[r] * xb[r]
    return s, q


def block_partial(xb: torch.Tensor, groups: int, vectorized: bool, dtype
                  ) -> torch.Tensor:
    """A block's [2, G] partial: row lanes folded in order per channel, then
    one warp a group over its channels."""
    s, q = block_sums(xb, vectorized, dtype)
    chan_s, chan_q = s[0], q[0]
    for lane in range(1, s.shape[0]):
        chan_s = chan_s + s[lane]
        chan_q = chan_q + q[lane]
    cg = xb.shape[1] // groups
    return torch.stack([_strided_sum(chan_s.view(groups, cg)),
                        _strided_sum(chan_q.view(groups, cg))])


def emulate_stats(x: torch.Tensor, groups: int, eps: float = 1e-6,
                  arrival=None, vectorized=None) -> torch.Tensor:
    """K1a as its blocks run it, in fp32: the partial of every (sample,
    block), written when the block arrives in ``arrival`` order (a list of
    (sample, block); grid order by default); the sample's counter elects the
    last to arrive, which folds the partials in block order."""
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    blocks, rows = cuda_gn.choose_stats_split(hw, c, x.dtype)
    if vectorized is None:
        vectorized = cuda_gn.stats_vectorized(c, x.dtype, 0)
    x32 = x.float().reshape(b, hw, c)
    partial = torch.full((b, blocks, 2, groups), float("nan"))
    counters = [0] * b
    stats = torch.full((b, 2, c), float("nan"))
    folded = [0] * b
    cg = c // groups
    for s, j in arrival or [(s, j) for s in range(b) for j in range(blocks)]:
        partial[s, j] = block_partial(x32[s, j * rows:(j + 1) * rows], groups,
                                      vectorized, x.dtype)
        if blocks == 1:    # a sample of one block keeps its partial
            res = partial[s, 0].reshape(2 * groups)
        else:
            ticket = counters[s]
            counters[s] += 1
            if ticket != blocks - 1:
                continue
            counters[s] = 0
            assert not partial[s].isnan().any(), "folded before every partial"
            res = _strided_sum(partial[s].reshape(blocks, 2 * groups).T)
        folded[s] += 1
        denom = torch.tensor(float(hw * cg))
        mean = res[:groups] / denom
        var = torch.clamp(res[groups:] / denom - mean * mean, min=0.0)
        rstd = torch.rsqrt(var + eps)
        stats[s] = torch.stack([mean.repeat_interleave(cg),
                                rstd.repeat_interleave(cg)])
    assert counters == [0] * b and folded == [1] * b
    return stats


def _pallas_stats(x: np.ndarray, groups: int, eps: float) -> np.ndarray:
    """pallas_gn._stats_kernel in interpret mode, one sample a grid step."""
    b, hw, c = x.shape
    return np.asarray(pl.pallas_call(
        functools.partial(pallas_gn._stats_kernel, num_groups=groups,
                          eps=eps),
        grid=(b,),
        in_specs=[pl.BlockSpec((1, hw, c), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 2, c), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((b, 2, c), jnp.float32),
        interpret=True)(jnp.asarray(x)))


# ------------------------------------------------------------------ tests

def test_constants_match_source():
    """The wrapper's copies of the kernel's constants, and what the design
    relies on: a block's pass of kThreads 16-byte packs is a whole number of
    rows at every width the vector path takes (C dividing kThreads * VEC),
    and K1a's kLoads and K1b's kApplyRows keep 4-8 loads in flight."""
    assert (cuda_gn.THREADS, cuda_gn.MAX_CHANNELS) == (THREADS, MAX_CHANNELS)
    assert _c_eval(VEC_STEP) == THREADS * LOADS
    assert 4 <= LOADS <= 8 and 4 <= APPLY_ROWS <= 8
    for dtype in DTYPES:
        vec = 16 // _elem(dtype)
        for c in (vec, 128, 256, 512, THREADS * vec):
            assert cuda_gn.stats_vectorized(c, dtype, 0)
            assert (THREADS * vec) % c == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PATH + EDGE, ids=str)
def test_split_covers_each_row_once(shape, dtype):
    """Blocks cover a sample's rows once, none empty, within one wave and no
    more than BLOCK_BYTES shares of the sample (MIN_BLOCK_BYTES shares, up
    to MIN_BLOCKS, where the sample is larger than one block)."""
    b, h, w, c = shape
    hw = h * w
    sample_bytes = hw * c * _elem(dtype)
    blocks, rows = cuda_gn.choose_stats_split(hw, c, dtype)
    assert 1 <= blocks <= cuda_gn.MAX_BLOCKS
    assert blocks <= max(-(-sample_bytes // cuda_gn.BLOCK_BYTES), min(
        cuda_gn.MIN_BLOCKS, -(-sample_bytes // cuda_gn.MIN_BLOCK_BYTES)))
    seen = np.zeros(hw, np.int64)
    for j in range(blocks):
        lo, hi = j * rows, min(hw, (j + 1) * rows)
        assert hi > lo, "an empty block"
        seen[lo:hi] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PATH + EDGE, ids=str)
def test_block_walk_covers_each_element_once(shape, dtype):
    """Within a block, the threads' packs (vector path) or channels and row
    lanes (plain path) read each (row, channel) of the block's rows once:
    the first block and the last, which may be short."""
    b, h, w, c = shape
    hw = h * w
    blocks, rows = cuda_gn.choose_stats_split(hw, c, dtype)
    for j in {0, blocks - 1}:
        n = min(hw, (j + 1) * rows) - j * rows
        # Each element's flat index within the block as its value: the sums
        # of a walk that reads every element once are the column sums.
        xb = torch.arange(n * c, dtype=torch.float64).reshape(n, c) % 251
        s, _ = block_sums(xb.float(), cuda_gn.stats_vectorized(c, dtype, 0),
                          dtype)
        counts, _ = block_sums(torch.ones(n, c),
                               cuda_gn.stats_vectorized(c, dtype, 0), dtype)
        assert torch.equal(counts.sum(0), torch.full((c,), float(n)))
        assert torch.equal(s.sum(0).double(), xb.sum(0))


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", PATH, ids=str)
def test_path_shapes_load_packs_and_fill_the_card(shape, dtype):
    """Every path width takes the vector path from an aligned pointer; a
    granule's largest calls fill one wave of MAX_BLOCKS blocks (to the
    rounding of rows a block), and a [16,16,128] bf16 sample is one
    block."""
    b, h, w, c = shape
    assert cuda_gn.stats_vectorized(c, dtype, 0)
    assert not cuda_gn.stats_vectorized(c, dtype, 2)
    blocks, _ = cuda_gn.choose_stats_split(h * w, c, dtype)
    if h * w * c * _elem(dtype) >= cuda_gn.MAX_BLOCKS * cuda_gn.BLOCK_BYTES:
        assert 0.99 * cuda_gn.MAX_BLOCKS <= blocks <= cuda_gn.MAX_BLOCKS
    if (h, w, c, dtype) == (16, 16, 128, torch.bfloat16):
        assert blocks == 1


@pytest.mark.parametrize("hw,c,dtype", [
    (16 * 16, 256, torch.bfloat16), (32 * 32, 256, torch.bfloat16),
    (32 * 32, 512, torch.bfloat16), (16 * 16, 128, torch.float32),
    (7 * 9, 1024, torch.float32)], ids=str)
def test_small_samples_spread_over_min_blocks(hw, c, dtype):
    """A sample larger than one block (the tile batch's [16,16,256] and
    [32,32,256], 128 and 512 KB in bf16) takes MIN_BLOCKS blocks or as many
    of MIN_BLOCK_BYTES as it holds, not a few BLOCK_BYTES blocks."""
    sample_bytes = hw * c * _elem(dtype)
    assert sample_bytes > cuda_gn.BLOCK_BYTES
    blocks, rows = cuda_gn.choose_stats_split(hw, c, dtype)
    want = min(cuda_gn.MIN_BLOCKS, hw,
               -(-sample_bytes // cuda_gn.MIN_BLOCK_BYTES))
    assert blocks >= -(-hw // -(-hw // want))
    assert blocks >= -(-sample_bytes // cuda_gn.BLOCK_BYTES)


def test_vector_path_condition():
    """C not a whole number of packs (40 in bf16: 5 channels a group), a
    pass that is not a whole number of rows (C 4096 in bf16) and an
    unaligned pointer take the plain loads."""
    assert not cuda_gn.stats_vectorized(40, torch.bfloat16, 0)
    assert not cuda_gn.stats_vectorized(4096, torch.bfloat16, 0)
    assert cuda_gn.stats_vectorized(1024, torch.float32, 0)
    assert not cuda_gn.stats_vectorized(2048, torch.float32, 0)
    assert not cuda_gn.stats_vectorized(512, torch.bfloat16, 8)


def test_split_does_not_see_the_batch():
    """choose_stats_split takes (HW, C, dtype) only."""
    assert list(inspect.signature(cuda_gn.choose_stats_split).parameters) \
        == ["hw", "c", "dtype"]


FOLD_CASES = [
    ((2, 32, 32, 128), 8, torch.bfloat16),    # 16 blocks a sample
    ((1, 128, 128, 128), 8, torch.bfloat16),  # 64 blocks: lanes fold two
    ((2, 32, 32, 64), 8, torch.float32),      # fp32 packs, 16 blocks
    ((8, 7, 9, 128), 8, torch.bfloat16),      # one short block a sample
    ((8, 1, 1, 128), 8, torch.bfloat16),      # HW 1
    ((1, 3, 1000, 40), 8, torch.bfloat16),    # plain path, cg = 5
    ((8, 7, 9, 40), 8, torch.float32),        # plain path, fp32
    ((1, 2, 3, 4096), 16, torch.bfloat16),    # plain path, C > kThreads
]


@pytest.mark.parametrize("shape,groups,dtype", FOLD_CASES, ids=str)
def test_fold_matches_plain_and_pallas(shape, groups, dtype):
    """The kernel's order of sums (per-thread packs, row lanes, a warp a
    group, the last block's fold in block order) against gn_stats_plain and
    the Pallas kernel in interpret mode."""
    x = _x(shape, dtype, seed=sum(shape))
    got = emulate_stats(x, groups)
    want = cuda_gn.gn_stats_plain(x, groups)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **STATS_TOL)
    b, c = shape[0], shape[-1]
    pallas = _pallas_stats(x.float().reshape(b, -1, c).numpy(), groups, 1e-6)
    np.testing.assert_allclose(got.numpy(), pallas, **STATS_TOL)


@pytest.mark.parametrize("shape,groups,dtype", FOLD_CASES[:3] + FOLD_CASES[5:6],
                         ids=str)
def test_arrival_order_is_bitwise_irrelevant(shape, groups, dtype):
    """Blocks arriving in shuffled orders, samples interleaved: one block a
    sample folds, the counter ends at 0, and the statistics are bitwise
    the same."""
    x = _x(shape, dtype, seed=1)
    b, c = shape[0], shape[-1]
    blocks, _ = cuda_gn.choose_stats_split(x.numel() // (b * c), c, dtype)
    grid = [(s, j) for s in range(b) for j in range(blocks)]
    want = emulate_stats(x, groups, arrival=grid)
    rng = np.random.default_rng(7)
    for _ in range(3):
        order = [grid[i] for i in rng.permutation(len(grid))]
        assert torch.equal(emulate_stats(x, groups, arrival=order), want)
    assert torch.equal(emulate_stats(x, groups, arrival=grid[::-1]), want)


@pytest.mark.parametrize("shape,groups,dtype", [
    ((8, 32, 32, 128), 8, torch.bfloat16),
    ((8, 7, 9, 40), 8, torch.bfloat16),
    ((8, 16, 16, 64), 8, torch.float32)], ids=str)
def test_sample_alone_equals_sample_in_batch(shape, groups, dtype):
    """The split ignores B, so a sample's sums run in the same order alone
    and in a batch of 8: bitwise the same statistics."""
    x = _x(shape, dtype, seed=2)
    batch = emulate_stats(x, groups)
    for s in range(shape[0]):
        assert torch.equal(emulate_stats(x[s:s + 1], groups), batch[s:s + 1])


def test_vector_and_plain_paths_agree():
    """The same input through both paths of the kernel (an unaligned x
    takes the plain one): the same statistics to STATS_TOL."""
    x = _x((2, 32, 32, 128), torch.bfloat16, seed=3)
    np.testing.assert_allclose(emulate_stats(x, 8, vectorized=True).numpy(),
                               emulate_stats(x, 8, vectorized=False).numpy(),
                               **STATS_TOL)


# ------------------------------------------------------------ K1b emulated

def emulate_apply(x, stats, scale, bias, act, vectorized):
    """K1b over its (row block, sample) grid: thread (lane, pc) owns packs
    pc, pc + tc, ... and, for each, loads that pack's mean, rstd, scale and
    bias once, then rows lane, lane + lanes, ... of the block (at most
    kApplyRows). Returns the pre-activation output and how many times each
    element was written; the activation (elementwise) is applied by the
    caller, on the whole tensor as the plain version does, so that both
    take the same vectorised code for it."""
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    vec = 16 // _elem(x.dtype) if vectorized else 1
    packs = c // vec
    tc = min(packs, THREADS)
    lanes = THREADS // tc
    lane_rows = _c_eval(APPLY_LANE_ROWS, b=b, hw=hw, lanes=lanes)
    rows = _c_eval(APPLY_THREAD_ROWS, lane_rows=lane_rows)
    rpb = _c_eval(APPLY_RPB, lanes=lanes, rows=rows)
    assert lanes <= rpb <= lanes * APPLY_ROWS
    x32 = x.float().reshape(b, hw, c)
    pre = torch.full((b, hw, c), float("nan"))
    writes = torch.zeros((b, hw, c), dtype=torch.int64)
    lane, pc = np.divmod(np.arange(lanes * tc), tc)
    for s in range(b):
        mean, rstd = stats[s, 0], stats[s, 1]
        for bx in range(-(-hw // rpb)):
            r1 = min(hw, (bx + 1) * rpb)
            for p0 in range(0, packs, tc):
                p = p0 + pc
                own = p < packs
                ch = torch.from_numpy((p[own, None] * vec
                                       + np.arange(vec)).ravel())
                m, rs, sc, bi = mean[ch], rstd[ch], scale[ch], bias[ch]
                for u in range(APPLY_ROWS):
                    r = bx * rpb + lane[own] + u * lanes
                    live = torch.from_numpy(np.repeat(r < r1, vec))
                    rr = torch.from_numpy(np.repeat(r, vec))[live]
                    cc = ch[live]
                    y = (x32[s, rr, cc] - m[live]) * rs[live]
                    pre[s, rr, cc] = y * sc[live] + bi[live]
                    writes[s, rr, cc] += 1
    return pre, writes


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", None])
@pytest.mark.parametrize("shape,dtype,vectorized", [
    ((2, 16, 16, 128), torch.float32, True),
    ((1, 7, 9, 40), torch.float32, True),
    ((2, 3, 100, 40), torch.bfloat16, False),
    ((1, 2, 3, 2048), torch.float32, True),
    ((2, 8, 8, 64), torch.bfloat16, True)], ids=str)
def test_apply_mapping_is_the_plain_version(shape, dtype, vectorized, act):
    """Every element written once, with its own channel's hoisted
    constants: bitwise gn_apply_plain."""
    c = shape[-1]
    x = _x(shape, dtype, seed=4)
    rng = np.random.default_rng(5)
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(
        np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    stats = cuda_gn.gn_stats_plain(x, 8)
    pre, writes = emulate_apply(x, stats, scale, bias, act, vectorized)
    assert (writes == 1).all()
    got = (ACTIVATIONS[act](pre) if act else pre).reshape(shape).to(dtype)
    want = cuda_gn.gn_apply_plain(x, stats, scale, bias, act)
    assert torch.equal(got, want)
