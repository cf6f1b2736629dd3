"""The tile walk of K2's bf16 kernel (tempo_tpu_torch/csrc/gn_conv.cu:
``conv_bf16`` and ``reduce_splits``), emulated in PyTorch on the CPU and held
against ``conv3x3_from_stats_plain``.

The CUDA kernel runs only on the card; what can go wrong in it before any
instruction does is the index arithmetic, and that is plain integer code
this file repeats step by step: blocks over (pixel tile, 64- or 128-channel
tile, split), the halo slab of a 64-channel chunk normalised, activated and
zeroed outside the image and past C after the activation, the k iterations
as (chunk, tap) pairs with each tap a shifted view of the slab, the weight
tiles of the packed [9, Cp, Fp] layout with the columns past Fp zero-filled,
the split of the k iterations over blockIdx.z into an fp32 workspace and its
reduction in a fixed order with the conv bias. The emulation also replays
which slices of the next chunk's slab the kernel writes at each tap, into
which of its two buffers, and asserts that every vector of a chunk's slab
was written for that chunk before the chunk is read.

The configuration table, the chunk width and the slab schedule are read out
of the ``.cu`` source as text, so an edit there changes what this file
walks, and a pattern that no longer matches fails the import. What runs
between those bounds (the products) is this file's PyTorch, in fp32: both
sides differ in sum order only, atol and rtol 1e-4.
"""

from __future__ import annotations

import math
import pathlib
import re

import numpy as np
import pytest
import torch

from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv as K

torch.set_num_threads(1)

TOL = {"atol": 1e-4, "rtol": 1e-4}
SOURCE = (pathlib.Path(K.__file__).resolve().parents[1] / "csrc"
          / "gn_conv.cu").read_text()


def _find(pattern: str) -> str:
    m = re.search(pattern, SOURCE, re.S)
    assert m, f"gn_conv.cu no longer holds /{pattern}/"
    return " ".join(m.group(1).split())


CU_CONFIGS = [tuple(int(v) for v in m) for m in re.findall(
    r"X\((\d+), (\d+), (\d+), (\d+), (\d+)\)",
    _find(r"#define TEMPO_GN_CONV_CONFIGS\(X\)(.*?)\n\n"))]
CHUNK = int(_find(r"constexpr int kChunk = (\d+);"))
TAPS = int(_find(r"constexpr int kTaps = (\d+);"))
# The slices [lo, hi) of the next chunk's slab written at a tap.
FILL_LO, FILL_HI = (
    _find(r"fill\(q \+ 1, (j == 0 \? [^:]+ : [^,]+),"),
    _find(r"fill\(q \+ 1, j == 0 \? [^:]+ : [^,]+,\s*([^;]+)\);"))


def _c_eval(expr: str, **env) -> int:
    """An integer C expression of the kernel with the names in ``env``:
    ``/`` is integer division, one ``?:`` level."""
    for c, py in (("C::kSlices", "kSlices"), ("==", " == "), ("/", "//")):
        expr = expr.replace(c, py)
    m = re.fullmatch(r"([^?]+)\?([^:]+):(.+)", expr)
    if m:
        expr = f"(({m[2]}) if ({m[1]}) else ({m[3]}))"
    return eval(expr, {"__builtins__": {}}, dict(env, kTaps=TAPS))


def _inputs(b, h, w, c, f, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    scale = torch.from_numpy((1 + 0.1 * rng.standard_normal(c)).astype(
        np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(c)).astype(np.float32))
    weight = torch.from_numpy((rng.standard_normal((f, c, 3, 3))
                               / math.sqrt(9 * c)).astype(np.float32))
    cbias = torch.from_numpy((0.01 * rng.standard_normal(f)).astype(
        np.float32))
    groups = math.gcd(c, 8)
    return x, cuda_gn.gn_stats(x, groups, 1e-6), scale, bias, weight, cbias


def emulate(x, stats, scale, bias, weight, cbias, act, config, split):
    """K2's bf16 kernel as its blocks walk the problem, in fp32."""
    _, wg, th, tw, bn = K.CONFIGS[config]
    b, h, w, c = x.shape
    f = weight.shape[0]
    packed = K.pack_conv3x3_weight(weight, torch.float32)
    cp, fp = packed.shape[1], packed.shape[2]
    nt = 128 * wg
    sw, sp = tw + 2, (th + 2) * (tw + 2)
    n_vecs = sp * 8
    n_slices = -(-n_vecs // nt)
    nk = TAPS * (cp // CHUNK)
    kper = -(-nk // split)
    tiles_w, tiles_h = -(-w // tw), -(-h // th)
    m = b * h * w
    ws = torch.full((split, m, f), float("nan"))
    # The activated input with a zero border and zero channels up to Cp:
    # what slab_vector returns, pixel by pixel.
    act_x = cuda_gn.gn_apply_plain(x, stats, scale, bias, act)
    padded = torch.zeros((b, h + 2 * th + 2, w + 2 * tw + 2, cp))
    padded[:, 1:h + 1, 1:w + 1, :c] = act_x

    def slab_vectors(bi, y0, x0, q):
        """The chunk's slab as [sp * 8, 8]: vector v = pixel v // 8,
        channels 8 (v % 8) .. + 7 of the chunk."""
        win = padded[bi, y0:y0 + th + 2, x0:x0 + tw + 2,
                     q * CHUNK:(q + 1) * CHUNK]
        return win.reshape(sp * 8, 8)

    for z in range(split):
        k0 = z * kper
        n_iter = min(nk - k0, kper)
        assert n_iter > 0, "an empty split"
        q_last = (k0 + n_iter - 1) // TAPS
        for bi in range(b):
            for ty in range(tiles_h):
                for tx in range(tiles_w):
                    y0, x0 = ty * th, tx * tw
                    for n0 in range(0, f, bn):  # one block each
                        # The two slab buffers, each vector tagged with the
                        # chunk it was written for.
                        buf = torch.zeros((2, n_vecs, 8))
                        tag = -np.ones((2, n_vecs), dtype=np.int64)

                        def fill(q, lo, hi):
                            vecs = slab_vectors(bi, y0, x0, q)
                            for s in range(lo, hi):
                                v = np.arange(s * nt, min((s + 1) * nt,
                                                          n_vecs))
                                buf[q & 1, v] = vecs[v]
                                tag[q & 1, v] = q

                        fill(k0 // TAPS, 0, n_slices)
                        acc = torch.zeros((th * tw, bn))
                        for j in range(n_iter):
                            q, t = divmod(k0 + j, TAPS)
                            assert (tag[q & 1] == q).all(), \
                                "a slab read before it was written"
                            slab = buf[q & 1].reshape(th + 2, sw, CHUNK)
                            di, dj = divmod(t, 3)
                            a = slab[di:di + th, dj:dj + tw].reshape(
                                th * tw, CHUNK)
                            wt = torch.zeros((CHUNK, bn))
                            cols = min(bn, fp - n0)
                            wt[:, :cols] = packed[t, q * CHUNK:(q + 1) * CHUNK,
                                                  n0:n0 + cols]
                            acc += a @ wt
                            if q < q_last:
                                env = {"j": j, "t": t, "kSlices": n_slices}
                                fill(q + 1, _c_eval(FILL_LO, **env),
                                     _c_eval(FILL_HI, **env))
                        # Epilogue: pixels and channels inside the output.
                        hi = min(f, n0 + bn)
                        for mm in range(th * tw):
                            gy, gx = y0 + mm // tw, x0 + mm % tw
                            if gy < h and gx < w:
                                ws[z, (bi * h + gy) * w + gx, n0:hi] = \
                                    acc[mm, :hi - n0]
    assert not torch.isnan(ws).any(), "an output element no block wrote"
    out = ws[0].clone()
    for z in range(1, split):
        out += ws[z]
    return (out + cbias).reshape(b, h, w, f)


def _check(b, h, w, c, f, config, split, act="gelu", seed=0):
    x, st, sc, bi, wt, cb = _inputs(b, h, w, c, f, seed)
    got = emulate(x, st, sc, bi, wt, cb, act, config, split)
    want = K.conv3x3_from_stats_plain(x, st, sc, bi, wt, cb, act)
    torch.testing.assert_close(got, want, **TOL)


def test_config_table_matches_the_source():
    assert sorted(K.CONFIGS.values()) == sorted(CU_CONFIGS)
    assert K.CHUNK == CHUNK and K.TAPS == TAPS
    for _, wg, th, tw, bn in CU_CONFIGS:
        assert th * tw == 64 * wg and tw % 8 == 0 and bn % 64 == 0


@pytest.mark.parametrize("f", [20, 64, 1028])
@pytest.mark.parametrize("config", sorted(K.CONFIGS))
def test_tile_walk(config, f):
    """Ragged H and W, C not a multiple of the chunk (nor of 8 at C = 40),
    B = 2, every F kind: below one N tile, one, and 1028 = ragged."""
    c = 72 if f == 1028 else 40
    _check(2, 7, 21, c, f, config, 1, seed=f)


@pytest.mark.parametrize("split", [2, 3, 5])
@pytest.mark.parametrize("config", sorted(K.CONFIGS))
def test_split_walk(config, split):
    """The k iterations split over blockIdx.z, splits starting mid-chunk
    (k per split not a multiple of 9), reduced in order with the bias."""
    _check(2, 5, 18, 130, 64, config, split, seed=split)


@pytest.mark.parametrize("act", [None, "silu"])
def test_tile_walk_other_activations(act):
    _check(1, 9, 16, 64, 128, "m128n128", 2, act=act)


def test_split_of_the_launchers_choice_at_a_16x16_shape():
    """The launcher's own choice at a 16x16 tile-batch shape (cut to B = 2
    and C = 128 so the emulation stays small)."""
    config, split = K.choose_config(2, 16, 16, 128, 64)
    assert split > 1
    _check(2, 16, 16, 128, 64, config, split)


# The K2 calls of one main-path run (PERF.md): the tile batch's shapes and
# the granule's.
PATH_SHAPES = [((8, 64, 64, 512), 512), ((8, 64, 64, 512), 1028),
               ((8, 32, 32, 512), 256), ((8, 32, 32, 256), 256),
               ((8, 16, 16, 256), 128), ((8, 16, 16, 128), 128),
               ((8, 16, 16, 128), 64), ((1, 128, 2048, 512), 512),
               ((1, 128, 2048, 512), 1028), ((1, 64, 1024, 512), 256),
               ((1, 64, 1024, 256), 256), ((1, 32, 512, 256), 128),
               ((1, 32, 512, 128), 128), ((1, 32, 512, 128), 64)]


@pytest.mark.parametrize("shape,f", PATH_SHAPES,
                         ids=[f"{'x'.join(map(str, s))}-{f}"
                              for s, f in PATH_SHAPES])
def test_launcher_fills_a_wave(shape, f):
    """At every path shape the chosen configuration launches at least one
    wave of blocks (132 SMs), and no split is empty."""
    b, h, w, c = shape
    config, split = K.choose_config(b, h, w, c, f)
    assert K.config_blocks(config, b, h, w, f) * split >= K.SMS
    nk = TAPS * -(-c // CHUNK)
    kper = -(-nk // split)
    assert (split - 1) * kper < nk


def _swizzle128(off: int) -> int:
    return off ^ (((off >> 7) & 7) << 4)


def test_swizzle_is_a_bijection_within_128_byte_lines():
    """The weight tiles' and the slab's 128-byte swizzle permutes the 16-byte
    chunks of each line, and an ldmatrix phase (8 consecutive slab pixels,
    one chunk each) touches 8 distinct 16-byte bank groups."""
    assert "return off ^ (((off >> 7) & 7) << 4);" in (
        pathlib.Path(K.__file__).resolve().parents[1] / "csrc"
        / "hopper.cuh").read_text()
    assert "swizzle128(px * 128 + j * 16)" in SOURCE  # slab stores
    assert "((2 * kk + khalf) ^ (sp & 7)) << 4" in SOURCE  # ldmatrix rows
    assert "swizzle128(r * 128 + (col % 64) * 2)" in SOURCE  # weight tiles
    for line in range(16):
        offs = [_swizzle128(line * 128 + 16 * k) for k in range(8)]
        assert sorted(o - line * 128 for o in offs) == list(range(0, 128, 16))
    for p0 in range(8):
        for chunk in range(8):
            groups = {(_swizzle128((p0 + p) * 128 + 16 * chunk) // 16) % 8
                      for p in range(8)}
            assert len(groups) == 8
