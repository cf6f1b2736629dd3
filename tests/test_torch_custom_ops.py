"""The K1a/K1b/K2 ``torch.library`` ops (tempo::gn_stats, tempo::gn_apply,
tempo::gn_conv3x3; tempo_tpu_torch/ops/cuda_gn.py, cuda_gn_conv.py) on the
CPU: ``torch.library.opcheck`` (schema, fake tensor, autograd
registration, AOT dispatch with dynamic shapes), each CPU kernel bitwise
its plain version, each fake's shape under a symbolic batch, and a module
executed again registering nothing twice. The CUDA kernels run only on the
card (chip_smoke.py phase 2 reaches them through the ops)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
# (shape, groups): an odd HW (5x7) and a square one
SHAPES = [((2, 5, 7, 16), 4), ((3, 4, 4, 8), 2)]


def _rand(shape, seed, dtype=torch.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        (scale * rng.standard_normal(shape)).astype(np.float32)).to(dtype)


def _affine(c, seed, with_affine):
    if not with_affine:
        return None, None
    return 1 + _rand((c,), seed, scale=0.1), _rand((c,), seed + 1, scale=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_gn_stats_op(dtype, shape, groups):
    x = _rand(shape, 0, dtype)
    torch.library.opcheck(torch.ops.tempo.gn_stats.default, (x, groups, 1e-6))
    got = cuda_gn.gn_stats(x, groups, 1e-6)
    want = cuda_gn.gn_stats_plain(x, groups, 1e-6)
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_affine", [True, False])
@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_gn_apply_op(dtype, with_affine, act, shape, groups):
    x = _rand(shape, 1, dtype)
    stats = cuda_gn.gn_stats_plain(x, groups, 1e-6)
    scale, bias = _affine(shape[-1], 2, with_affine)
    args = (x, stats, scale, bias, act)
    torch.library.opcheck(torch.ops.tempo.gn_apply.default, args)
    got = cuda_gn.gn_apply(*args)
    assert got.dtype == dtype
    assert torch.equal(got, cuda_gn.gn_apply_plain(*args))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_affine", [True, False])
@pytest.mark.parametrize("act", [None, "gelu", "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_gn_conv3x3_op(dtype, with_affine, act, shape, groups):
    x = _rand(shape, 3, dtype)
    c, f = shape[-1], 12
    stats = cuda_gn.gn_stats_plain(x, groups, 1e-6)
    scale, bias = _affine(c, 4, with_affine)
    weight = _rand((f, c, 3, 3), 6, scale=0.1)
    conv_bias = _rand((f,), 7, scale=0.01) if with_affine else None
    packed = cuda_gn_conv.pack_conv3x3_weight(weight, dtype)
    for pk in (None, packed):
        args = (x, stats, scale, bias, weight, conv_bias, act, pk)
        torch.library.opcheck(torch.ops.tempo.gn_conv3x3.default, args)
        got = cuda_gn_conv.conv3x3_from_stats(*args)
        assert got.shape == (*shape[:-1], f) and got.dtype == dtype
        assert torch.equal(got, cuda_gn_conv.conv3x3_from_stats_plain(
            *args[:-1]))


class _Ops(torch.nn.Module):
    def forward(self, x, weight):
        stats = torch.ops.tempo.gn_stats(x, 4, 1e-6)
        return (stats,
                torch.ops.tempo.gn_apply(x, stats, None, None, "gelu"),
                torch.ops.tempo.gn_conv3x3(x, stats, None, None, weight,
                                           None, "gelu", None))


def test_fakes_follow_a_symbolic_batch():
    """Traced by torch.export with a symbolic batch, each op's fake keeps
    the batch symbol: [B, 2, C] fp32, x's shape and type, [B, H, W, F] in
    x's type; the program then runs at other batches."""
    x = _rand((3, 5, 7, 16), 11, torch.bfloat16)
    weight = _rand((12, 16, 3, 3), 12, scale=0.1)
    program = torch.export.export(
        _Ops(), (x, weight),
        dynamic_shapes=({0: torch.export.Dim("b", min=1)}, None),
        strict=False)
    x_val = next(n for n in program.graph.nodes if n.name == "x").meta["val"]
    output = next(n for n in program.graph.nodes if n.op == "output")
    stats, applied, conv = (n.meta["val"] for n in output.args[0])
    assert isinstance(x_val.shape[0], torch.SymInt)
    for out in (stats, applied, conv):
        assert isinstance(out.shape[0], torch.SymInt)
        assert out.shape[0].node.expr == x_val.shape[0].node.expr
    assert stats.dtype == torch.float32 and stats.shape[1:] == (2, 16)
    assert applied.dtype == torch.bfloat16 and applied.shape[1:] == (5, 7, 16)
    assert conv.dtype == torch.bfloat16 and conv.shape[1:] == (5, 7, 12)
    for b in (1, 6):
        xb = _rand((b, 5, 7, 16), b, torch.bfloat16)
        got = program.module()(xb, weight)
        want = _Ops()(xb, weight)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_cpu_ops_launch_nothing():
    for table in (cuda_gn.LAUNCHES, cuda_gn_conv.LAUNCHES):
        for k in table:
            table[k] = 0
    x = _rand((1, 4, 4, 8), 9)
    cuda_gn_conv.conv3x3_from_stats(
        x, cuda_gn.gn_stats(x, 2), None, None, _rand((4, 8, 3, 3), 10), None)
    cuda_gn.gn_apply(x, cuda_gn.gn_stats(x, 2), None, None, "gelu")
    assert not any(cuda_gn.LAUNCHES.values())
    assert not any(cuda_gn_conv.LAUNCHES.values())


def test_modules_executed_again_register_nothing_twice():
    """importlib.reload of both modules (a second import of their code)
    neither raises nor adds a kernel: each op keeps one CPU and one CUDA
    kernel, and still computes the plain version."""
    code = (
        "import importlib, torch\n"
        "from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv\n"
        "lib = cuda_gn.LIBRARY\n"
        "importlib.reload(cuda_gn); importlib.reload(cuda_gn_conv)\n"
        "assert cuda_gn.LIBRARY is lib\n"
        "for name in ('gn_stats', 'gn_apply', 'gn_conv3x3'):\n"
        "    dump = torch._C._dispatch_dump(f'tempo::{name}')\n"
        "    for key in ('CPU', 'CUDA'):\n"
        "        n = sum(line.startswith(key + ':') for line in"
        " dump.splitlines())\n"
        "        assert n == 1, (name, key, dump)\n"
        "x = torch.randn(2, 3, 3, 8)\n"
        "assert torch.equal(cuda_gn.gn_stats(x, 2),"
        " cuda_gn.gn_stats_plain(x, 2))\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr


def _grad_calls():
    """Each wrapper called on a CPU input that requires grad."""
    x = _rand((2, 4, 4, 8), 11).requires_grad_()
    stats = cuda_gn.gn_stats_plain(x.detach(), 2)
    w = _rand((4, 8, 3, 3), 12)
    return {
        "gn_stats": lambda: cuda_gn.gn_stats(x, 2),
        "gn_apply": lambda: cuda_gn.gn_apply(x, stats, None, None, "gelu"),
        "gn_conv3x3": lambda: cuda_gn_conv.conv3x3_from_stats(
            x, stats, None, None, w, None)}


@pytest.mark.parametrize("op", ["gn_stats", "gn_apply", "gn_conv3x3"])
def test_cpu_ops_refuse_a_graph(op):
    """With grad on and an input that requires grad, each op's CPU kernel
    raises as its CUDA kernel does; under no_grad it computes."""
    call = _grad_calls()[op]
    with pytest.raises(NotImplementedError):
        call()
    with torch.no_grad():
        assert not call().requires_grad


def test_kernels_count_in_the_module_callers_read():
    """A kernel registered by a module's first import counts its launches
    in the LAUNCHES of the module as sys.modules holds it after a fresh
    import (the dispatcher keeps the first import's kernels)."""
    code = (
        "import importlib, sys\n"
        "from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv\n"
        "first, first_conv = cuda_gn, cuda_gn_conv\n"
        "for name in ('tempo_tpu_torch.ops.cuda_gn_conv',"
        " 'tempo_tpu_torch.ops.cuda_gn'):\n"
        "    del sys.modules[name]\n"
        "again = importlib.import_module('tempo_tpu_torch.ops.cuda_gn')\n"
        "again_conv = importlib.import_module("
        "'tempo_tpu_torch.ops.cuda_gn_conv')\n"
        "assert again is not first\n"
        "first.count_launch(first.__name__, 'gn_stats')\n"
        "first.count_launch(first_conv.__name__, 'gn_act_conv3x3')\n"
        "assert again.LAUNCHES['gn_stats'] == 1, again.LAUNCHES\n"
        "assert again_conv.LAUNCHES['gn_act_conv3x3'] == 1\n"
        "assert first.LAUNCHES['gn_stats'] == 0\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0 and "ok" in res.stdout, res.stdout + res.stderr
