"""The K3/K4 ``torch.library`` ops (tempo::decode_attention,
tempo::paged_decode_attention; tempo_tpu_torch/ops/cuda_decode.py) on the
CPU: their schemas, ``torch.library.opcheck`` (schema and fake tensor),
each CPU kernel bitwise its plain version, each fake's shape and type under
FakeTensorMode, the refusal of a graph, and a module that calls the
wrappers exporting with the ops in its graph in place of the plain
attention. The CUDA kernels run only on the card (chip_smoke.py phases 3a,
3b, 3d, 9 and 10 reach them through the ops)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from tempo_tpu_torch.ops import cuda_decode

torch.set_num_threads(1)

DTYPES = [torch.float32, torch.bfloat16]
SCHEMAS = {
    "decode_attention": "tempo::decode_attention(Tensor q, Tensor k, "
                        "Tensor v, Tensor pos) -> Tensor",
    "paged_decode_attention": "tempo::paged_decode_attention(Tensor q, "
                              "Tensor pk, Tensor pv, Tensor table, "
                              "Tensor pos) -> Tensor",
}


def _rand(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dtype)


def _dense(dtype, pos, b=3, s=16, n=4, kv=2, hd=16):
    """(q, k, v, pos) of a GQA dense case: pos a 0-dim or [b] int32."""
    return (_rand((b, 1, n, hd), 0, dtype), _rand((b, s, kv, hd), 1, dtype),
            _rand((b, s, kv, hd), 2, dtype),
            torch.tensor(pos, dtype=torch.int32))


def _paged(dtype, b=3, n=4, kv=2, hd=16, page=4, n_pages=13):
    """(q, pk, pv, table, pos) over a shuffled table of 4 pages a row."""
    table = torch.from_numpy(1 + np.random.default_rng(3).permutation(
        n_pages - 1)[:4 * b].reshape(b, 4)).to(torch.int32)
    return (_rand((b, 1, n, hd), 4, dtype),
            _rand((n_pages, page, kv, hd), 5, dtype),
            _rand((n_pages, page, kv, hd), 6, dtype), table,
            torch.tensor([0, 7, 15][:b], dtype=torch.int32))


@pytest.mark.parametrize("name", sorted(SCHEMAS))
def test_schemas(name):
    assert str(getattr(torch.ops.tempo, name).default._schema) == \
        SCHEMAS[name]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pos", [9, [0, 8, 15]], ids=["scalar", "rows"])
def test_decode_attention_op(dtype, pos):
    args = _dense(dtype, pos)
    torch.library.opcheck(torch.ops.tempo.decode_attention.default, args,
                          test_utils=("test_schema", "test_faketensor"))
    got = torch.ops.tempo.decode_attention(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.equal(got, cuda_decode.decode_attention_plain(*args))
    # the wrapper: a host int or list becomes the op's tensor
    host = pos if isinstance(pos, int) else torch.tensor(pos)
    assert torch.equal(cuda_decode.decode_attention(*args[:3], host), got)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_decode_attention_op(dtype):
    args = _paged(dtype)
    torch.library.opcheck(torch.ops.tempo.paged_decode_attention.default,
                          args, test_utils=("test_schema", "test_faketensor"))
    got = torch.ops.tempo.paged_decode_attention(*args)
    assert got.dtype == dtype and got.shape == args[0].shape
    assert torch.equal(got,
                       cuda_decode.paged_decode_attention_plain(*args))
    assert torch.equal(cuda_decode.paged_decode_attention(*args), got)


def test_fakes_give_the_shape_and_type():
    """Under FakeTensorMode each op gives q's shape and type, also at a
    batch and a pool size it was never called with."""
    with FakeTensorMode():
        q = torch.empty(5, 1, 8, 32, dtype=torch.bfloat16)
        k = torch.empty(5, 64, 2, 32, dtype=torch.bfloat16)
        pos = torch.empty(5, dtype=torch.int32)
        out = torch.ops.tempo.decode_attention(q, k, k, pos)
        assert out.shape == q.shape and out.dtype == torch.bfloat16
        pool = torch.empty(40, 16, 2, 32, dtype=torch.bfloat16)
        table = torch.empty(5, 4, dtype=torch.int32)
        out = torch.ops.tempo.paged_decode_attention(q, pool, pool, table,
                                                     pos)
        assert out.shape == q.shape and out.dtype == torch.bfloat16


def test_ops_refuse_a_graph():
    """With grad on and an input that requires grad, each op's CPU kernel
    raises as its CUDA kernel does; under no_grad it computes."""
    q, k, v, pos = _dense(torch.float32, 9)
    q.requires_grad_()
    with pytest.raises(NotImplementedError):
        cuda_decode.decode_attention(q, k, v, pos)
    pq, pk, pv, table, ppos = _paged(torch.float32)
    pk.requires_grad_()
    with pytest.raises(NotImplementedError):
        cuda_decode.paged_decode_attention(pq, pk, pv, table, ppos)
    with torch.no_grad():
        assert not cuda_decode.decode_attention(q, k, v, pos).requires_grad
        assert not cuda_decode.paged_decode_attention(
            pq, pk, pv, table, ppos).requires_grad


class _Step(torch.nn.Module):
    """Both wrappers over a symbolic batch: what a serving program calls."""

    def forward(self, q, k, v, pos, pool, table):
        dense = cuda_decode.decode_attention(q, k, v, pos)
        paged = cuda_decode.paged_decode_attention(q, pool, pool, table, pos)
        return dense + paged


def test_a_module_over_the_wrappers_exports_the_ops():
    """torch.export of a module calling the wrappers holds one node of
    each op and no plain-attention einsum; the exported program, called at
    another batch and pool size, equals the plain versions bitwise."""
    def inputs(b, n_pages):
        q, k, v, _ = _dense(torch.float32, 0, b=b)
        _, pool, _, _, _ = _paged(torch.float32, b=1, n_pages=n_pages)
        table = torch.from_numpy(np.random.default_rng(b).integers(
            0, n_pages, (b, 4))).to(torch.int32)
        pos = torch.from_numpy(np.random.default_rng(b).integers(
            0, 16, b)).to(torch.int32)
        return q, k, v, pos, pool, table

    b, p = torch.export.Dim("b", min=1), torch.export.Dim("p", min=1)
    program = torch.export.export(
        _Step(), inputs(2, 5), dynamic_shapes=(
            {0: b}, {0: b}, {0: b}, {0: b}, {0: p}, {0: b}), strict=False)
    targets = [str(n.target) for n in program.graph.nodes
               if n.op == "call_function"]
    assert targets.count("tempo.decode_attention.default") == 1
    assert targets.count("tempo.paged_decode_attention.default") == 1
    assert "aten.einsum.default" not in targets
    q, k, v, pos, pool, table = inputs(3, 9)
    want = (cuda_decode.decode_attention_plain(q, k, v, pos)
            + cuda_decode.paged_decode_attention_plain(q, pool, pool, table,
                                                       pos))
    assert torch.equal(program.module()(q, k, v, pos, pool, table), want)
