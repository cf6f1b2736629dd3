"""K3/K4 of the port (tempo_tpu_torch/ops/cuda_decode.py) against the JAX
Pallas kernels (tempo_tpu/ops/pallas_decode.py) in interpret mode, on the
CPU: the wrappers take their plain versions for CPU tensors. The cases
mirror tests/test_pallas_decode.py and tests/test_paged.py; tolerances are
JAX's: 2e-5 in fp32 (fp32 reassociation of the online softmax), 2e-2 in
bf16 (both round the fp32 result to bf16 once)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops.pallas_decode import decode_attention as jax_decode
from tempo_tpu.ops.pallas_decode import paged_decode_attention as jax_paged
from tempo_tpu_torch.ops import cuda_decode

torch.set_num_threads(1)

F32_TOL = 2e-5
BF16_TOL = 2e-2
JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _pair(a: np.ndarray, dtype):
    """The same values as a torch and a jax array of ``dtype``."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(dtype)
    return t, jnp.asarray(t.float().numpy(), JNP[dtype])


def _close(got: torch.Tensor, want, dtype) -> None:
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    assert got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _dense_case(b, s, n, kv, hd, pos, block_k=8, seed=0,
                dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q, jq = _pair(rng.standard_normal((b, 1, n, hd)), dtype)
    ck, jck = _pair(rng.standard_normal((b, s, kv, hd)), dtype)
    cv, jcv = _pair(rng.standard_normal((b, s, kv, hd)), dtype)
    jpos = jnp.asarray(pos, jnp.int32) if not isinstance(pos, int) else pos
    tpos = torch.as_tensor(np.asarray(pos)) if not isinstance(pos, int) \
        else pos
    got = cuda_decode.decode_attention(q, ck, cv, tpos, block_k=block_k)
    want = jax_decode(jq, jck, jcv, jpos, block_k=block_k, interpret=True)
    _close(got, want, dtype)
    torch.testing.assert_close(
        got, cuda_decode.decode_attention_plain(q, ck, cv, tpos, block_k),
        rtol=0, atol=0)


@pytest.mark.parametrize("case", [
    # MHA, one scalar position
    dict(b=2, s=32, n=4, kv=4, hd=16, pos=11),
    # GQA with per-row positions at block_k=8 edges
    dict(b=4, s=32, n=8, kv=2, hd=16, pos=[0, 7, 8, 31]),
    # one block; a fully live cache
    dict(b=1, s=8, n=2, kv=2, hd=16, pos=3),
    dict(b=2, s=16, n=2, kv=1, hd=16, pos=15),
    # GPT-2 head dim, GQA n=12 kv=4, pos at a 256-block edge and S-1
    dict(b=3, s=512, n=12, kv=4, hd=64, pos=[255, 256, 511], block_k=256),
], ids=["mha_scalar", "gqa_rows_edges", "single_block", "full_cache",
        "gqa12_4_hd64"])
def test_dense_plain_matches_pallas(case):
    _dense_case(**case)


def test_dense_bf16_inputs_fp32_math():
    _dense_case(b=2, s=16, n=4, kv=4, hd=16, pos=9, dtype=torch.bfloat16)


def test_dense_bf16_q_with_f32_cache():
    """generate's default: a bf16 model over an fp32 cache."""
    rng = np.random.default_rng(3)
    q, jq = _pair(rng.standard_normal((2, 1, 4, 16)), torch.bfloat16)
    ck, jck = _pair(rng.standard_normal((2, 16, 2, 16)), torch.float32)
    cv, jcv = _pair(rng.standard_normal((2, 16, 2, 16)), torch.float32)
    got = cuda_decode.decode_attention(q, ck, cv, 5, block_k=8)
    _close(got, jax_decode(jq, jck, jcv, 5, block_k=8, interpret=True),
           torch.bfloat16)


@pytest.mark.parametrize("n,kv,dtype", [
    (4, 4, torch.float32), (8, 2, torch.float32), (12, 4, torch.float32),
    (8, 2, torch.bfloat16)])
def test_paged_plain_matches_pallas(n, kv, dtype):
    """Shuffled non-trash pages, positions at page edges (pg = 8)."""
    rng = np.random.default_rng(0)
    b, hd, pg, n_pages, mp = 4, 16, 8, 20, 4
    q, jq = _pair(rng.standard_normal((b, 1, n, hd)), dtype)
    pk, jpk = _pair(rng.standard_normal((n_pages, pg, kv, hd)), dtype)
    pv, jpv = _pair(rng.standard_normal((n_pages, pg, kv, hd)), dtype)
    table = (1 + rng.permutation(n_pages - 1)[:b * mp].reshape(b, mp)
             ).astype(np.int32)
    pos = np.asarray([0, 7, 8, 31], np.int32)
    got = cuda_decode.paged_decode_attention(
        q, pk, pv, torch.from_numpy(table), torch.from_numpy(pos))
    want = jax_paged(jq, jpk, jpv, jnp.asarray(table), jnp.asarray(pos),
                     interpret=True)
    _close(got, want, dtype)


def test_paged_dead_pages_on_trash():
    """Rows whose logical pages past pos sit on the trash page 0 (and a
    parked row entirely on trash): dead pages never change the result."""
    rng = np.random.default_rng(1)
    b, n, kv, hd, pg, n_pages = 3, 4, 2, 16, 8, 9
    q, jq = _pair(rng.standard_normal((b, 1, n, hd)), torch.float32)
    pk, jpk = _pair(rng.standard_normal((n_pages, pg, kv, hd)),
                    torch.float32)
    pv, jpv = _pair(rng.standard_normal((n_pages, pg, kv, hd)),
                    torch.float32)
    table = np.asarray([[5, 2, 0, 0], [7, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    pos = np.asarray([12, 3, 0], np.int32)
    got = cuda_decode.paged_decode_attention(
        q, pk, pv, torch.from_numpy(table), torch.from_numpy(pos))
    want = jax_paged(jq, jpk, jpv, jnp.asarray(table), jnp.asarray(pos),
                     interpret=True)
    _close(got, want, torch.float32)
    # the same rows with garbage on the trash page: unchanged
    pk2, pv2 = pk.clone(), pv.clone()
    pk2[0], pv2[0] = 1e3, -1e3
    again = cuda_decode.paged_decode_attention(
        q, pk2, pv2, torch.from_numpy(table), torch.from_numpy(pos))
    torch.testing.assert_close(again[:2], got[:2], rtol=0, atol=0)


def test_masked_attention_is_the_cache_branch_math():
    """masked_attention with q_idx = pos equals the plain decode version
    (the model's t > 1 cache calls and K3's plain version share it)."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((2, 1, 6, 16)).astype(np.float32))
    ck = torch.from_numpy(rng.standard_normal((2, 8, 3, 16)).astype(np.float32))
    cv = torch.from_numpy(rng.standard_normal((2, 8, 3, 16)).astype(np.float32))
    pos = torch.tensor([2, 7])
    torch.testing.assert_close(
        cuda_decode.masked_attention(q, ck, cv, pos[:, None]),
        cuda_decode.decode_attention_plain(q, ck, cv, pos, block_k=8),
        rtol=0, atol=0)


def test_shape_guards():
    q2 = torch.zeros(1, 2, 4, 16)
    c = torch.zeros(1, 8, 4, 16)
    with pytest.raises(ValueError, match="single-token"):
        cuda_decode.decode_attention(q2, c, c, 0)
    c12 = torch.zeros(1, 12, 4, 16)
    with pytest.raises(ValueError, match="divide"):
        cuda_decode.decode_attention(torch.zeros(1, 1, 4, 16), c12, c12, 0,
                                     block_k=8)
    c3 = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError, match="multiple"):
        cuda_decode.decode_attention(torch.zeros(1, 1, 4, 16), c3, c3, 0)
    pool = torch.zeros(4, 8, 4, 16)
    with pytest.raises(ValueError, match="single-token"):
        cuda_decode.paged_decode_attention(q2, pool, pool,
                                           torch.zeros(1, 2, dtype=torch.int32),
                                           torch.zeros(1))
    with pytest.raises(ValueError, match="table"):
        cuda_decode.paged_decode_attention(torch.zeros(2, 1, 4, 16), pool,
                                           pool,
                                           torch.zeros(1, 2, dtype=torch.int32),
                                           torch.zeros(2))


def test_cpu_path_launches_nothing_and_other_devices_raise():
    before = dict(cuda_decode.LAUNCHES)
    q = torch.zeros(1, 1, 2, 16)
    c = torch.zeros(1, 8, 2, 16)
    cuda_decode.decode_attention(q, c, c, 3, block_k=8)
    assert cuda_decode.LAUNCHES == before
    m = torch.zeros(1, 1, 2, 16, device="meta")
    cm = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_decode.decode_attention(m, cm, cm, 3, block_k=8)
