"""K5's plain versions (tempo_tpu_torch/ops/flash_attention.py) against the
library Pallas flash attention's own reference (``mha_reference`` and its
custom VJP ``mha_reference_bwd``, whose formulas the TPU kernels follow)
and against ``jax.nn.dot_product_attention(is_causal=True)`` with
``jax.vjp``, on the CPU in fp32, including GQA through the model's
kv-major repeat. Both sides compute in fp32 and differ in sum order only:
1e-5 relative L2. The denominator is floored at an RMS of 1, the inputs'
scale: at t = 1 the exact dq and dk are 0 (one key, ds = dO.v - dO.o = 0),
and both sides hold only the fp32 rounding noise of that difference of two
sums of hd unit-scale products (~1e-6)."""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from tempo_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

REL = 1e-5
SHAPES = [(2, t, 4, hd) for t in (1, 37, 128) for hd in (16, 64)]


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    floor = math.sqrt(want.size)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  floor))


def _inputs(b, t, n, hd, kv=None, seed=0):
    rng = np.random.default_rng(seed)
    kv = kv or n
    q = rng.standard_normal((b, t, n, hd)).astype(np.float32)
    k = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    do = rng.standard_normal((b, t, n, hd)).astype(np.float32)
    return q, k, v, do


def _heads_first(x):
    return jnp.asarray(np.ascontiguousarray(np.transpose(x, (0, 2, 1, 3))))


def _port_grads(q, k, v, do, causal, sm_scale, group=1):
    """The autograd Function's output and gradients; K/V repeated per group
    kv-major, as nn/transformer.py does before K5."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    kr = kt.repeat_interleave(group, dim=2)
    vr = vt.repeat_interleave(group, dim=2)
    out = fa.flash_attention(qt, kr, vr, causal, sm_scale)
    out.backward(torch.from_numpy(do))
    return out.detach().numpy(), qt.grad.numpy(), kt.grad.numpy(), \
        vt.grad.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"t{s[1]}_hd{s[3]}")
def test_plain_matches_mha_reference(shape, causal):
    """Forward o and lse against mha_reference's residuals (lse = m +
    log l); the three backward passes against mha_reference_bwd. The
    library's backward reference takes sm_scale 1 only, so q carries the
    scale here."""
    q, k, v, do = _inputs(*shape)
    q = q / math.sqrt(shape[-1])
    o, l, m = lib.mha_reference_no_custom_vjp(
        _heads_first(q), _heads_first(k), _heads_first(v), causal=causal,
        save_residuals=True)
    dq, dk, dv, _ = lib.mha_reference_bwd(
        _heads_first(q), _heads_first(k), _heads_first(v), None, None, o,
        l, m, _heads_first(do), causal=causal, sm_scale=1.0)
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    po, plse = fa.flash_fwd_plain(tq, tk, tv, causal, 1.0)
    assert _rel(po.numpy().transpose(0, 2, 1, 3), o) <= REL
    assert _rel(plse.numpy(), m + jnp.log(l)) <= REL
    di = fa.attention_di(po, tdo)
    pdk, pdv = fa.flash_bwd_dkv_plain(tq, tk, tv, tdo, plse, di, causal, 1.0)
    pdq = fa.flash_bwd_dq_plain(tq, tk, tv, tdo, plse, di, causal, 1.0)
    for got, want in ((pdq, dq), (pdk, dk), (pdv, dv)):
        assert _rel(got.numpy().transpose(0, 2, 1, 3), want) <= REL
    # the autograd Function gives the same gradients
    _, gq, gk, gv = _port_grads(q, k, v, do, causal, 1.0)
    for got, want in ((gq, pdq), (gk, pdk), (gv, pdv)):
        assert _rel(got, want.numpy()) <= REL


@pytest.mark.parametrize("kv", [4, 2, 1], ids=["mha", "gqa2", "gqa1"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"t{s[1]}_hd{s[3]}")
def test_matches_dot_product_attention(shape, kv):
    """Output and q/k/v gradients (jax.vjp) of jax.nn.dot_product_attention
    (is_causal, JAX's own GQA grouping) against the port's K5 with K/V
    repeated per group, at the default scale 1/sqrt(hd)."""
    b, t, n, hd = shape
    q, k, v, do = _inputs(b, t, n, hd, kv=kv, seed=1)
    out, vjp = jax.vjp(lambda a, c, d: jax.nn.dot_product_attention(
        a, c, d, is_causal=True), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    got = _port_grads(q, k, v, do, True, None, group=n // kv)
    assert _rel(got[0], out) <= REL
    for g, w in zip(got[1:], grads):
        assert _rel(g, w) <= REL


def test_gradcheck_float64():
    """The autograd Function's backward (plain versions on the CPU)
    against finite differences, causal and not."""
    gen = torch.Generator().manual_seed(0)
    for causal in (True, False):
        q, k, v = (torch.randn(1, 5, 2, 4, generator=gen,
                               dtype=torch.float64).requires_grad_()
                   for _ in range(3))
        assert torch.autograd.gradcheck(
            lambda a, c, d, _c=causal: fa.flash_attention(a, c, d, _c),
            (q, k, v))


def test_cpu_takes_the_plain_versions_and_counts_nothing():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(1, 9, 2, 32))
    before = dict(fa.LAUNCHES)
    o, lse = fa.flash_fwd(q, k, v)
    po, plse = fa.flash_fwd_plain(q, k, v)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    di = fa.attention_di(o, do)
    assert all(torch.equal(a, b) for a, b in zip(
        fa.flash_bwd_dkv(q, k, v, do, lse, di),
        fa.flash_bwd_dkv_plain(q, k, v, do, lse, di)))
    assert torch.equal(fa.flash_bwd_dq(q, k, v, do, lse, di),
                       fa.flash_bwd_dq_plain(q, k, v, do, lse, di))
    assert fa.LAUNCHES == before
    assert o.dtype == torch.float32 and lse.shape == (1, 2, 9)


def test_shape_gate_and_refusals():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    assert fa.supported(q)
    assert not fa.supported(torch.zeros(1, 4, 2, 48))
    assert not fa.supported(torch.zeros(1, 4, 2, 64, dtype=torch.float16))
    with pytest.raises(ValueError, match="one shape"):
        fa.flash_fwd(q, q[:, :, :1], q)
    meta = torch.zeros(1, 4, 2, 64, device="meta")
    with pytest.raises(ValueError, match="on meta"):
        fa.flash_fwd(meta, meta, meta)
