"""K2 port (tempo_tpu_torch/ops/cuda_gn_conv.py) against the JAX chain and
the Pallas kernel in interpret mode, on the CPU, where the wrapper takes
its plain version."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops.pallas_gn_conv import _reference_chain, fused_gn_act_conv
from tempo_tpu_torch.nn.blocks import Conv2d
from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

torch.set_num_threads(1)


def _inputs(b, h, w, c, f, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    kern = (rng.standard_normal((3, 3, c, f)) * 0.02).astype(np.float32)
    cb = (0.01 * rng.standard_normal(f)).astype(np.float32)
    return x, scale, bias, kern, cb


def _oihw(kern_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(kern_hwio, (3, 2, 0, 1))))


def _port(x, scale, bias, kern, cb, groups, act, dtype=torch.float32):
    return cuda_gn_conv.gn_act_conv3x3(
        torch.from_numpy(x).to(dtype), torch.from_numpy(scale),
        torch.from_numpy(bias), _oihw(kern), torch.from_numpy(cb), groups,
        1e-6, act)


@pytest.mark.parametrize("act,f", [("gelu", 16), (None, 16), ("gelu", 20)])
def test_plain_chain_matches_jax_reference(act, f):
    """Plain chain vs JAX _reference_chain at f32, atol 1e-4 (fp32 sums over
    9*C terms in another order). F=20 is a ragged output width."""
    x, scale, bias, kern, cb = _inputs(2, 8, 8, 32, f, seed=f)
    want = _reference_chain(jnp.asarray(x), jnp.asarray(scale),
                            jnp.asarray(bias), jnp.asarray(kern),
                            jnp.asarray(cb), 4, 1e-6, act)
    got = _port(x, scale, bias, kern, cb, 4, act)
    assert got.shape == (2, 8, 8, f)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_matches_pallas_interpret_bf16():
    """bf16 against the Pallas kernel in interpret mode at
    b,h,w,c,f = 2,16,16,256,128: atol 3e-2, rtol 2e-2 (bf16 operands and
    output), including the zero halo at the image top and bottom."""
    x, scale, bias, kern, cb = _inputs(2, 16, 16, 256, 128)
    want = fused_gn_act_conv(jnp.asarray(x).astype(jnp.bfloat16),
                             jnp.asarray(scale), jnp.asarray(bias),
                             jnp.asarray(kern), jnp.asarray(cb), 8, 1e-6,
                             "gelu", True)
    got = _port(x, scale, bias, kern, cb, 8, "gelu", torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=3e-2, rtol=2e-2)


def test_packed_weight_layout():
    """The kernel's [9, Cp, Fp] weight is the HWIO kernel with the taps
    flattened row-major, packed[3*di + dj, :C, :F] == hwio[di, dj], and C
    and F zero-padded up to multiples of 64."""
    _, _, _, kern, _ = _inputs(1, 1, 1, 6, 5)
    packed = cuda_gn_conv.pack_conv3x3_weight(_oihw(kern), torch.float32)
    assert packed.shape == (9, 64, 64) and packed.is_contiguous()
    np.testing.assert_array_equal(packed[:, :6, :5].numpy(),
                                  kern.reshape(9, 6, 5))
    assert not packed[:, 6:].any() and not packed[:, :, 5:].any()


@pytest.mark.parametrize("act", ["gelu", None])
def test_from_stats_plain_is_the_chain(act):
    """K2 alone from K1a's statistics (plain on the CPU) is the whole plain
    chain, bit for bit."""
    x, scale, bias, kern, cb = _inputs(2, 6, 5, 16, 12, seed=3)
    xt, st, bt, wt, cbt = (torch.from_numpy(x), torch.from_numpy(scale),
                           torch.from_numpy(bias), _oihw(kern),
                           torch.from_numpy(cb))
    got = cuda_gn_conv.conv3x3_from_stats(
        xt, cuda_gn.gn_stats(xt, 4, 1e-6), st, bt, wt, cbt, act)
    want = cuda_gn_conv.gn_act_conv3x3_plain(xt, st, bt, wt, cbt, 4, 1e-6,
                                             act)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_packed_weight_cache_follows_the_weight():
    """A module's cached K2 weight is repacked after an in-place change,
    also for a module made under inference_mode (no version count)."""
    def fresh(conv):
        return cuda_gn_conv.pack_conv3x3_weight(conv.weight, torch.float32)

    conv = Conv2d(6, 5)
    first = conv.packed_weight(torch.float32)
    assert conv.packed_weight(torch.float32) is first
    with torch.no_grad():
        conv.weight.add_(1.0)
    assert torch.equal(conv.packed_weight(torch.float32), fresh(conv))
    with torch.inference_mode():
        conv = Conv2d(6, 5)
        conv.packed_weight(torch.float32)
        conv.weight.add_(1.0)
        assert torch.equal(conv.packed_weight(torch.float32), fresh(conv))


def test_cpu_tensor_takes_plain_path_without_launch():
    x, scale, bias, kern, cb = _inputs(1, 4, 4, 8, 4)
    cuda_gn.LAUNCHES["gn_stats"] = 0
    cuda_gn_conv.LAUNCHES["gn_act_conv3x3"] = 0
    out = _port(x, scale, bias, kern, cb, 2, "gelu")
    assert out.shape == (1, 4, 4, 4)
    assert cuda_gn_conv.LAUNCHES["gn_act_conv3x3"] == 0
    assert cuda_gn.LAUNCHES["gn_stats"] == 0
