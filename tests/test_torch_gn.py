"""K1 port (tempo_tpu_torch/ops/cuda_gn.py, ops/norms.py) against the JAX
GroupNorm and the Pallas kernel in interpret mode, on the CPU, where the
wrappers take their plain versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.ops.norms import gelu_exact as jax_gelu
from tempo_tpu.ops.norms import group_norm as jax_group_norm
from tempo_tpu.ops.norms import group_norm_act as jax_group_norm_act
from tempo_tpu.ops.pallas_gn import fused_group_norm_act as pallas_gn_act
from tempo_tpu_torch.ops import cuda_gn
from tempo_tpu_torch.ops.norms import group_norm, group_norm_act

torch.set_num_threads(1)


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", None])
def test_group_norm_act_matches_jax(act):
    """Plain port GroupNorm + act vs JAX group_norm_act at f32, atol 1e-5
    (fp32 sums in another order)."""
    x, scale, bias = _inputs((2, 8, 8, 32))
    want = jax_group_norm_act(jnp.asarray(x), 4, jnp.asarray(scale),
                              jnp.asarray(bias), 1e-6, act_name=act)
    got = group_norm_act(torch.from_numpy(x), 4, torch.from_numpy(scale),
                         torch.from_numpy(bias), 1e-6, act_name=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "relu", None])
def test_matches_pallas_interpret_f32(act):
    """Against the Pallas kernel run in interpret mode, f32 atol 2e-5 (the
    Pallas GELU uses an erf approximation good to ~1e-7)."""
    x, scale, bias = _inputs((2, 8, 8, 128), seed=1)
    want = pallas_gn_act(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias), 8, 1e-6, act, interpret=True)
    got = cuda_gn.fused_group_norm_act(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        8, 1e-6, act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_matches_pallas_interpret_bf16():
    """bf16 in and out: atol 0.05 (bf16 output rounding)."""
    x, scale, bias = _inputs((2, 8, 8, 128), seed=2)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = pallas_gn_act(xb, jnp.asarray(scale), jnp.asarray(bias), 8, 1e-6,
                         "gelu", interpret=True)
    got = cuda_gn.fused_group_norm_act(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale),
        torch.from_numpy(bias), 8, 1e-6, "gelu")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=0.05)


def test_stats_are_group_mean_and_rstd():
    """K1a's plain version: each channel carries its group's fp32 mean and
    rstd; checked against a float64 numpy computation."""
    x, _, _ = _inputs((3, 4, 5, 24), seed=3)
    stats = cuda_gn.gn_stats(torch.from_numpy(x), 6, 1e-6).numpy()
    assert stats.shape == (3, 2, 24) and stats.dtype == np.float32
    g = x.astype(np.float64).reshape(3, 20, 6, 4)
    mean = g.mean(axis=(1, 3))
    rstd = 1.0 / np.sqrt(g.var(axis=(1, 3)) + 1e-6)
    np.testing.assert_allclose(stats[:, 0], np.repeat(mean, 4, 1), atol=1e-6)
    np.testing.assert_allclose(stats[:, 1], np.repeat(rstd, 4, 1), rtol=1e-5)


def test_constant_input_clamps_variance():
    """var = max(E[x^2] - E[x]^2, 0): a constant group gives rstd =
    1/sqrt(eps), never NaN, and the output is the bias."""
    x = np.full((1, 4, 4, 8), 3.7, np.float32)
    bias = np.arange(8, dtype=np.float32)
    got = group_norm(torch.from_numpy(x), 2, torch.ones(8),
                     torch.from_numpy(bias), 1e-6)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(bias, x.shape),
                               atol=1e-2)
    # JAX folds the mean into the shift (x*alpha - mean*alpha with
    # alpha = 1/sqrt(eps) = 1e3), which rounds at |3.7e3| to ~2.4e-4; the
    # port subtracts the mean first, as the kernels do.
    want = jax_group_norm(jnp.asarray(x), 2, jnp.ones(8), jnp.asarray(bias),
                          1e-6, act=jax_gelu)
    got = group_norm(torch.from_numpy(x), 2, torch.ones(8),
                     torch.from_numpy(bias), 1e-6, act="gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3)


def test_cpu_tensor_takes_plain_path_without_launch():
    x, scale, bias = _inputs((1, 4, 4, 16))
    cuda_gn.LAUNCHES["gn_stats"] = 0
    cuda_gn.LAUNCHES["gn_apply"] = 0
    out = cuda_gn.fused_group_norm_act(torch.from_numpy(x),
                                       torch.from_numpy(scale),
                                       torch.from_numpy(bias), 4, 1e-6, None)
    assert out.shape == x.shape
    assert cuda_gn.LAUNCHES["gn_stats"] == 0
    assert cuda_gn.LAUNCHES["gn_apply"] == 0


def test_cpu_path_is_differentiable():
    """The CPU path is differentiable: with grad on, the wrapper goes
    through GroupNormActFn, whose forward is the plain version here and
    whose backward recomputes the plain GroupNorm + act, as on the card."""
    x, scale, bias = _inputs((1, 4, 4, 16), seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    group_norm_act(xt, 4, torch.from_numpy(scale), torch.from_numpy(bias),
                   act_name="gelu").square().sum().backward()

    def loss(xx):
        return jnp.sum(jnp.square(jax_group_norm_act(
            xx, 4, jnp.asarray(scale), jnp.asarray(bias), act_name="gelu")))

    want = jax.grad(loss)(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), atol=1e-4)
