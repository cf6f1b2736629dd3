"""VAE training in the port against the JAX package on the CPU in fp32: the
K1 and K2 autograd Functions (tempo_tpu_torch/ops/cuda_gn.py
GroupNormActFn, ops/cuda_gn_conv.py GnActConv3x3Fn; their CPU forward is
the plain version, so their recomputing backward runs here as on the card)
against jax.vjp of the Pallas functions in interpret mode, gradcheck of
both in float64, ``get_loss`` and one step's gradients against JAX's
``get_loss`` with the same weights and posterior noise, 5 train steps of
the VAE recipe against JAX's, remat and grad_accum.

Tolerances: fp32 on both sides, sum order only. Function gradients
rtol 1e-4 with an absolute floor of 1e-4 of the largest element; a step's
loss and metrics rtol 1e-4 and each gradient within 1e-4 relative L2 (the
attention's key bias, whose exact gradient is 0, only bounded); the 5-step
losses within 1e-3 relative of JAX at every step (SURVEY §6), the metrics
without the constant logvar term too."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.ops.pallas_gn import fused_group_norm_act as pallas_gn_act
from tempo_tpu.ops.pallas_gn_conv import fused_gn_act_conv as pallas_gn_conv
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig, vae_loss
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
FN_TOL = 1e-4
STEP_REL = 1e-4
LOSS_REL = 1e-3


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FN_TOL,
                               atol=FN_TOL * np.abs(want).max())


def _gn_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, g


def _leaves(*arrays):
    return [torch.from_numpy(a).requires_grad_() for a in arrays]


@pytest.mark.parametrize("act", ["gelu", "relu", "silu", None])
def test_k1_function_grads_match_pallas_vjp(act):
    """fused_group_norm_act with grad on goes through GroupNormActFn; its
    dx, dscale, dbias equal jax.vjp of the Pallas function (interpret
    mode), whose backward is the XLA recompute."""
    x, scale, bias, g = _gn_inputs((2, 8, 8, 128), seed=1)
    _, vjp = jax.vjp(lambda xx, ss, bb: pallas_gn_act(
        xx, ss, bb, 8, 1e-6, act, interpret=True),
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(g))
    xt, st, bt = _leaves(x, scale, bias)
    out = cuda_gn.fused_group_norm_act(xt, st, bt, 8, 1e-6, act)
    assert type(out.grad_fn).__name__ == "GroupNormActFnBackward"
    out.backward(torch.from_numpy(g))
    for got, w in zip((xt.grad, st.grad, bt.grad), want):
        _close(got, w)


@pytest.mark.parametrize("shape,f", [((2, 8, 8, 32), 16),
                                     ((1, 16, 8, 16), 20)],
                         ids=["b2_c32_f16", "b1_c16_f20"])
@pytest.mark.parametrize("act", ["gelu", None])
def test_k2_function_grads_match_pallas_vjp(shape, f, act):
    """gn_act_conv3x3 with grad on goes through GnActConv3x3Fn; its dx,
    dscale, dbias, dweight (OIHW) and dconv_bias equal jax.vjp of the
    Pallas function (interpret mode), whose backward is the XLA recompute
    of the chain."""
    x, scale, bias, _ = _gn_inputs(shape, seed=f)
    rng = np.random.default_rng(f + 1)
    c = shape[-1]
    kern = (0.05 * rng.standard_normal((3, 3, c, f))).astype(np.float32)
    cb = (0.01 * rng.standard_normal(f)).astype(np.float32)
    g = rng.standard_normal(shape[:3] + (f,)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx, ss, bb, kk, cc: pallas_gn_conv(
        xx, ss, bb, kk, cc, 4, 1e-6, act, True),
        *(jnp.asarray(a) for a in (x, scale, bias, kern, cb)))
    want = list(vjp(jnp.asarray(g)))
    want[3] = np.transpose(np.asarray(want[3]), (3, 2, 0, 1))  # -> OIHW
    xt, st, bt, cbt = _leaves(x, scale, bias, cb)
    wt = torch.from_numpy(np.ascontiguousarray(
        np.transpose(kern, (3, 2, 0, 1)))).requires_grad_()
    out = cuda_gn_conv.gn_act_conv3x3(xt, st, bt, wt, cbt, 4, 1e-6, act)
    assert type(out.grad_fn).__name__ == "GnActConv3x3FnBackward"
    out.backward(torch.from_numpy(g))
    for got, w in zip((xt.grad, st.grad, bt.grad, wt.grad, cbt.grad), want):
        _close(got, w)


@pytest.mark.parametrize("act", ["gelu", None])
def test_functions_pass_gradcheck_in_float64(act):
    gen = torch.Generator().manual_seed(0)

    def leaf(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float64,
                           requires_grad=True)

    x, scale, bias = leaf(2, 3, 4, 8), leaf(8), leaf(8)
    weight, conv_bias = leaf(5, 8, 3, 3), leaf(5)
    assert torch.autograd.gradcheck(
        lambda *t: cuda_gn.GroupNormActFn.apply(*t, 4, 1e-6, act),
        (x, scale, bias))
    assert torch.autograd.gradcheck(
        lambda *t: cuda_gn_conv.GnActConv3x3Fn.apply(*t, None, 4, 1e-6, act),
        (x, scale, bias, weight, conv_bias))
    # only the inputs that ask get a gradient
    out = cuda_gn_conv.gn_act_conv3x3(x.detach(), scale, None,
                                      weight.detach(), None, 4, 1e-6, act)
    grads = torch.autograd.grad(out.sum(), scale)
    assert grads[0].shape == scale.shape


def test_no_graph_without_grad():
    x, scale, bias, _ = _gn_inputs((1, 4, 4, 16))
    xt, st, bt = _leaves(x, scale, bias)
    with torch.no_grad():
        assert cuda_gn.fused_group_norm_act(xt, st, bt, 4).grad_fn is None
    plain = cuda_gn.fused_group_norm_act(xt.detach(), None, None, 4)
    assert plain.grad_fn is None


def test_posterior_noise_in_the_means_type_and_device():
    """sample() draws its noise in the posterior mean's dtype and on its
    device, as JAX's sample draws in the mean's dtype."""
    mean = torch.zeros(2, 3, 3, 4, dtype=torch.float64)
    post = DiagonalGaussian(mean, torch.zeros_like(mean))
    z = post.sample(torch.Generator().manual_seed(0))
    assert z.dtype == torch.float64 and z.device == mean.device
    want = torch.randn(mean.shape, generator=torch.Generator().manual_seed(0),
                       dtype=torch.float64)
    assert torch.equal(z, want)


# --------------------------------------------------------------- the step

def _jax_pair(cfg_kwargs=TINY, seed=0):
    """The JAX model, its parameters nudged off the zero init so that every
    layer matters, and the port model with the same weights."""
    jm = JaxVAE(JaxConfig(**cfg_kwargs))
    c, h, w = cfg_kwargs["shape"]
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, h, w, c)),
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    port = AutoencoderKL(VAEConfig(**cfg_kwargs), device="cpu", seed=seed)
    port.load_state_dict(state_dict_from_jax_params(params))
    return jm, params, port


def _batch(seed, n=2):
    c, h, w = TINY["shape"]
    return np.random.default_rng(seed).standard_normal(
        (n, h, w, c)).astype(np.float32)


def _jax_noise(key, batch):
    """The noise JAX's posterior sample draws with ``key``."""
    h, w = batch.shape[1] // 4, batch.shape[2] // 4
    return np.asarray(jax.random.normal(
        key, (batch.shape[0], h, w, TINY["embed_dim"]), jnp.float32))


def _feed_noise(monkeypatch, noises):
    """Make the port's posterior sample use the given arrays, one a call."""
    it = iter(noises)

    def sample(self, generator=None):
        return self.mean + self.std * torch.from_numpy(np.array(next(it)))

    monkeypatch.setattr(DiagonalGaussian, "sample", sample)


def _close_grads(port, want_sd):
    got = {k: p.grad for k, p in port.named_parameters()}
    assert set(got) == set(want_sd)
    for name, want in want_sd.items():
        if got[name] is None:  # held by both, used by neither (last level)
            assert not want.any(), name
            continue
        if name.endswith("mid_attn1.k.bias"):
            # adding a bias to every key moves each query's scores by one
            # constant: the exact gradient is 0, both sides hold rounding
            assert got[name].abs().max() <= 1e-4
            continue
        assert _rel_l2(got[name], want) <= STEP_REL, name


def test_get_loss_and_gradients_match_jax(monkeypatch):
    jm, params, port = _jax_pair()
    x = _batch(3)
    key = jax.random.PRNGKey(7)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jm.apply({"params": p}, jnp.asarray(x), key,
                           method=JaxVAE.get_loss), has_aux=True)(params)
    _feed_noise(monkeypatch, [_jax_noise(key, x)])
    loss, metrics = port.get_loss(torch.from_numpy(x), torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=STEP_REL)
    assert set(metrics) == set(want_m)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=STEP_REL)
    _close_grads(port, state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, want_g)))


def test_train_steps_match_jax(monkeypatch):
    """5 steps of the VAE recipe (global-norm clip at 1.0, AdamW lr 1e-3,
    betas (0.9, 0.95), weight decay 0.05) on the same batches and posterior
    noise: JAX's make_train_step(vae_loss_fn) against the port's."""
    jm, params, port = _jax_pair()
    batches = [_batch(10 + i) for i in range(5)]
    rng = jax.random.PRNGKey(3)
    j_tx = jstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    j_step = jstep.make_train_step(jstep.vae_loss_fn(jm), j_tx, donate=False)
    j_state = jstate.create_train_state(params, j_tx, rng)
    want = []
    for b in batches:
        j_state, m = j_step(j_state, jnp.asarray(b))
        want.append({k: float(v) for k, v in m.items()})
    # JAX's step draws its noise with fold_in(rng, step)
    _feed_noise(monkeypatch, [_jax_noise(jax.random.fold_in(rng, i), b)
                              for i, b in enumerate(batches)])
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = pstate.create_train_state(port, tx, 3)
    step = pstep.make_train_step(pstep.vae_loss_fn(port), tx)
    for i, b in enumerate(batches):
        state, m = step(state, torch.from_numpy(b))
        for k in ("loss", "nll_loss", "kl_loss", "pixel_mse", "grad_norm"):
            assert abs(m[k].item() - want[i][k]) <= LOSS_REL * abs(
                want[i][k]), (i, k, m[k].item(), want[i][k])
    assert want[0]["grad_norm"] > 1.0  # the clip acted
    assert want[-1]["pixel_mse"] < want[0]["pixel_mse"]


def test_remat_gives_the_same_loss_and_gradients():
    x = torch.from_numpy(_batch(4))
    out = []
    for remat in (False, True):
        _, _, port = _jax_pair(dict(TINY, remat=remat))
        loss, _ = port.get_loss(x, torch.Generator().manual_seed(5))
        loss.backward()
        out.append((loss.detach(), [p.grad for p in port.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_grad_accum_equals_the_one_shot_step():
    """grad_accum=2 of a mode()-based loss (no draw) averages microbatch
    gradients and metrics into the one-shot step's."""

    def mode_loss(model, batch, generator):
        recon, post = model(batch, sample_posterior=False)
        return vae_loss(batch, recon, post, model.logvar, model.config)

    x = torch.from_numpy(_batch(6, n=4))
    runs = []
    for accum in (1, 2):
        _, _, port = _jax_pair()
        tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
        state = pstate.create_train_state(port, tx, 0)
        state, m = pstep.make_train_step(mode_loss, tx, grad_accum=accum)(
            state, x)
        used = [p for p in port.parameters() if p.grad is not None]
        runs.append((m, [p.grad.clone() for p in used],
                     [p.detach().clone() for p in used]))
    (m1, g1, p1), (m2, g2, p2) = runs
    for k in m1:
        np.testing.assert_allclose(m2[k].item(), m1[k].item(), rtol=1e-5)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    moved = [(a - b).abs().max().item() for a, b in zip(p2, p1)]
    assert max(moved) <= 2e-3  # no update larger than one AdamW step


def test_bf16_step_runs_through_the_functions():
    """A bf16 tiny model trains on the CPU: the Functions' forward in bf16,
    their fp32 recompute, fp32 parameters and gradients."""
    cfg = dataclasses.replace(VAEConfig(**TINY), compute_dtype="bfloat16")
    port = AutoencoderKL(cfg, device="cpu", seed=2)
    tx = pstate.make_optimizer(lr=1e-3)
    state = pstate.create_train_state(port, tx, 0)
    step = pstep.make_train_step(pstep.vae_loss_fn(port), tx)
    x = torch.from_numpy(_batch(8))
    losses = [step(state, x)[1]["loss"].item() for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(p.grad.dtype == torch.float32 for p in port.parameters()
               if p.grad is not None)
