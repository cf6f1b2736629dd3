"""The L2-supervised VAE in the port (tempo_tpu_torch/models/vae_l2.py)
against the JAX package's (tempo_tpu/models/vae_l2.py) on the CPU in fp32,
with the same weights (crossed by interop/jax_params.py
``l2_state_dict_from_jax`` and the JAX package's
``l2_params_from_torch_state_dict``) and JAX's posterior noise fed to the
port: the head's forward, the pooling and the masked MSE (an all-NaN
product too), ``compute_loss`` and its gradients with the two samples' noise
from ``jax.random.split``, 5 train steps of ``vae_l2_loss_fn``,
``grad_accum`` on dict batches, and the in-model NO2 probe.

Tolerances: fp32 on both sides, sum order only. The head and the loss
rel 1e-5; each gradient within 1e-4 relative L2 (the attention's key bias,
whose exact gradient is 0, only bounded); the 5-step losses within 1e-3
relative of JAX at every step (SURVEY §6)."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.interop.torch_ckpt import l2_params_from_torch_state_dict
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.models.vae_l2 import L2_PRODUCTS as JAX_PRODUCTS
from tempo_tpu.models.vae_l2 import VAEWithL2Head as JaxL2
from tempo_tpu.models.vae_l2 import avg_pool_4x_nan as jax_pool
from tempo_tpu.models.vae_l2 import masked_mse as jax_mse
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.interop.jax_params import (l2_state_dict_from_jax,
                                                state_dict_from_jax_params)
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.models.vae_l2 import (DEFAULT_L2_WEIGHTS, L2_PRODUCTS,
                                           VAEWithL2Head, avg_pool_4x_nan,
                                           masked_mse)
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
HIDDEN = (16, 16)
REL = 1e-5
GRAD_REL = 1e-4
LOSS_REL = 1e-3


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _batch(seed, n=2, nan_product=None, nan_share=0.1):
    """{'spectral': [n,16,16,12], product: [n,16,16]} with NaN in some
    positions of each field, and every position of ``nan_product``."""
    rng = np.random.default_rng(seed)
    c, h, w = TINY["shape"]
    batch = {"spectral": rng.standard_normal((n, h, w, c)).astype(np.float32)}
    for p in L2_PRODUCTS:
        field = rng.standard_normal((n, h, w)).astype(np.float32)
        field[rng.random(field.shape) < nan_share] = np.nan
        if p == nan_product:
            field[:] = np.nan
        batch[p] = field
    return batch


def _jax_pair(cfg_kwargs=TINY, seed=0):
    """The JAX model, its parameters nudged off the zero init so that every
    layer matters, and the port model with the same weights."""
    jm = JaxL2(JaxConfig(**cfg_kwargs), mlp_hidden=HIDDEN)
    sample = {k: jnp.asarray(v) for k, v in _batch(99, n=1).items()}
    params = jm.init(jax.random.PRNGKey(seed), sample, jax.random.PRNGKey(1),
                     method=JaxL2.compute_loss)["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    port = VAEWithL2Head(VAEConfig(**cfg_kwargs), HIDDEN, device="cpu",
                         seed=seed)
    port.load_state_dict(l2_state_dict_from_jax(params, HIDDEN))
    return jm, params, port


def _jax_noise(key, n):
    """The noise JAX's posterior sample draws with ``key``."""
    return np.asarray(jax.random.normal(key, (n, 4, 4, TINY["embed_dim"]),
                                        jnp.float32))


def _feed_noise(monkeypatch, noises):
    """Make the port's posterior sample use the given arrays, one a call."""
    it = iter(noises)

    def sample(self, generator=None):
        return self.mean + self.std * torch.from_numpy(np.array(next(it)))

    monkeypatch.setattr(DiagonalGaussian, "sample", sample)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


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
        assert _rel_l2(got[name], want) <= GRAD_REL, name


def test_products_and_weights_are_jax_s():
    assert L2_PRODUCTS == JAX_PRODUCTS
    assert DEFAULT_L2_WEIGHTS == {p: 0.1 for p in JAX_PRODUCTS}


def test_head_matches_jax():
    jm, params, port = _jax_pair()
    z = np.random.default_rng(2).standard_normal((3, 4, 4, 4)).astype(
        np.float32)
    want = jm.apply({"params": params}, jnp.asarray(z),
                    method=lambda m, zz: m.l2_head(zz))
    got = port.l2_head(torch.from_numpy(z))
    assert got.shape == (3, 4, 4, len(L2_PRODUCTS))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=REL, atol=REL)


def test_state_dict_is_the_reference_layout_both_ways():
    """The port's state_dict is the reference VAEWithL2Supervision's
    layout: the JAX package's importer reads it back into the JAX tree, and
    a reference-layout state_dict loads into the port strictly."""
    _, params, port = _jax_pair()
    sd = port.state_dict()
    assert [k for k in sd if k.startswith("l2_head.")] == [
        "l2_head.mlp.0.weight", "l2_head.mlp.1.weight", "l2_head.mlp.1.bias",
        "l2_head.mlp.3.weight", "l2_head.mlp.4.weight", "l2_head.mlp.4.bias",
        "l2_head.mlp.6.weight", "l2_head.mlp.6.bias"]
    back = l2_params_from_torch_state_dict(sd, mlp_hidden=HIDDEN)
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf),
                                      np.asarray(flat_want[path]))
    fresh = VAEWithL2Head(VAEConfig(**TINY), HIDDEN, device="cpu", seed=5)
    fresh.load_state_dict(l2_state_dict_from_jax(params, HIDDEN), strict=True)


@pytest.mark.parametrize("nan_share", [0.0, 0.1, 1.0],
                         ids=["finite", "some_nan", "all_nan"])
def test_pool_and_masked_mse_match_jax(nan_share):
    rng = np.random.default_rng(3)
    field = rng.standard_normal((2, 16, 16)).astype(np.float32)
    field[rng.random(field.shape) < nan_share] = np.nan
    pred = rng.standard_normal((2, 4, 4)).astype(np.float32)
    pooled = avg_pool_4x_nan(torch.from_numpy(field))
    want_pooled = np.asarray(jax_pool(jnp.asarray(field)))
    np.testing.assert_allclose(pooled.numpy(), want_pooled, rtol=REL)
    pred_t = torch.from_numpy(pred).requires_grad_()
    loss = masked_mse(pred_t, pooled)
    np.testing.assert_allclose(
        loss.item(), float(jax_mse(jnp.asarray(pred), want_pooled)),
        rtol=REL)
    loss.backward()
    valid = ~np.isnan(want_pooled)
    assert np.isfinite(pred_t.grad.numpy()).all()
    assert (pred_t.grad.numpy()[~valid] == 0).all()
    if nan_share == 1.0:
        assert loss.item() == 0.0 and not pred_t.grad.any()


def test_compute_loss_and_gradients_match_jax(monkeypatch):
    """Same weights, batch and noise (the decoded sample's and the head's,
    from jax.random.split): loss, every metric and every gradient. CLDO4's
    targets are all NaN: its loss is 0 and so is its output row's
    gradient."""
    jm, params, port = _jax_pair()
    batch = _batch(4, nan_product="CLDO4")
    key = jax.random.PRNGKey(7)
    (want_loss, want_m), want_g = jax.value_and_grad(
        lambda p: jm.apply({"params": p},
                           {k: jnp.asarray(v) for k, v in batch.items()},
                           key, method=JaxL2.compute_loss),
        has_aux=True)(params)
    k_vae, k_head = jax.random.split(key)
    _feed_noise(monkeypatch, [_jax_noise(k_vae, 2), _jax_noise(k_head, 2)])
    loss, metrics = port.compute_loss(_torch_batch(batch), torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=REL)
    assert set(metrics) == set(want_m)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=REL, atol=1e-7)
    assert metrics["CLDO4_loss"].item() == 0.0
    out = port.l2_head.mlp[-1]
    assert not out.weight.grad[3].any() and out.bias.grad[3] == 0
    assert out.weight.grad[:3].abs().min() > 0
    _close_grads(port, l2_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, want_g), HIDDEN))


def test_the_head_reads_a_second_sample(monkeypatch):
    """The reference's quirk: the head sees another draw than the decoder.
    Feeding the decoded draw twice changes the product losses only."""
    _, _, port = _jax_pair()
    batch = _torch_batch(_batch(5))
    a, b = (np.random.default_rng(s).standard_normal((2, 4, 4, 4)).astype(
        np.float32) for s in (1, 2))
    _feed_noise(monkeypatch, [a, b, a, a])
    _, two = port.compute_loss(batch, torch.Generator())
    _, one = port.compute_loss(batch, torch.Generator())
    assert two["nll_loss"].item() == one["nll_loss"].item()
    assert two["NO2_loss"].item() != one["NO2_loss"].item()


def test_train_steps_match_jax(monkeypatch):
    """5 steps of the L2 recipe (global-norm clip at 1.0, AdamW lr 1e-3,
    weight decay 0.05) on the same dict batches and noise: JAX's
    make_train_step(vae_l2_loss_fn) against the port's."""
    jm, params, port = _jax_pair()
    batches = [_batch(10 + i) for i in range(5)]
    rng = jax.random.PRNGKey(3)
    j_tx = jstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    j_step = jstep.make_train_step(jstep.vae_l2_loss_fn(jm), j_tx,
                                   donate=False)
    j_state = jstate.create_train_state(params, j_tx, rng)
    want = []
    for b in batches:
        j_state, m = j_step(j_state, {k: jnp.asarray(v)
                                      for k, v in b.items()})
        want.append({k: float(v) for k, v in m.items()})
    noises = []
    for i in range(5):  # JAX's step: fold_in(rng, step), then the split
        k_vae, k_head = jax.random.split(jax.random.fold_in(rng, i))
        noises += [_jax_noise(k_vae, 2), _jax_noise(k_head, 2)]
    _feed_noise(monkeypatch, noises)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = pstate.create_train_state(port, tx, 3)
    step = pstep.make_train_step(pstep.vae_l2_loss_fn(port), tx)
    for i, b in enumerate(batches):
        state, m = step(state, _torch_batch(b))
        assert set(m) == set(want[i])
        for k in m:
            assert abs(m[k].item() - want[i][k]) <= LOSS_REL * abs(
                want[i][k]), (i, k, m[k].item(), want[i][k])
    assert want[-1]["NO2_loss"] < want[0]["NO2_loss"]


def test_grad_accum_on_dict_batches_equals_the_one_shot_step(monkeypatch):
    """grad_accum=2 splits every value of the dict; with the posterior's
    mean for its samples (no draw) the update is the one-shot step's. The
    fields hold no NaN: a masked mean over each microbatch's valid
    positions averages to the whole batch's only when the counts match."""
    monkeypatch.setattr(DiagonalGaussian, "sample",
                        lambda self, generator=None: self.mean)
    batch = _torch_batch(_batch(6, n=4, nan_share=0.0))
    runs = []
    for accum in (1, 2):
        _, _, port = _jax_pair()
        tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
        state = pstate.create_train_state(port, tx, 0)
        state, m = pstep.make_train_step(pstep.vae_l2_loss_fn(port), tx,
                                         grad_accum=accum)(state, batch)
        used = [p for p in port.parameters() if p.grad is not None]
        runs.append((m, [p.grad.clone() for p in used]))
    (m1, g1), (m2, g2) = runs
    for k in m1:
        np.testing.assert_allclose(m2[k].item(), m1[k].item(), rtol=1e-5)
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)
    with pytest.raises(ValueError, match="divisible"):
        pstep.make_train_step(pstep.vae_l2_loss_fn(port), tx, grad_accum=3)(
            state, batch)


def test_bf16_l2_step_runs_through_the_functions():
    """A bf16 tiny model trains on the CPU: the head's GroupNorms through
    GroupNormActFn, fp32 parameters and gradients, finite losses."""
    cfg = dataclasses.replace(VAEConfig(**TINY), compute_dtype="bfloat16")
    port = VAEWithL2Head(cfg, HIDDEN, device="cpu", seed=2)
    z = torch.zeros(1, 4, 4, 4, requires_grad=True)
    out = port.l2_head(z)
    assert out.dtype == torch.bfloat16
    tx = pstate.make_optimizer(lr=1e-3)
    state = pstate.create_train_state(port, tx, 0)
    step = pstep.make_train_step(pstep.vae_l2_loss_fn(port), tx)
    batch = _torch_batch(_batch(8))
    losses = [step(state, batch)[1] for _ in range(3)]
    assert all(np.isfinite(m[k].item()) for m in losses for k in m)
    assert losses[-1]["loss"].item() < losses[0]["loss"].item()
    assert all(p.grad.dtype == torch.float32 for p in port.parameters()
               if p.grad is not None)


def test_forward_returns_the_jax_keys():
    _, _, port = _jax_pair()
    x = torch.from_numpy(_batch(9)["spectral"])
    out = port(x, torch.Generator().manual_seed(0))
    assert set(out) == {"reconstruction", "posterior", "z", "l2_predictions"}
    assert out["reconstruction"].shape == x.shape
    assert set(out["l2_predictions"]) == set(L2_PRODUCTS)
    assert out["l2_predictions"]["NO2"].shape == (2, 4, 4)
    assert torch.equal(port.decode(out["z"]), out["reconstruction"])
    assert torch.equal(port.encode(x).mean, out["posterior"].mean)


def test_predict_no2_matches_jax():
    """The vestigial in-model NO2 probe: ReLU MLP on the latent mean."""
    cfg = dict(TINY, no2_weight=0.1, no2_mlp_hidden=(8, 6))
    jm = JaxVAE(JaxConfig(**cfg))
    x = _batch(11)["spectral"]
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     method=lambda m, xx: (m(xx, rng=jax.random.PRNGKey(1)),
                                           m.predict_no2(xx)))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    want = jm.apply({"params": params}, jnp.asarray(x),
                    method=JaxVAE.predict_no2)
    port = AutoencoderKL(VAEConfig(**cfg), device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params))
    got = port.predict_no2(torch.from_numpy(x))
    assert got.shape == (2, 4, 4, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=REL, atol=REL)
    with pytest.raises(ValueError, match="NO2 probe"):
        AutoencoderKL(VAEConfig(**TINY), device="cpu").predict_no2(
            torch.from_numpy(x))
