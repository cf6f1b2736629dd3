"""The port's AutoencoderKL (tempo_tpu_torch/models/vae.py) against the JAX
model with the same weights, bridged by state_dict_from_jax_params, on the
CPU at f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.models.vae import vae_loss as jax_vae_loss
from tempo_tpu.nn.distributions import DiagonalGaussian as JaxGaussian
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig, build_vae
from tempo_tpu_torch.models.vae import vae_loss
from tempo_tpu_torch.nn.distributions import DiagonalGaussian

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
PADDED = dict(TINY, shape=(260, 8, 8), pad_boundary=True)
TOL = dict(rtol=1e-4, atol=1e-4)


def jax_pair(cfg_kwargs, seed=0):
    """JAX model + params (nudged off the zero init so every output conv
    matters) and the port model loaded with the same weights."""
    jcfg = JaxConfig(**cfg_kwargs)
    jm = JaxVAE(jcfg)
    c, h, w = jcfg.shape
    x0 = jnp.zeros((1, h, w, c), jnp.float32)
    params = jm.init(jax.random.PRNGKey(seed), x0,
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    port = AutoencoderKL(VAEConfig(**cfg_kwargs), device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params))
    return jm, params, port


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("cfg", [TINY, PADDED], ids=["tiny", "padded"])
def test_forward_and_loss_match_jax(cfg):
    jm, params, port = jax_pair(cfg)
    c, h, w = cfg["shape"]
    x = np.random.default_rng(5).standard_normal((2, h, w, c)).astype(
        np.float32)
    v = {"params": params}
    jpost = jm.apply(v, jnp.asarray(x), method=JaxVAE.encode)
    jdec = jm.apply(v, jpost.mean, method=JaxVAE.decode)
    jrec = jm.apply(v, jnp.asarray(x), sample_posterior=False,
                    method=JaxVAE.reconstruct)
    _, jmet = jax_vae_loss(jnp.asarray(x), jrec, jpost, params["logvar"],
                           jm.config)

    with torch.no_grad():
        xt = torch.from_numpy(x)
        post = port.encode(xt)
        dec = port.decode(post.mean)
        rec = port.reconstruct(xt, sample_posterior=False)
        _, met = vae_loss(xt, rec, post, port.logvar, port.config)

    np.testing.assert_allclose(_np(post.mean), np.asarray(jpost.mean), **TOL)
    np.testing.assert_allclose(_np(post.logvar), np.asarray(jpost.logvar),
                               **TOL)
    np.testing.assert_allclose(_np(dec), np.asarray(jdec), **TOL)
    np.testing.assert_allclose(_np(rec), np.asarray(jrec), **TOL)
    assert set(met) == {"loss", "nll_loss", "kl_loss", "pixel_mse"}
    for name in met:
        np.testing.assert_allclose(float(met[name]), float(jmet[name]),
                                   **TOL)


def test_flagship_param_count():
    """27,289,893 parameters, built on the CPU without a forward."""
    model, cfg = build_vae({}, device="cpu")
    assert cfg.dtype == torch.bfloat16
    assert sum(p.numel() for p in model.parameters()) == 27_289_893
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_fresh_model_decodes_zero():
    """Zero-init output convs: a fresh model reconstructs exactly 0."""
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    x = torch.randn(2, 16, 16, 12, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        recon = model.reconstruct(x, sample_posterior=False)
    assert torch.equal(recon, torch.zeros_like(recon))
    assert float(model.logvar.detach()) == 6.0


def test_bf16_compute_keeps_fp32_params_and_posterior():
    cfg = dict(TINY, compute_dtype="bfloat16")
    model = AutoencoderKL(VAEConfig(**cfg), device="cpu", seed=3)
    x = torch.randn(1, 16, 16, 12, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        recon, post = model(x, generator=torch.Generator().manual_seed(0))
    assert recon.dtype == torch.bfloat16 and recon.shape == x.shape
    assert post.mean.dtype == torch.float32 and post.mean.shape == (1, 4, 4, 4)


def test_sampling_needs_a_generator_and_is_seeded():
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    x = torch.randn(1, 16, 16, 12, generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        with pytest.raises(ValueError):
            model(x)
        a = model.encode(x).sample(torch.Generator().manual_seed(9))
        b = model.encode(x).sample(torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


def test_seeded_init_is_reproducible():
    a = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=11).state_dict()
    b = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=11).state_dict()
    c = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=12).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def test_build_vae_from_config_dict():
    _, cfg = build_vae({
        "shape": [12, 16, 16], "chs": [16, 12, 8], "z_channels": 4,
        "embed_dim": 4, "n_attention_heads": 2, "norm_groups": 4,
        "kl_weight": 1e-5, "nll_loss_type": "l2", "pad_boundary": True,
        "remat": True, "unknown_key_is_ignored": True,
    }, compute_dtype="float32", device="cpu")
    assert cfg.kl_weight == 1e-5 and cfg.nll_loss_type == "l2"
    assert cfg.chs == (16, 12, 8) and cfg.dtype == torch.float32


@pytest.mark.parametrize("loss_type", ["l1", "l2", "ms_mse"])
def test_vae_loss_matches_jax(loss_type):
    rng = np.random.default_rng(2)
    x, r = (rng.standard_normal((3, 4, 4, 5)).astype(np.float32)
            for _ in range(2))
    mean, logvar = (rng.standard_normal((3, 2, 2, 2)).astype(np.float32)
                    for _ in range(2))
    _, want = jax_vae_loss(
        jnp.asarray(x), jnp.asarray(r),
        JaxGaussian(jnp.asarray(mean), jnp.asarray(logvar)),
        jnp.asarray(1.5, jnp.float32),
        JaxConfig(shape=(5, 4, 4), nll_loss_type=loss_type))
    _, got = vae_loss(
        torch.from_numpy(x), torch.from_numpy(r),
        DiagonalGaussian(torch.from_numpy(mean), torch.from_numpy(logvar)),
        torch.tensor(1.5),
        VAEConfig(shape=(5, 4, 4), nll_loss_type=loss_type))
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=1e-5)


def test_gaussian_matches_jax():
    rng = np.random.default_rng(6)
    p = (3 * rng.standard_normal((2, 3, 3, 8))).astype(np.float32)
    p[0, 0, 0, 4:] = [100.0, -100.0, 0.5, -0.5]
    s = rng.standard_normal((2, 3, 3, 4)).astype(np.float32)
    jg = JaxGaussian.from_params(jnp.asarray(p))
    tg = DiagonalGaussian.from_params(torch.from_numpy(p))
    assert float(tg.logvar.max()) == 20.0 and float(tg.logvar.min()) == -30.0
    np.testing.assert_allclose(tg.kl().numpy(), np.asarray(jg.kl()),
                               rtol=1e-5)
    np.testing.assert_allclose(tg.nll(torch.from_numpy(s)).numpy(),
                               np.asarray(jg.nll(jnp.asarray(s))), rtol=1e-5)


def test_dropout_block_matches_when_deterministic():
    """dropout_prob > 0 moves conv2 to net2.3; deterministic forwards still
    match JAX, and a non-deterministic forward takes the unfused path."""
    cfg = dict(TINY, dropout_prob=0.2)
    jcfg = JaxConfig(**cfg)
    jm = JaxVAE(jcfg)
    x = np.random.default_rng(8).standard_normal((1, 16, 16, 12)).astype(
        np.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                     rng=jax.random.PRNGKey(1))["params"]
    params = jax.tree_util.tree_map(lambda p: np.asarray(p) + 0.05, params)
    port = AutoencoderKL(VAEConfig(**cfg), device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params, dropout=True))
    want = jm.apply({"params": params}, jnp.asarray(x),
                    method=JaxVAE.encode).mean
    with torch.no_grad():
        got = port.encode(torch.from_numpy(x)).mean
        noisy = port.encode(torch.from_numpy(x), deterministic=False).mean
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert noisy.shape == got.shape and not torch.equal(noisy, got)


def test_padded_config_is_the_unpadded_model():
    """pad_boundary is accepted and ignored: same parameters, same output."""
    a = AutoencoderKL(VAEConfig(**PADDED), device="cpu", seed=1)
    b = AutoencoderKL(VAEConfig(**dict(PADDED, pad_boundary=False)),
                      device="cpu", seed=1)
    x = torch.randn(1, 8, 8, 260, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert torch.equal(a.encode(x).mean, b.encode(x).mean)
    assert dataclasses.replace(a.config, pad_boundary=False) == b.config
