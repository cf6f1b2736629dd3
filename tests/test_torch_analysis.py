"""The port's PCA (tempo_tpu_torch/analysis/pca.py), probes
(analysis/probes.py, interop/jax_params.py probe_state_dict_from_jax),
figures (utils/figures.py) and GranuleCodec with the device normalize
against the JAX package's, on the CPU at fp32.

Tolerances: the PCA is the JAX package's numpy code (bitwise), and numpy's
eigen-decomposition of the covariance gives its explained variance within
rel 1e-4; a probe's forward, its weighted batch loss and one AdamW step
against optax.adamw from the same parameters and batch within 1e-6 (fp32
matmuls in another order); train_probe is held by its outcome, as the JAX
package's tests hold its own (its permutations come from another
generator). The codec's latents and reconstructions of the same
normalized crop within 1e-4 abs (fp32, two implementations of ~30
layers); its crop by the device-normalize rule of test_torch_granule.py.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tempo_tpu.analysis import pca as jax_pca
from tempo_tpu.analysis import probes as jax_probes
from tempo_tpu.data.normalize import normalize_radiance as jax_normalize
from tempo_tpu.infer.granule_codec import GranuleCodec as JaxCodec
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu_torch.analysis import pca, probes
from tempo_tpu_torch.infer.granule_codec import GranuleCodec
from tempo_tpu_torch.interop.jax_params import (probe_state_dict_from_jax,
                                                state_dict_from_jax_params)
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.utils import figures

torch.set_num_threads(1)

PROBE_TOL = dict(rtol=1e-6, atol=1e-6)
TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")


def test_pca_is_jax_s_and_numpy_eigh_s():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 12))
    x[:, 3] += 5 * x[:, 0]
    got, want = pca.fit_pca(x, 3), jax_pca.fit_pca(x, 3)
    for k in ("components", "mean", "explained_variance",
              "explained_variance_ratio"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert got.n_samples == want.n_samples == 300
    evals = np.linalg.eigh(np.cov(x, rowvar=False))[0][::-1][:3]
    np.testing.assert_allclose(got.explained_variance, evals, rtol=1e-4)
    np.testing.assert_array_equal(got.transform(x[:10]),
                                  want.transform(x[:10]))


def test_pca_save_load_and_pca_rgb(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.standard_normal((16, 20, 6)).astype(np.float32)
    fit = pca.fit_pca(img.reshape(-1, 6), 3)
    fit.save(tmp_path / "pca.npz")
    loaded = jax_pca.PCAResult.load(tmp_path / "pca.npz")
    np.testing.assert_array_equal(loaded.components, fit.components)
    again = pca.PCAResult.load(tmp_path / "pca.npz")
    np.testing.assert_array_equal(again.mean, fit.mean)
    recon = img + 0.1 * rng.standard_normal(img.shape).astype(np.float32)
    for ref in (None, img):
        got = pca.pca_rgb(recon, fit, reference_hwc=ref)
        np.testing.assert_array_equal(got, jax_pca.pca_rgb(
            recon, fit, reference_hwc=ref))
        assert got.shape == (16, 20, 3) and 0 <= got.min() <= got.max() <= 1


def test_r2_matches_jax():
    rng = np.random.default_rng(2)
    y = rng.standard_normal(100)
    pred = y + 0.3 * rng.standard_normal(100)
    assert probes.r2_score(y, pred) == jax_probes.r2_score(y, pred)


def _jax_probe(dims_hidden, seed=0, input_dim=8):
    params = jax_probes.init_probe_params(jax.random.PRNGKey(seed),
                                          input_dim, dims_hidden)
    params = jax.tree_util.tree_map(np.asarray, params)
    port = probes.Probe([input_dim, *dims_hidden, 1], device="cpu")
    port.load_state_dict(probe_state_dict_from_jax(params))
    return params, port


@pytest.mark.parametrize("hidden,act", [((), "relu"), ((16, 8), "relu"),
                                        ((16,), "gelu"), ((16,), "tanh")])
def test_probe_forward_matches_jax(hidden, act):
    params, port = _jax_probe(hidden)
    x = np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32)
    want = jax_probes.probe_apply(jax.tree_util.tree_map(jnp.asarray, params),
                                  jnp.asarray(x), act=act)
    with torch.no_grad():
        got = probes.probe_apply(port, torch.from_numpy(x), act=act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PROBE_TOL)
    result = jax_probes.ProbeResult(params, [], [], 0, 0.0, "mlp",
                                    activation=act)
    ours = probes.ProbeResult(probes.probe_params(port), [], [], 0, 0.0,
                              "mlp", activation=act)
    np.testing.assert_allclose(ours.predict(x), result.predict(x),
                               **PROBE_TOL)


def test_probe_loss_and_one_adamw_step_match_optax():
    """The weighted batch loss (padded rows at weight 0), its gradients and
    three AdamW steps from the same parameters, batch and weights."""
    params, port = _jax_probe((16,), seed=4)
    rng = np.random.default_rng(5)
    xb = rng.standard_normal((32, 8)).astype(np.float32)
    yb = rng.standard_normal(32).astype(np.float32)
    wb = (np.arange(32) < 27).astype(np.float32)

    def jax_loss(p):
        pred = jax_probes.probe_apply(p, xb).squeeze(-1)
        return jnp.sum(wb * jnp.square(pred - yb)) / jnp.maximum(
            jnp.sum(wb), 1.0)

    tx = optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jp)
    opt = torch.optim.AdamW(port.parameters(), lr=1e-2, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=0.01)
    for _ in range(3):
        want_loss, grads = jax.value_and_grad(jax_loss)(jp)
        updates, state = tx.update(grads, state, jp)
        jp = optax.apply_updates(jp, updates)
        loss = probes.weighted_mse(port(torch.from_numpy(xb)).squeeze(-1),
                                   torch.from_numpy(yb), torch.from_numpy(wb))
        opt.zero_grad()
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   **PROBE_TOL)
        np.testing.assert_allclose(port.layers[0].weight.grad.numpy().T,
                                   np.asarray(grads[0]["kernel"]),
                                   **PROBE_TOL)
        opt.step()
        for got, exp in zip(probes.probe_params(port), jp):
            np.testing.assert_allclose(got["kernel"], np.asarray(exp["kernel"]),
                                       **PROBE_TOL)
            np.testing.assert_allclose(got["bias"], np.asarray(exp["bias"]),
                                       **PROBE_TOL)


def test_linear_probe_recovers_linear_map():
    rng = np.random.default_rng(0)
    w_true = rng.standard_normal(8).astype(np.float32)
    X = rng.standard_normal((2000, 8)).astype(np.float32)
    y = X @ w_true + 0.01 * rng.standard_normal(2000).astype(np.float32)
    result = probes.train_probe(X[:1600], y[:1600], X[1600:], y[1600:], {
        "architecture": "linear", "learning_rate": 1e-2,
        "weight_decay": 0.0, "batch_size": 256, "max_epochs": 200,
    }, device="cpu")
    assert probes.r2_score(y[1600:], result.predict(X[1600:])) > 0.98
    assert len(result.train_losses) == len(result.val_losses) == 200
    assert result.best_val_loss == min(result.val_losses) \
        <= result.val_losses[0]
    assert result.val_losses[result.best_epoch] == result.best_val_loss


def test_mlp_probe_learns_nonlinear_and_saves_the_jax_layout(tmp_path):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2000, 4)).astype(np.float32)
    y = (np.sin(X[:, 0]) + X[:, 1] ** 2).astype(np.float32)
    result = probes.train_probe(X[:1600], y[:1600], X[1600:], y[1600:], {
        "architecture": "mlp", "hidden_dims": [64, 64], "dropout": 0.1,
        "activation": "relu", "learning_rate": 3e-3, "weight_decay": 0.0,
        "batch_size": 256, "max_epochs": 300,
    }, device="cpu")
    assert probes.r2_score(y[1600:], result.predict(X[1600:])) > 0.9
    result.save(tmp_path / "p.npz")
    got = np.load(tmp_path / "p.npz")
    assert sorted(got.files) == sorted(
        ["n_layers", "architecture", "activation", "kernel_0", "bias_0",
         "kernel_1", "bias_1", "kernel_2", "bias_2"])
    assert got["kernel_0"].shape == (4, 64) and int(got["n_layers"]) == 3
    again = jax_probes.ProbeResult(
        [{"kernel": got[f"kernel_{i}"], "bias": got[f"bias_{i}"]}
         for i in range(3)], [], [], 0, 0.0, "mlp")
    np.testing.assert_allclose(again.predict(X[:50]), result.predict(X[:50]),
                               **PROBE_TOL)


def test_probe_init_is_seeded_and_in_torch_s_bounds():
    a = probes.init_probe_params(8, (16,), seed=3, device="cpu")
    b = probes.init_probe_params(8, (16,), seed=3, device="cpu")
    assert all(torch.equal(p, q) for p, q in zip(a.parameters(),
                                                 b.parameters()))
    assert float(a.layers[0].weight.detach().abs().max()) <= 8 ** -0.5
    assert float(a.layers[1].weight.detach().abs().max()) <= 16 ** -0.5


@pytest.mark.parametrize("hide", [False, True])
def test_figures_write_their_files(tmp_path, monkeypatch, hide):
    """Every panel filler draws and ``finish`` writes the file, with
    matplotlib and without it (train/png.py's panels)."""
    if hide:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(0)
    fig, axes = figures.new_grid(2, 3)
    assert axes.shape == (2, 3)
    assert isinstance(axes[0, 0], figures.PngAxes) == hide
    figures.curve_panel(axes[0, 0], [1, 2, 3], {"a": [3, 2, 1],
                                                "b": [1, 2, 4]},
                        log_x=True, log_y=True)
    figures.mark_point(axes[0, 0], 2, 2, "best")
    figures.vline(axes[0, 0], 2, "v")
    figures.hist_panel(axes[0, 1], rng.standard_normal(500))
    figures.stats_box(axes[0, 1], rng.standard_normal(10), count=True)
    figures.overlay_hists(axes[0, 2], {"x": rng.standard_normal(100),
                                       "y": rng.standard_normal(100) + 1})
    figures.image_panel(axes[1, 0], rng.random((8, 12)), "img", "viridis",
                        colorbar=True)
    figures.scatter_panel(axes[1, 1], rng.random(50), rng.random(50))
    figures.annotated_bars(axes[1, 2], ["a", "b"], [0.3, -0.1], ylim=(0, 1))
    path = figures.finish(fig, tmp_path / "sub" / "f.png", suptitle="t")
    assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert figures.finite_range([np.nan, 1, 3]) == (1.0, 3.0)
    assert figures.finite_range([np.nan]) == (0.0, 1.0)
    assert figures.product_color(5) == "tab:blue"


@pytest.fixture(scope="module")
def codecs():
    jm = JaxVAE(JaxConfig(**TINY))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 12)),
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    port = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    port.load_state_dict(state_dict_from_jax_params(params))
    return (JaxCodec(jm, params, multiple=16),
            GranuleCodec(port, multiple=16, device="cpu"))


def test_codec_normalizes_on_its_device_as_jax(codecs):
    """The granule's own stats (no spectra given): the crop by the rule,
    then the latent, a decode and a reconstruction of the device tensor
    against JAX's of its numpy crop."""
    jc, pc = codecs
    rad = np.exp(np.random.default_rng(7).normal(3.0, 1.0, (37, 70, 12))
                 ).astype(np.float32)
    want = jc.normalize(rad)
    gt = pc.normalize_tensor(rad)
    assert isinstance(gt, torch.Tensor) and gt.is_contiguous()
    z64 = np.log(np.clip(rad.astype(np.float64), 1.0, None))
    z64 = np.clip((z64 - z64.mean((0, 1))) / (z64.std((0, 1)) + 1e-8),
                  -10, 10)[:32, :64]
    got = gt.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(want, jax_normalize(rad)[:32, :64])
    assert np.abs(got - z64).max() <= np.abs(want - z64).max() + 1e-5
    np.testing.assert_array_equal(pc.normalize(rad), got)
    jlat = np.asarray(jc.encode(want))
    lat = pc.encode(gt)
    np.testing.assert_allclose(lat.numpy(), jlat, atol=1e-4, rtol=0)
    np.testing.assert_allclose(pc.decode_tensor(lat).numpy(),
                               jc.decode(jlat), atol=1e-4, rtol=0)
    gt_host, recon = pc.reconstruct_raw(rad, sample_posterior=False)
    np.testing.assert_array_equal(gt_host, got)
    np.testing.assert_allclose(recon, jc.reconstruct(want,
                                                     sample_posterior=False),
                               atol=1e-4, rtol=0)
