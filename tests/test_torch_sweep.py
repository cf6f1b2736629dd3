"""The port's power spectra (tempo_tpu_torch/analysis/spectrum.py), its
checkpoint sweep (infer/sweep.py) and its params-only loader
(train/checkpoint.py load_params) against the JAX package's, on the CPU
at fp32.

Tolerances: the binning operator is built by the same numpy code (1e-6);
get_pk and pk_rescale differ from JAX's FFT in fp32 rounding (rel 1e-4);
compute_metrics on numpy is JAX's float64 code (bitwise) and on tensors
another float64 summation order (rel 1e-9). The sweep compares two fp32
models with the same weights: the posterior's logvar half of the quant
conv is pinned (weight 0, bias -30, the clamp's floor in both packages),
so std ~3e-7 and the sampled latent is the mean to fp32 whatever the two
random streams draw: every metric, pk_err included, within rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tempo_tpu.analysis import spectrum as jax_spectrum
from tempo_tpu.infer import sweep as jax_sweep
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.train.checkpoint import _write_payload
from tempo_tpu_torch.analysis import spectrum
from tempo_tpu_torch.infer import sweep
from tempo_tpu_torch.interop.jax_params import (l2_state_dict_from_jax,
                                                state_dict_from_jax_params)
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head
from tempo_tpu_torch.train.checkpoint import (list_checkpoints, load_params,
                                              save_checkpoint)
from tempo_tpu_torch.train.state import create_train_state, make_optimizer

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
SWEEP_REL = 1e-4
FFT_TOL = dict(rtol=1e-4, atol=1e-5)


def pinned_jax_params(seed):
    """Perturbed JAX params of the TINY VAE with the posterior's logvar
    pinned at the clamp's floor."""
    jm = JaxVAE(JaxConfig(**TINY))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 12)),
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    e = TINY["embed_dim"]
    params["quant_conv"]["kernel"][:, e:] = 0.0
    params["quant_conv"]["bias"][e:] = -30.0
    return jm, params


def save_both(jax_dir, port_dir, step, params):
    """The same params as a JAX .msgpack (its own writer) and as a port
    checkpoint (save_checkpoint of a state over the carried weights)."""
    _write_payload(jax_dir, {"step": step,
                             "params": serialization.to_state_dict(params)})
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    model.load_state_dict(state_dict_from_jax_params(params))
    state = create_train_state(model, make_optimizer())
    state.step = step
    return save_checkpoint(port_dir, state)


@pytest.mark.parametrize("n,dim", [(16, 2), (8, 3)])
def test_pk_op_matches_jax(n, dim):
    op, want = spectrum.pk_op(n, dim, device="cpu"), jax_spectrum.pk_op(n, dim)
    for got, exp in ((op.ks, want.ks), (op.weight, want.weight),
                     (op.member, want.member)):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), rtol=1e-6,
                                   atol=1e-7)
    assert (op.n, op.dim) == (want.n, want.dim)
    with pytest.raises(ValueError, match="even"):
        spectrum.pk_op(7, 2, device="cpu")


@pytest.mark.parametrize("n,dim", [(16, 2), (8, 3)])
def test_get_pk_matches_jax(n, dim):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + (n,) * dim + (3,)).astype(np.float32)
    got = spectrum.get_pk(torch.from_numpy(x),
                          spectrum.pk_op(n, dim, device="cpu"))
    want = jax_spectrum.get_pk(jnp.asarray(x), jax_spectrum.pk_op(n, dim))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FFT_TOL)


def test_pk_rescale_matches_jax_and_hits_the_target():
    n = 16
    x = np.random.default_rng(1).standard_normal((2, n, n, 3)).astype(
        np.float32)
    op = spectrum.pk_op(n, 2, device="cpu")
    xt = torch.from_numpy(x)
    pks = spectrum.get_pk(xt, op)
    got = spectrum.pk_rescale(xt, pks, pks * 4.0, op)
    jop = jax_spectrum.pk_op(n, 2)
    jpks = jax_spectrum.get_pk(jnp.asarray(x), jop)
    want = jax_spectrum.pk_rescale(jnp.asarray(x), jpks, jpks * 4.0, jop)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-3,
                               atol=2e-4)
    # channel 0 carries the zeroed factor row; channels 1-2, bins >= 1
    ratio = spectrum.get_pk(got, op)[:, 1:, 1:] / pks[:, 1:, 1:]
    np.testing.assert_allclose(ratio.numpy(), 4.0, rtol=1e-3)
    with pytest.raises(NotImplementedError):
        spectrum.pk_rescale(xt, pks, pks, spectrum.pk_op(8, 3, device="cpu"))


def test_compute_metrics_numpy_and_tensor():
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    recon = (gt + 0.1 * rng.standard_normal(gt.shape)).astype(np.float32)
    names = ["mse", "mae", "psnr"]
    got = sweep.compute_metrics(gt, recon, names)
    assert got == jax_sweep.compute_metrics(gt, recon, names)
    on_tensors = sweep.compute_metrics(torch.from_numpy(gt),
                                       torch.from_numpy(recon), names)
    assert on_tensors.keys() == got.keys()
    for k in got:
        np.testing.assert_allclose(on_tensors[k], got[k], rtol=1e-9)
    assert sweep.PSNR_MAX_VAL == jax_sweep.PSNR_MAX_VAL == 20.0


@pytest.mark.parametrize("n_tiles", [6, 8])
def test_evaluate_checkpoints_matches_jax(tmp_path, n_tiles):
    """Two checkpoints, six tiles at batch 4 (a padded tail) or eight
    (whole batches): the same metrics, pk_err included."""
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    template = None
    for step, seed in ((20, 2), (10, 1)):
        jm, params = pinned_jax_params(seed)
        template = template or params
        save_both(jax_dir, port_dir, step, params)
    tiles = np.random.default_rng(3).standard_normal(
        (n_tiles, 16, 16, 12)).astype(np.float32)
    names = ["mse", "mae", "psnr", "pk_err"]
    want = jax_sweep.evaluate_checkpoints(jm, template, jax_dir, tiles,
                                          batch_size=4, metrics_list=names,
                                          verbose=False)
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    got = sweep.evaluate_checkpoints(model, port_dir, tiles, batch_size=4,
                                     metrics_list=names, verbose=False)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [10, 20]
    assert [r["checkpoint"] for r in got] == [
        "ckpt_step=000010.pt", "ckpt_step=000020.pt"]
    for g, w in zip(got, want):
        for k in names:
            np.testing.assert_allclose(g[k], w[k], rtol=SWEEP_REL)
    assert got[0]["mse"] != got[1]["mse"]
    with pytest.raises(ValueError, match="no checkpoints"):
        sweep.evaluate_checkpoints(model, tmp_path / "none", tiles)


def test_load_params_formats(tmp_path):
    """The port's checkpoints of both models, a bare reference state dict
    and the reference trainer schema load strictly; an L2 checkpoint gives
    a base VAE its ``vae.*``; the JAX package's .msgpack files give the
    same weights (an L2 one its ``vae`` half to a base VAE); sharded
    directories are refused, naming the work that would take them."""
    _, params = pinned_jax_params(4)
    sd = state_dict_from_jax_params(params)
    base = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    base.load_state_dict(sd)
    path = save_checkpoint(tmp_path / "base", create_train_state(
        base, make_optimizer()))

    def fresh():
        return AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=9)

    def same(model, want):
        got = model.state_dict()
        return got.keys() == want.keys() and all(
            torch.equal(got[k], want[k]) for k in want)

    assert same(load_params(path, fresh()), sd)
    torch.save(sd, tmp_path / "bare.pt")
    assert same(load_params(tmp_path / "bare.pt", fresh()), sd)
    torch.save({"model_state_dict": sd, "epoch": 3}, tmp_path / "ref.pt")
    assert same(load_params(tmp_path / "ref.pt", fresh()), sd)

    l2 = VAEWithL2Head(VAEConfig(**TINY), (16, 16), device="cpu")
    l2_sd = {**{f"vae.{k}": v for k, v in sd.items()},
             **{k: v for k, v in l2.state_dict().items()
                if k.startswith("l2_head.")}}
    l2.load_state_dict(l2_sd)
    l2_path = save_checkpoint(tmp_path / "l2", create_train_state(
        l2, make_optimizer()))
    assert same(load_params(l2_path, fresh()), sd)
    assert same(load_params(l2_path, VAEWithL2Head(
        VAEConfig(**TINY), (16, 16), device="cpu", seed=5)), l2_sd)

    (tmp_path / "jax").mkdir()
    _write_payload(tmp_path / "jax", {
        "step": 1, "params": serialization.to_state_dict(params)})
    assert same(load_params(tmp_path / "jax" / "ckpt_step=000001.msgpack",
                            fresh()), sd)
    head = {"dense0_kernel": np.ones((4, 16), np.float32),
            "norm0": {"scale": np.ones(16, np.float32),
                      "bias": np.zeros(16, np.float32)},
            "out_kernel": np.ones((16, 4), np.float32),
            "out_bias": np.zeros(4, np.float32)}
    _write_payload(tmp_path / "jax", {"step": 2, "params": {
        "vae": serialization.to_state_dict(params), "l2_head": head}})
    mp_l2 = tmp_path / "jax" / "ckpt_step=000002.msgpack"
    assert same(load_params(mp_l2, fresh()), sd)
    l2_jax = load_params(mp_l2, VAEWithL2Head(VAEConfig(**TINY), (16,),
                                              device="cpu", seed=5))
    assert same(l2_jax, l2_state_dict_from_jax(
        {"vae": params, "l2_head": head}, (16,)))
    # a sharded directory loads (the L2 state's, its vae half into the
    # base VAE); one without an index.json is no checkpoint
    from tempo_tpu_torch.train.sharded_checkpoint import (
        save_checkpoint_sharded)

    shards = save_checkpoint_sharded(tmp_path / "sharded",
                                     create_train_state(l2, make_optimizer()))
    assert same(load_params(shards, fresh()), sd)
    assert same(load_params(shards, VAEWithL2Head(
        VAEConfig(**TINY), (16, 16), device="cpu", seed=5)), l2_sd)
    (tmp_path / "ckpt_step=000002.sharded").mkdir()
    with pytest.raises(FileNotFoundError, match="index.json"):
        load_params(tmp_path / "ckpt_step=000002.sharded", fresh())
    with pytest.raises(RuntimeError, match="in loading state_dict"):
        load_params(tmp_path / "bare.pt", AutoencoderKL(
            VAEConfig(**dict(TINY, chs=(16, 12))), device="cpu"))


def test_l2_checkpoint_carried_from_jax_loads_into_a_base_vae(tmp_path):
    """An L2 state dict carried from JAX params (l2_state_dict_from_jax)
    gives the base VAE JAX's ``vae`` subtree."""
    _, params = pinned_jax_params(6)
    head = {"dense0_kernel": np.zeros((4, 16), np.float32),
            "norm0": {"scale": np.ones(16, np.float32),
                      "bias": np.zeros(16, np.float32)},
            "out_kernel": np.zeros((16, 4), np.float32),
            "out_bias": np.zeros(4, np.float32)}
    torch.save(l2_state_dict_from_jax({"vae": params, "l2_head": head},
                                      (16,)), tmp_path / "ckpt_step=000005.pt")
    model = load_params(tmp_path / "ckpt_step=000005.pt",
                        AutoencoderKL(VAEConfig(**TINY), device="cpu"))
    want = state_dict_from_jax_params(params)
    assert all(torch.equal(model.state_dict()[k], want[k]) for k in want)


def test_list_checkpoints_sorts_both_kinds_by_step(tmp_path):
    for name in ("ckpt_step=000100.pt", "ckpt_step=000020.pt",
                 "ckpt_step=000003.pt", "other.pt", "ckpt_step=000050.tmp"):
        (tmp_path / name).write_bytes(b"")
    assert [p.name for p in list_checkpoints(tmp_path)] == [
        "ckpt_step=000003.pt", "ckpt_step=000020.pt", "ckpt_step=000100.pt"]
