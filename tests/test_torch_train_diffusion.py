"""The diffusion slice of the port on the CPU: one latent-VDM update (a
tiny frozen VAE from JAX params encodes a batch, the VDM loss, its
gradients and one AdamW step with the same draws) against the JAX
package's fused step, and the two CLIs (cli/train_diffusion.py,
cli/sample_diffusion.py) mirroring tests/test_e2e.py's diffusion cases at
a tiny size: latent VDM, pixel-space VDM with DDIM sampling, latent SFM.
They write the files the JAX CLIs write, with the same training_info.yaml
and sampling_info.yaml keys; dropout never drops in training; the frozen
VAE's parameters are unchanged and stay out of the checkpoints; a step
from a reloaded checkpoint equals the live one; the async checkpoints are
the sync ones and a JAX .msgpack serves as the frozen VAE; the unported
options raise; the entry points default to CUDA.

Tolerances: fp32 on both sides, sum order only: the loss and its terms
rtol 1e-4; each gradient within 1e-4 relative L2 (the attention's key
bias, whose exact gradient is 0, only bounded). The first AdamW update
moves an element by lr g / (|g| + eps), about lr whatever |g| is, so an
element whose gradient is rounding-sized (both sides hold noise there)
moves by a sign set by that noise: each parameter's update is held within
1e-4 relative L2 over the elements whose gradient exceeds 1e-3 of the
tensor's largest, and every element within 2 lr of JAX's."""

from __future__ import annotations

import copy

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from tempo_tpu.interop.torch_ckpt import params_from_torch_state_dict
from tempo_tpu.interop.unet_ckpt import params_from_torch_vdm
from tempo_tpu.models import diffusion as jd
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.nn.unet import CUNet as JaxCUNet
from tempo_tpu.train import checkpoint as jckpt
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.cli import sample_diffusion, train_diffusion
from tempo_tpu_torch.data.synthetic import make_tile_shards
from tempo_tpu_torch.interop.jax_params import (state_dict_from_jax_params,
                                                vdm_state_dict_from_jax)
from tempo_tpu_torch.models import diffusion as pd
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.nn.unet import CUNet
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep
from tempo_tpu_torch.train.checkpoint import save_checkpoint
from tempo_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

REL = 1e-4
TILE, N_SPECTRAL = 16, 4
# a 2-level VAE: 16x16x4 tiles -> 8x8x4 latents
VAE_CFG = {"shape": [N_SPECTRAL, TILE, TILE], "chs": [16, 12],
           "z_channels": 4, "embed_dim": 4, "n_attention_heads": 2,
           "norm_groups": 4, "compute_dtype": "float32"}
SCORE = {"chs": [8, 12], "norm_groups": 4, "n_attention_heads": 2,
         "t_embedding_dim": 8}
INFO_KEYS = {"seed", "family", "n_devices", "n_params", "latent_space",
             "model_shape", "training_time", "samples_per_sec"}
SAMPLING_KEYS = {"checkpoint", "family", "n_samples", "n_steps", "seed",
                 "method", "eta", "sample_shape"}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nudge(module, scale=0.05, seed=7):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


@pytest.fixture(scope="module")
def tiles_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiles")
    make_tile_shards(root / "train", n_files=3, tiles_per_file=8, tile=TILE,
                     n_spectral=N_SPECTRAL, seed=1)
    make_tile_shards(root / "val", n_files=1, tiles_per_file=8, tile=TILE,
                     n_spectral=N_SPECTRAL, seed=2)
    return root


@pytest.fixture(scope="module")
def vae_ckpt(tmp_path_factory):
    """A .pt of the port's train_vae format holding a tiny VAE."""
    vae = _nudge(AutoencoderKL(VAEConfig.from_dict(VAE_CFG), device="cpu",
                               seed=5))
    tx = pstate.make_optimizer()
    return save_checkpoint(tmp_path_factory.mktemp("vae") / "checkpoints",
                           pstate.create_train_state(vae, tx))


# ------------------------------------------------- one step against JAX

def test_latent_vdm_step_matches_jax(monkeypatch, tmp_path):
    """A frozen VAE (JAX params through state_dict_from_jax_params) encodes
    the batch with JAX's posterior draw, then the VDM loss with JAX's
    times and noises: the loss, its terms and the score model's gradients,
    then one step of the recipe (global-norm clip at 1.0, AdamW lr 1e-3,
    weight decay 0.05) against tempo_tpu's make_train_step(
    diffusion_loss_fn(model, encode_fn))."""
    # the frozen VAE: JAX params (a seeded port VAE through the JAX
    # package's reader, tempo_tpu/interop/torch_ckpt.py) into the port
    # through state_dict_from_jax_params
    jvae = JaxVAE(JaxConfig(**dict(VAE_CFG, shape=tuple(VAE_CFG["shape"]),
                                   chs=tuple(VAE_CFG["chs"]))))
    seeded_vae = _nudge(AutoencoderKL(VAEConfig.from_dict(VAE_CFG),
                                      device="cpu", seed=2))
    vae_params = params_from_torch_state_dict(seeded_vae.state_dict(),
                                              n_levels=2)
    port_vae = AutoencoderKL(VAEConfig.from_dict(VAE_CFG), device="cpu")
    port_vae.load_state_dict(state_dict_from_jax_params(vae_params))
    for k, v in seeded_vae.state_dict().items():
        assert torch.equal(port_vae.state_dict()[k], v), k
    ckpt = tmp_path / "vae.pt"
    torch.save({"model": port_vae.state_dict()}, ckpt)
    encode_fn, _, z_shape, vae = train_diffusion._build_codec(
        {"vae_checkpoint": str(ckpt), "vae_model": VAE_CFG},
        (2, TILE, TILE, N_SPECTRAL), torch.device("cpu"))
    assert z_shape == (2, 8, 8, 4)
    assert not any(p.requires_grad for p in vae.parameters())

    # the VDM: the port's weights through the JAX package's reader
    shape = z_shape[1:]
    kw = dict(chs=tuple(SCORE["chs"]), norm_groups=4, n_attention_heads=2,
              dropout_prob=0.0, t_conditioning=True, t_embedding_dim=8)
    seeded = _nudge(pd.VDM(CUNet(shape=shape, device="cpu", **kw)))
    params = params_from_torch_vdm(seeded.state_dict(), n_levels=2)
    port = pd.VDM(CUNet(shape=shape, device="cpu", seed=3, **kw))
    port.load_state_dict(vdm_state_dict_from_jax(params))
    jm = jd.VDM(JaxCUNet(shape=shape, **kw))

    def jax_encode(x, key):
        post = jvae.apply({"params": vae_params}, x, method=JaxVAE.encode)
        return post.sample(key)

    x = np.random.default_rng(4).standard_normal(
        (2, TILE, TILE, N_SPECTRAL)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    j_loss_fn = jstep.diffusion_loss_fn(jm, jax_encode)
    j_tx = jstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    j_state = jstate.create_train_state(params, j_tx, key)
    step_key = jax.random.fold_in(key, 0)
    (want_loss, want_m), want_g = jax.jit(jax.value_and_grad(
        lambda p: j_loss_fn(p, jnp.asarray(x), step_key), has_aux=True))(
        params)
    j_state, j_metrics = jstep.make_train_step(j_loss_fn, j_tx,
                                               donate=False)(
        j_state, jnp.asarray(x))

    # the draws JAX's step made: the posterior's, then get_loss's
    loss_key, enc_key = jax.random.split(step_key)
    post_noise = np.array(jax.random.normal(enc_key, z_shape))
    k_times, k_noise, k_noise0 = jax.random.split(loss_key, 3)
    times = np.array(jax.random.uniform(k_times, (), maxval=0.5)
                     + jnp.arange(2) / 2)
    noise = np.array(jax.random.normal(k_noise, z_shape, jnp.float32))
    noise_0 = np.array(jax.random.normal(k_noise0, z_shape, jnp.float32))
    monkeypatch.setattr(
        DiagonalGaussian, "sample",
        lambda self, generator=None: self.mean + self.std * torch.from_numpy(
            post_noise))
    get_loss = pd.VDM.get_loss

    def fed_get_loss(self, z, generator=None, **kw):
        return get_loss(self, z, generator, noise=torch.from_numpy(noise),
                        times=torch.from_numpy(times),
                        noise_0=torch.from_numpy(noise_0), **kw)

    monkeypatch.setattr(pd.VDM, "get_loss", fed_get_loss)

    vae_before = {k: v.clone() for k, v in vae.state_dict().items()}
    loss_fn = pstep.diffusion_loss_fn(port, encode_fn)
    loss, metrics = loss_fn(port, torch.from_numpy(x), torch.Generator())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=REL)
    assert set(metrics) == set(want_m)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=REL, err_msg=k)
    want_sd = vdm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             want_g))
    for k, p in port.named_parameters():
        if k.endswith("mid_attn1.k.bias"):
            assert p.grad.abs().max() <= 1e-6
            continue
        assert _rel_l2(p.grad, want_sd[k]) <= REL, k

    before = {k: v.clone() for k, v in port.state_dict().items()}
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = pstate.create_train_state(port, tx)
    _, metrics = pstep.make_train_step(loss_fn, tx)(state,
                                                    torch.from_numpy(x))
    for k in ("loss", "diffusion_loss", "latent_loss",
              "reconstruction_loss", "grad_norm"):
        np.testing.assert_allclose(metrics[k].item(), float(j_metrics[k]),
                                   rtol=REL, err_msg=k)
    want_after = vdm_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, j_state.params))
    for k, v in port.state_dict().items():
        step, want_step = v - before[k], want_after[k] - before[k]
        # the first AdamW move is lr g / (|g| + eps) (+ the decay): at most
        # lr an element, and set by rounding where |g| is rounding-sized
        assert (step - want_step).abs().max() <= 2.0e-3, k
        g = want_sd[k].abs()
        signal = g > 1e-3 * g.max()
        if k.endswith("mid_attn1.k.bias") or not signal.any():
            continue
        assert _rel_l2(step[signal], want_step[signal]) <= REL, k
    for k, v in vae.state_dict().items():
        assert torch.equal(v, vae_before[k]), k


# -------------------------------------------------------------- the CLIs

def _cfg(out: Path, tiles: Path, vae_ckpt=None, **extra) -> dict:
    cfg = {
        "output_dir": str(out),
        "seed": 1,
        "data": {"train_dir": str(tiles / "train"),
                 "val_dir": str(tiles / "val"), "batch_size": 8,
                 "min_buffer_size": 16, "val_min_buffer_size": 8},
        "score_model": dict(SCORE),
        "diffusion": {"noise_schedule": "fixed_linear", "gamma_min": -8.0,
                      "gamma_max": 4.0},
        "optimizer": {"lr": 1e-3},
        "training": {"n_steps": 10, "save_every": 5, "val_every": 5,
                     "log_every": 5, "plot_every": 5},
        "sampling": {"n_samples": 2, "n_steps": 4},
    }
    if vae_ckpt is not None:
        cfg["latent"] = {"vae_checkpoint": str(vae_ckpt),
                         "vae_model": dict(VAE_CFG)}
    for key, value in extra.items():
        cfg[key] = dict(cfg.get(key, {}), **value) if isinstance(
            value, dict) else value
    return cfg


def _yaml(path: Path) -> dict:
    return yaml.safe_load(path.read_text())


def _sample(tmp_path, run_dir, name, **extra):
    cfg = {"run_dir": str(run_dir), "output_dir": str(tmp_path / name),
           "n_samples": 2, "n_steps": 3, "seed": 3, **extra}
    info = sample_diffusion.run(cfg, device="cpu")
    s = np.load(tmp_path / name / "samples.npy")
    assert s.shape == (2, TILE, TILE, N_SPECTRAL) and np.isfinite(s).all()
    assert (tmp_path / name / "samples.png").exists()
    assert set(_yaml(tmp_path / name / "sampling_info.yaml")) == SAMPLING_KEYS
    return s, info


def test_train_and_sample_latent_vdm(monkeypatch, tmp_path, tiles_dir,
                                     vae_ckpt):
    """Latent VDM through the YAML entry point (dropout_prob 0.5: its
    modules exist, no call drops); the frozen VAE unchanged and absent from
    the checkpoint; a step from the reloaded checkpoint equals the live
    one; then sample_diffusion, also on a run without training_info."""
    drops = []
    dropout = torch.nn.functional.dropout
    monkeypatch.setattr(torch.nn.functional, "dropout",
                        lambda *a, **k: drops.append(1) or dropout(*a, **k))
    codecs = []
    build = train_diffusion._build_codec
    monkeypatch.setattr(train_diffusion, "_build_codec",
                        lambda *a: codecs.append(build(*a)) or codecs[-1])
    out = tmp_path / "run"
    cfg = _cfg(out, tiles_dir, vae_ckpt,
               score_model={"dropout_prob": 0.5})
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train_diffusion.main(str(path), device="cpu")
    assert drops == []

    metrics = json.loads((out / "metrics.json").read_text())
    assert set(metrics["train"][-1]) == {
        "step", "loss", "diffusion_loss", "latent_loss",
        "reconstruction_loss", "grad_norm"}
    assert all(np.isfinite(m["loss"]) for m in metrics["train"])
    assert [m["step"] for m in metrics["val"]] == [5, 10]
    ckpt = out / "checkpoints" / "ckpt_step=000010.pt"
    assert ckpt.exists()
    assert list((out / "figures").glob("reconstructions_step_*.png"))
    samples = np.load(out / "figures" / "samples_final.npy")
    assert samples.shape == (2, TILE, TILE, N_SPECTRAL)
    assert np.isfinite(samples).all()
    assert (out / "figures" / "samples_final.png").exists()
    info = _yaml(out / "training_info.yaml")
    assert set(info) == INFO_KEYS
    assert info["family"] == "vdm" and info["latent_space"]
    assert info["model_shape"] == [8, 8, 4] and info["n_devices"] == 1

    # the frozen VAE: unchanged, and nowhere in the trained state
    vae = codecs[0][3]
    saved = torch.load(vae_ckpt, weights_only=True)["model"]
    for k, v in vae.state_dict().items():
        assert torch.equal(v, saved[k]), k
    raw = torch.load(ckpt, weights_only=True)
    assert all(k.startswith(("score_model.", "gamma."))
               for k in raw["model"])
    model, _ = train_diffusion._build_generative(cfg, (8, 8, 4), "cpu")
    assert info["n_params"] == sum(p.numel() for p in model.parameters())

    # one more step from the reloaded checkpoint equals the live state's
    batch = torch.from_numpy(np.load(tiles_dir / "train" / "00000.npy"))
    encode_fn = codecs[0][0]

    def trainer_from(ckpt_path, seed):
        m, _ = train_diffusion._build_generative(cfg, (8, 8, 4), "cpu", seed)
        tx = pstate.make_optimizer_from_config(cfg["optimizer"], n_steps=10)
        t = Trainer(pstep.diffusion_loss_fn(m, encode_fn), tx,
                    pstate.create_train_state(m, tx, seed), tmp_path / "t",
                    device="cpu", verbose=False)
        t.load_checkpoint(ckpt_path)
        return t

    a, b = trainer_from(ckpt, 0), trainer_from(ckpt, 9)
    sa, _ = a.train_step(a.state, batch)
    sb, _ = b.train_step(b.state, batch)
    assert all(torch.equal(p, q) for p, q in zip(sa.model.parameters(),
                                                 sb.model.parameters()))

    anc, _ = _sample(tmp_path, out, "anc")
    (out / "training_info.yaml").unlink()  # a preempted run samples too
    again, info = _sample(tmp_path, out, "midrun")
    np.testing.assert_array_equal(again, anc)
    assert info["method"] == "euler" and info["family"] == "vdm"


def test_train_and_sample_pixel_vdm_ddim(tmp_path, tiles_dir):
    """Pixel-space VDM (no latent section, a learned schedule), then DDIM
    sampling through the sampling CLI (method override + eta)."""
    out = tmp_path / "run_px"
    cfg = _cfg(out, tiles_dir, diffusion={"noise_schedule": "learned_nn"},
               training={"n_steps": 5, "save_every": 5})
    _, _, info = train_diffusion.run(cfg, device="cpu")
    assert info["model_shape"] == [TILE, TILE, N_SPECTRAL]
    assert not info["latent_space"]
    assert (out / "checkpoints" / "ckpt_step=000005.pt").exists()
    assert set(json.loads((out / "config.yaml").read_text())) == set(cfg)
    anc, _ = _sample(tmp_path, out, "px")
    ddim, info = _sample(tmp_path, out, "ddim", method="ddim", eta=0.0)
    assert info["method"] == "ddim" and info["eta"] == 0.0
    assert np.abs(ddim - anc).max() > 1e-6


def test_train_and_sample_latent_sfm(tmp_path, tiles_dir, vae_ckpt):
    out = tmp_path / "run_flow"
    cfg = _cfg(out, tiles_dir, vae_ckpt, family="sfm",
               sampling={"method": "lm"})
    del cfg["diffusion"]
    _, _, info = train_diffusion.run(cfg, device="cpu")
    metrics = json.loads((out / "metrics.json").read_text())
    assert set(metrics["train"][-1]) == {"step", "loss", "grad_norm"}
    assert all(np.isfinite(m["loss"]) for m in metrics["train"])
    assert metrics["val"]
    assert info["family"] == "sfm" and info["latent_space"]
    assert not list((out / "figures").glob("reconstructions_step_*.png"))
    raw = torch.load(out / "checkpoints" / "ckpt_step=000010.pt",
                     weights_only=True)
    assert all(k.startswith("velocity_model.") for k in raw["model"])
    lm, info = _sample(tmp_path, out, "flow")
    assert info["family"] == "sfm" and info["method"] == "lm"
    euler, _ = _sample(tmp_path, out, "flow_euler", method="euler")
    assert np.abs(euler - lm).max() > 1e-6


def test_sample_diffusion_reads_a_jax_checkpoint(tmp_path, tiles_dir):
    """The run's weights as the JAX package writes them (a .msgpack of a
    later step): sample_diffusion takes it as the run's latest checkpoint
    and draws what it draws from the .pt of the same weights."""
    out = tmp_path / "run"
    trainer, _, _ = train_diffusion.run(_cfg(out, tiles_dir, training={
        "n_steps": 2, "save_every": 2, "val_every": 100,
        "plot_every": 100}, sampling={"n_steps": 2}), device="cpu")
    state = jstate.create_train_state(
        params_from_torch_vdm(trainer.state.model.state_dict(), n_levels=2),
        jstate.make_optimizer(), jax.random.PRNGKey(0))
    jckpt.save_checkpoint(out / "checkpoints",
                          state.replace(step=jnp.asarray(3, jnp.int32)))
    got, info = _sample(tmp_path, out, "from_msgpack")
    assert info["checkpoint"].endswith("ckpt_step=000003.msgpack")
    want, _ = _sample(tmp_path, out, "from_pt", checkpoint=str(
        out / "checkpoints" / "ckpt_step=000002.pt"))
    np.testing.assert_array_equal(got, want)


def test_unported_and_unknown_options_raise(tmp_path, tiles_dir, vae_ckpt,
                                           monkeypatch):
    """An unknown family raises; checkpoint_format: async writes, byte for
    byte, what a sync save of the run's last state writes (the loader's
    threads order batches freely, so two runs may differ), sharded writes
    .shards directories that load back; the JAX package's .msgpack of the
    VAE and a sharded directory serve as latent.vae_checkpoint (the
    frozen VAE gets its weights), a directory without an index.json does
    not."""
    with pytest.raises(ValueError, match="unknown family"):
        train_diffusion.run(_cfg(tmp_path / "fam", tiles_dir,
                                 family="ddpm"), device="cpu")
    short = {"n_steps": 2, "save_every": 1, "val_every": 2, "log_every": 1,
             "plot_every": 100}
    trainer, _, _ = train_diffusion.run(_cfg(
        tmp_path / "async", tiles_dir, training=dict(
            short, checkpoint_format="async")), device="cpu")
    assert trainer._async_ckpt is not None
    assert sorted(p.name for p in (tmp_path / "async" / "checkpoints")
                  .iterdir()) == ["ckpt_step=000001.pt", "ckpt_step=000002.pt"]
    resaved = save_checkpoint(tmp_path / "sync", trainer.state,
                              trainer.train_metrics, trainer.val_metrics)
    assert resaved.read_bytes() == (
        tmp_path / "async" / "checkpoints" / resaved.name).read_bytes()
    # sharded: ckpt_step=NNNNNN.shards directories, which load back
    from tempo_tpu_torch.train.checkpoint import load_params
    from tempo_tpu_torch.train.sharded_checkpoint import (
        save_checkpoint_sharded)

    sharded, _, _ = train_diffusion.run(_cfg(
        tmp_path / "sharded", tiles_dir, training=dict(
            short, checkpoint_format="sharded")), device="cpu")
    assert sorted(p.name for p in (tmp_path / "sharded" / "checkpoints")
                  .iterdir()) == ["ckpt_step=000001.shards",
                                  "ckpt_step=000002.shards"]
    last = sharded.state.model.state_dict()
    again = load_params(tmp_path / "sharded" / "checkpoints" /
                        "ckpt_step=000002.shards", copy.deepcopy(
                            sharded.state.model))
    assert all(torch.equal(again.state_dict()[k], v) for k, v in last.items())

    saved = torch.load(vae_ckpt, weights_only=True)["model"]
    vae = AutoencoderKL(VAEConfig.from_dict(VAE_CFG), device="cpu")
    vae.load_state_dict(saved)
    msgpack = jckpt.save_checkpoint(
        tmp_path / "jax_vae", jstate.create_train_state(
            params_from_torch_state_dict(vae.state_dict(), n_levels=2),
            jstate.make_optimizer(), jax.random.PRNGKey(0)))
    codecs = []
    build = train_diffusion._build_codec
    monkeypatch.setattr(train_diffusion, "_build_codec",
                        lambda *a: codecs.append(build(*a)) or codecs[-1])
    train_diffusion.run(_cfg(tmp_path / "mp", tiles_dir, msgpack,
                             training=short), device="cpu")
    got = codecs[0][3].state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.items())
    # a sharded directory of the VAE serves as well; one without an
    # index.json does not
    from tempo_tpu_torch.train.state import create_train_state, make_optimizer

    vae_dir = save_checkpoint_sharded(tmp_path / "vae_shards",
                                      create_train_state(vae, make_optimizer()))
    codecs.clear()
    train_diffusion.run(_cfg(tmp_path / "sh_ok", tiles_dir, vae_dir,
                             training=short), device="cpu")
    got = codecs[0][3].state_dict()
    assert all(torch.equal(got[k], v) for k, v in saved.items())
    (tmp_path / "ckpt_step=000003.sharded").mkdir()
    with pytest.raises(FileNotFoundError, match="index.json"):
        train_diffusion.run(_cfg(tmp_path / "sh", tiles_dir,
                                 tmp_path / "ckpt_step=000003.sharded"),
                            device="cpu")
    with pytest.raises(ValueError, match="doesn't exist"):
        train_diffusion.run(_cfg(tmp_path / "missing", tiles_dir,
                                 tmp_path / "none.pt"), device="cpu")


def test_diffusion_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path, tiles_dir):
    """The two CLIs' run and main and the models resolve device None to
    CUDA and raise without it, before they write anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _cfg(tmp_path / "run", tiles_dir)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_diffusion.run(cfg)
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_diffusion.main(str(tmp_path / "cfg.yaml"))
    scfg = {"run_dir": str(tmp_path / "run"),
            "output_dir": str(tmp_path / "samples")}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_diffusion.run(scfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CUNet(shape=(8, 8, 3), chs=(8,), norm_groups=4)
    assert not (tmp_path / "run").exists()
    assert not (tmp_path / "samples").exists()
