"""The port's data parallelism (tempo_tpu_torch/parallel/mesh.py, DDP) and
ZeRO-3 (parallel/fsdp.py, FSDP2) against the JAX package's mesh and FSDP
steps on its 8-device CPU mesh (tests/test_parallel.py's way), with the
port's ranks as gloo processes on the CPU (tests/torch_parallel_workers.py:
each started, joined through a file store and killed past its own
timeout; the children import no JAX).

The same global batch of 8 goes to JAX's mesh and, cut into contiguous
rows, to the port's 2 or 4 ranks; every posterior, time and noise draw is
JAX's global one, each rank fed its rows. Cases: the tiny VAE's recipe for
3 steps with the clip active (DDP and FSDP2 at world 2 and 4), the L2 step
with different NaN shares on the two ranks (masked_mse's global count),
a latent VDM step under DDP, GPT steps under FSDP2 (fp32 and bf16
moments), grad_accum=2 under DDP, the unused ``down`` conv bitwise the
one-device port's, K2's packed weight fresh at every FSDP2 step, a
world-2 checkpoint with the one-device keys that loads on one device, a
bitwise resume under DDP and FSDP2, and resolve_process_id.

Tolerances are JAX's own (tests/test_parallel.py): loss rel 1e-5,
parameters atol 1e-5 / rtol 1e-4, fp32. The attention's key bias has an
exact gradient of 0; AdamW turns the two sides' rounding noise there into
steps of up to lr, so it is bounded by 3 steps of lr instead (as
tests/test_torch_vae_train.py and test_torch_lm_train.py do); the GPT case
takes such elements out by a rule on JAX's first gradient (GRAD_FLOOR). bf16
moments: XLA's CPU FMAs round optax's bf16 first moment differently
(tests/test_torch_lm_options.py), so that case holds each update within
2e-3 relative L2 of JAX's, the first step's metrics to JAX's, and the
later steps' metrics and the parameters to the one-device port's at
JAX's tolerances."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tempo_tpu.interop.unet_ckpt import params_from_torch_vdm
from tempo_tpu.models import diffusion as jd
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.models.vae_l2 import VAEWithL2Head as JaxL2
from tempo_tpu.nn import transformer as jt
from tempo_tpu.nn.unet import CUNet as JaxCUNet
from tempo_tpu.parallel.fsdp import shard_state_fsdp
from tempo_tpu.parallel.mesh import create_mesh, make_place_fn, shard_state
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu.cli.train_gpt import _lm_loss_fn
from tempo_tpu_torch.interop.jax_params import (gpt_state_dict_from_jax,
                                                l2_state_dict_from_jax,
                                                state_dict_from_jax_params,
                                                vdm_state_dict_from_jax)
from tempo_tpu_torch.models import diffusion as pd
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.models.vae_l2 import L2_PRODUCTS, VAEWithL2Head
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.nn.unet import CUNet
from tempo_tpu_torch.parallel import mesh as pmesh
from tempo_tpu_torch.train import checkpoint as pckpt
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
HIDDEN = (16, 16)
B = 8  # the global batch: JAX's 8 devices, the port's 2 or 4 ranks
LOSS_REL, ATOL, RTOL = 1e-5, 1e-5, 1e-4
LR = 1e-3
# the encoder's last level skips its downsample, the decoder's first its
# upsample: held, never used
UNUSED = ("encoder.downs.2.down", "decoder.ups.2.up")

_RUNS: dict = {}


def _once(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _nudged(params, seed=0):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)


def _noise(key, n=B):
    return np.asarray(jax.random.normal(key, (n, 4, 4, TINY["embed_dim"]),
                                        jnp.float32))


def _close_params(got: dict, want: dict, zero_grad=("mid_attn1.k.bias",),
                  steps=3):
    """Every parameter within JAX's tolerance but the unused down and up
    convs (JAX's AdamW decays a zero gradient's parameter, the port's
    takes no step without a gradient: see
    test_unused_down_conv_is_bitwise_the_one_device_port) and the
    zero-gradient key bias (bounded, see the module doc)."""
    assert set(got) == set(want)
    for name, w in want.items():
        if name.startswith(UNUSED):
            continue
        g = np.asarray(got[name], np.float32)
        w = np.asarray(w, np.float32)
        if name.endswith(zero_grad):
            assert np.abs(g - w).max() <= 2 * steps * LR, name
            continue
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


# ------------------------------------------------------------ the VAE

def _vae_case():
    def make():
        jm = JaxVAE(JaxConfig(**TINY))
        c, h, w = TINY["shape"]
        params = _nudged(jm.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, h, w, c)),
                                 rng=jax.random.PRNGKey(1))["params"])
        rng = np.random.default_rng(1)
        batches = [rng.standard_normal((B, h, w, c)).astype(np.float32)
                   for _ in range(3)]
        key = jax.random.PRNGKey(3)
        # JAX's step draws its posterior with fold_in(rng, step)
        noises = [_noise(jax.random.fold_in(key, i)) for i in range(3)]
        return jm, params, state_dict_from_jax_params(params), batches, noises
    return _once("vae", make)


def _jax_vae(fsdp: bool):
    def make():
        jm, params, _, batches, _ = _vae_case()
        tx = jstate.make_optimizer(lr=LR, weight_decay=0.05)
        mesh = create_mesh()
        state = jstate.create_train_state(params, tx, jax.random.PRNGKey(3))
        state = (shard_state_fsdp if fsdp else shard_state)(state, mesh)
        step = jstep.make_train_step(jstep.vae_loss_fn(jm), tx, donate=False)
        place = make_place_fn(mesh)
        metrics = []
        for b in batches:
            state, m = step(state, place(b))
            metrics.append({k: float(v) for k, v in m.items()})
        return metrics, state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, state.params))
    return _once(("jax_vae", fsdp), make)


def _port_vae(mode, world, tmp_path_factory):
    def make():
        _, _, sd, batches, noises = _vae_case()
        return workers.launch(workers.vae_steps, world,
                              tmp_path_factory.mktemp(f"{mode}{world}"),
                              mode, TINY, sd, batches, noises)[0]
    return _once(("port_vae", mode, world), make)


@pytest.mark.parametrize("mode, world", [("ddp", 2), ("ddp", 4),
                                         ("fsdp", 2), ("fsdp", 4)],
                         ids=["ddp2", "ddp4", "fsdp2", "fsdp4"])
def test_vae_steps_match_the_jax_mesh(mode, world, tmp_path_factory):
    """3 steps of the VAE recipe, the clip active: the port's DDP (FSDP2)
    ranks against JAX's mesh (FSDP) step on the same global batches and
    posterior draws; every rank logs the global metrics."""
    want_m, want_p = _jax_vae(mode == "fsdp")
    got = _port_vae(mode, world, tmp_path_factory)
    assert want_m[0]["grad_norm"] > 1.0  # the clip acted
    for g, w in zip(got["metrics"], want_m):
        for k in ("loss", "nll_loss", "kl_loss", "pixel_mse", "grad_norm"):
            assert abs(g[k] - w[k]) <= LOSS_REL * abs(w[k]), (k, g[k], w[k])
    _close_params(got["params"], want_p)
    n_params = len(list(AutoencoderKL(VAEConfig(**TINY), device="cpu")
                        .parameters()))
    # FSDP2 shards every parameter but the 0-d logvar; DDP none
    assert got["sharded"] == (n_params - 1 if mode == "fsdp" else 0)


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_unused_down_conv_is_bitwise_the_one_device_port(mode,
                                                         tmp_path_factory,
                                                         monkeypatch):
    """The last encoder level's down conv and the first decoder level's up
    conv take no gradient: after 3 world-2 steps they are bitwise the
    one-device port's (their initial values: no gradient, no AdamW
    decay), not a zero gradient decayed."""
    _, _, sd, batches, noises = _vae_case()
    monkeypatch.setattr(DiagonalGaussian, "sample",
                        workers.posterior_feed(noises, slice(None)))
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=0)
    model.load_state_dict(sd)
    tx = pstate.make_optimizer(lr=LR, weight_decay=0.05)
    state = pstate.create_train_state(model, tx, 3)
    step = pstep.make_train_step(pstep.vae_loss_fn(model), tx)
    for b in batches:
        state, _ = step(state, torch.from_numpy(b))
    got = _port_vae(mode, 2, tmp_path_factory)["params"]
    for k in [f"{u}.{p}" for u in UNUSED for p in ("weight", "bias")]:
        assert model.get_parameter(k).grad is None
        assert torch.equal(got[k], model.state_dict()[k]), k
        assert torch.equal(got[k], sd[k]), k


def test_grad_accum_2_under_ddp_equals_the_one_shot_step(tmp_path):
    """grad_accum=2 on 2 ranks (each syncs only its last microbatch) of a
    loss without draws equals one device's one-shot step."""
    _, _, sd, batches, noises = _vae_case()
    got = workers.launch(workers.vae_steps, 2, tmp_path, "ddp", TINY, sd,
                         batches[:2], noises, 2, "mode")[0]
    want = workers.vae_steps(0, 1, "none", TINY, sd, batches[:2], noises, 1,
                             "mode")
    for g, w in zip(got["metrics"], want["metrics"]):
        for k in w:
            assert abs(g[k] - w[k]) <= LOSS_REL * abs(w[k]), k
    _close_params(got["params"], want["params"], zero_grad=(), steps=2)


# ------------------------------------------------------------- the L2

def test_l2_step_with_uneven_nan_shares_matches_the_jax_mesh(tmp_path,
                                                             monkeypatch):
    """One L2 step on 2 ranks whose rows hold 5% and 60% NaN: the product
    losses divide by the global count of valid positions, as JAX's mesh
    step; the mean of the ranks' own ratios (the loss before the repair)
    is far from it."""
    jm = JaxL2(JaxConfig(**TINY), mlp_hidden=HIDDEN)
    c, h, w = TINY["shape"]
    rng = np.random.default_rng(4)
    batch = {"spectral": rng.standard_normal((B, h, w, c)).astype(
        np.float32)}
    share = np.where(np.arange(B) < B // 2, 0.05, 0.6)[:, None, None]
    for p in L2_PRODUCTS:
        field = rng.standard_normal((B, h, w)).astype(np.float32)
        field[rng.random(field.shape) < share] = np.nan
        batch[p] = field
    params = _nudged(jm.init(
        jax.random.PRNGKey(0), {k: jnp.asarray(v[:1]) for k, v in
                                batch.items()},
        jax.random.PRNGKey(1), method=JaxL2.compute_loss)["params"])
    key = jax.random.PRNGKey(3)
    tx = jstate.make_optimizer(lr=LR, weight_decay=0.05)
    mesh = create_mesh()
    state = shard_state(jstate.create_train_state(params, tx, key), mesh)
    step = jstep.make_train_step(jstep.vae_l2_loss_fn(jm), tx, donate=False)
    state, m = step(state, make_place_fn(mesh)(batch))
    want = {k: float(v) for k, v in m.items()}
    k_vae, k_head = jax.random.split(jax.random.fold_in(key, 0))
    noises = [_noise(k_vae), _noise(k_head)]
    sd = l2_state_dict_from_jax(params, HIDDEN)
    got = workers.launch(workers.l2_step, 2, tmp_path, TINY, HIDDEN, sd,
                         batch, noises)[0]
    for k, v in want.items():
        assert abs(got["metrics"][k] - v) <= LOSS_REL * abs(v), (k, v)
    _close_params(got["params"], l2_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params), HIDDEN), steps=1)
    # the data tells the repair apart: the ranks' own ratios average to
    # another number
    port = VAEWithL2Head(VAEConfig(**TINY), HIDDEN, device="cpu", seed=0)
    port.load_state_dict(sd)
    local = []
    for sl in (slice(0, B // 2), slice(B // 2, B)):
        monkeypatch.setattr(DiagonalGaussian, "sample",
                            workers.posterior_feed(noises, sl))
        with torch.no_grad():
            _, lm = port.compute_loss(workers.take(batch, sl),
                                      torch.Generator())
        local.append(lm["NO2_loss"].item())
    assert abs(np.mean(local) - want["NO2_loss"]) > 100 * LOSS_REL * abs(
        want["NO2_loss"])


# ------------------------------------------------------------ the VDM

def test_latent_vdm_ddp_step_matches_the_jax_mesh(tmp_path):
    """2 steps of a VDM on the latents of a frozen VAE: each rank encodes
    its rows (the frozen VAE unwrapped) and trains under DDP; JAX's mesh
    step trains on the same global latents and draws."""
    shape = (4, 4, TINY["embed_dim"])
    score = dict(chs=(8, 12), norm_groups=4, n_attention_heads=2,
                 dropout_prob=0.0, t_conditioning=True, t_embedding_dim=8)
    gen = torch.Generator().manual_seed(7)
    seeded = pd.VDM(CUNet(shape=shape, device="cpu", seed=0, **score), seed=0)
    with torch.no_grad():
        for p in seeded.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    params = params_from_torch_vdm(seeded.state_dict(), n_levels=2)
    vdm_sd = vdm_state_dict_from_jax(params)
    _, _, vae_sd, batches, noises = _vae_case()
    scale = 0.5
    frozen = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=0)
    frozen.load_state_dict(vae_sd)
    rng = np.random.default_rng(9)
    draws, latents = [], []
    for b, n in zip(batches[:2], noises):
        with torch.no_grad():
            post = frozen.encode(torch.from_numpy(b))
            latents.append(((post.mean + post.std * torch.from_numpy(n))
                            * scale).numpy())
        draws.append((rng.standard_normal((B, *shape)).astype(np.float32),
                      rng.random(B).astype(np.float32),
                      rng.standard_normal((B, *shape)).astype(np.float32)))
    jm = jd.VDM(JaxCUNet(shape=shape, **score))

    def loss_fn(p, batch, rng_key):
        loss, m = jm.apply({"params": p}, batch["z"], noise=batch["noise"],
                           times=batch["times"], noise_0=batch["noise_0"],
                           method=jd.VDM.get_loss)
        return loss, dict(m)

    tx = jstate.make_optimizer(lr=LR, weight_decay=0.05, max_grad_norm=None)
    mesh = create_mesh()
    state = shard_state(jstate.create_train_state(
        params, tx, jax.random.PRNGKey(0)), mesh)
    step = jstep.make_train_step(loss_fn, tx, donate=False)
    want = []
    for z, (noise, times, noise_0) in zip(latents, draws):
        state, m = step(state, make_place_fn(mesh)(
            {"z": z, "noise": noise, "times": times, "noise_0": noise_0}))
        want.append(float(m["elbo"]))
    got = workers.launch(workers.vdm_latent_step, 2, tmp_path, TINY, vae_sd,
                         {}, dict(score, shape=shape), vdm_sd, batches[:2],
                         noises, draws, scale)[0]
    for g, w in zip(got["metrics"], want):
        assert abs(g["loss"] - w) <= LOSS_REL * abs(w), (g["loss"], w)
    _close_params(got["params"], vdm_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params)), steps=2)


# ------------------------------------------------------------ the GPT

GPT = dict(in_size=17, block_size=32, n_layer=2, n_head=2, n_embd=32)


# An Adam step divides the gradient by its own RMS, so an element whose
# gradient is at the scale of the sum's rounding steps by up to lr in a
# direction the rounding picks. Such elements are told apart by JAX's own
# first gradient: |g| below GRAD_FLOOR times the largest |g| of its tensor
# (about 8 fp32 ulps of it). On this data the rule takes out 65 of the
# 27,040 elements: the 64 key biases of the two layers (an exact gradient
# of 0; JAX's is at most 3.6e-12) and one element of h.0.mlp.c_proj.weight
# (|g| 5.2e-9 against the tensor's 1.1e-2). They are bounded by 2 x 3
# steps x lr, as the VAE's key bias is.
GRAD_FLOOR = 1e-6


@pytest.mark.parametrize("moments", [None, "bfloat16"],
                         ids=["fp32_moments", "bf16_moments"])
def test_gpt_fsdp_steps_match_the_jax_fsdp_mesh(moments, tmp_path):
    """3 GPT steps under FSDP2 on 2 ranks against JAX's FSDP mesh step on
    the same global token batches; the bf16-moment case too."""
    jcfg = jt.TransformerConfig(attn_impl="xla", **GPT)
    pcfg = dict(attn_impl="flash", **GPT)
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, GPT["block_size"]), jnp.int32))[
        "params"]
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, GPT["in_size"], (B, GPT["block_size"] + 1))
               .astype(np.int32) for _ in range(3)]
    loss_fn = _lm_loss_fn(jmodel, 0.01)
    tx = jt.make_gpt_optimizer(params, 0.1, LR, (0.9, 0.95),
                               moments_dtype=moments)
    mesh = create_mesh()
    state = shard_state_fsdp(jstate.create_train_state(
        params, tx, jax.random.PRNGKey(3)), mesh)
    step = jstep.make_train_step(loss_fn, tx, donate=False)
    want = []
    for b in batches:
        state, m = step(state, make_place_fn(mesh)(b))
        want.append({k: float(v) for k, v in m.items()})
    pconfig = pt.TransformerConfig(**pcfg)

    def port_sd(tree):
        return gpt_state_dict_from_jax(
            jax.tree_util.tree_map(np.asarray, tree), pconfig)

    sd = port_sd(params)
    grad0 = port_sd(jax.grad(lambda p: loss_fn(
        p, jnp.asarray(batches[0]), jax.random.PRNGKey(3))[0])(params))
    got = workers.launch(workers.gpt_steps, 2, tmp_path, pcfg, sd, batches,
                         LR, moments)[0]
    assert got["sharded"] == len(sd)
    out = {}  # the elements under the floor, per parameter
    for name, g0 in grad0.items():
        g0 = np.abs(np.asarray(g0))
        out[name] = g0 < GRAD_FLOOR * g0.max()
        if name.endswith("attn.c_attn.bias"):
            assert out[name][GPT["n_embd"]:2 * GPT["n_embd"]].all(), name

    def close(got_sd, want_sd, check):
        for name, w in want_sd.items():
            g, w = np.asarray(got_sd[name]), np.asarray(w)
            o = out[name]
            assert np.abs(g - w)[o].max(initial=0.0) <= 2 * 3 * LR, name
            check(name, g[~o], w[~o], np.asarray(sd[name])[~o])

    def allclose(name, g, w, p0):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)

    def update_close(name, g, w, p0):
        upd, want_upd = g - p0, w - p0
        assert (np.linalg.norm(upd - want_upd)
                <= 2e-3 * np.linalg.norm(want_upd) + 1e-7), name

    if moments is not None:
        # after the first update the two sides' bf16 first moments differ
        # (see the module doc), and so do the later steps' inputs: those
        # steps are held to the one-device port's
        alone = workers.gpt_steps(0, 1, pcfg, sd, batches, LR, moments,
                                  "none")
        want[1:] = alone["metrics"][1:]
        close(got["params"], alone["params"], allclose)
    for g, w in zip(got["metrics"], want):
        for k in ("loss", "grad_norm"):  # the norm over DTensor shards
            assert abs(g[k] - w[k]) <= LOSS_REL * abs(w[k]), (k, g[k], w[k])
    close(got["params"], port_sd(state.params),
          allclose if moments is None else update_close)
    assert sum(int(o.sum()) for o in out.values()) <= 65


# ----------------------------------------------------- K2's packed weight

def test_packed_weight_is_fresh_at_every_fsdp_step(tmp_path):
    """Under FSDP2 the weight a block's forward sees keeps version 0 while
    its values change from step to step, so K2's cache could not see the
    update: the cache is off there, and ``packed_weight`` equals a fresh
    pack at steps 1-3."""
    c, h, w = TINY["shape"]
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((4, h, w, c)).astype(np.float32)
               for _ in range(3)]
    seen = workers.launch(workers.packed_weights, 2, tmp_path, TINY,
                          batches)[0]
    assert len(seen) == 3
    assert all(s["diff"] == 0.0 and not s["cache_packed"] for s in seen)
    assert len({s["checksum"] for s in seen}) == 3  # the weight moved
    assert all(s["version"] == seen[0]["version"] for s in seen)


# ------------------------------------------------- checkpoint and resume

def _resume(mode, tmp_path_factory):
    def make():
        c, h, w = TINY["shape"]
        rng = np.random.default_rng(6)
        batches = [rng.standard_normal((4, h, w, c)).astype(np.float32)
                   for _ in range(4)]
        workdir = tmp_path_factory.mktemp(f"resume_{mode}")
        return workers.launch(workers.resume, 2, workdir, mode, TINY,
                              batches, str(workdir))[0]
    return _once(("resume", mode), make)


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_world_2_checkpoint_has_the_one_device_keys_and_loads_on_one_device(
        mode, tmp_path_factory):
    run = _resume(mode, tmp_path_factory)
    raw = torch.load(run["path"], weights_only=True)
    single = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=0)
    assert list(raw["model"]) == list(single.state_dict())
    tx = pstate.make_optimizer(lr=LR, weight_decay=0.05)
    state = pstate.create_train_state(single, tx, 3)
    state, _, _ = pckpt.load_checkpoint(run["path"], state)
    assert state.step == 2 and len(raw["rank_generators"]) == 2
    assert all(raw["optimizer"]["state"][i]["exp_avg"].shape == p.shape
               for i, p in enumerate(single.parameters())
               if i in raw["optimizer"]["state"])
    fresh = pckpt.load_params(run["path"], AutoencoderKL(
        VAEConfig(**TINY), device="cpu", seed=1))
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, raw["model"][k]), k


@pytest.mark.parametrize("mode", ["ddp", "fsdp"])
def test_resume_is_bitwise(mode, tmp_path_factory):
    """2 steps, a checkpoint, a fresh state that loads it and 2 more steps
    equal 4 straight steps bit for bit: parameters, AdamW's moments and
    every rank's generator come back."""
    run = _resume(mode, tmp_path_factory)
    assert run["step"] == 4
    for k, v in run["straight"].items():
        assert torch.equal(run["resumed"][k], v), k


# ---------------------------------------------------------- the process

def test_resolve_process_id(monkeypatch):
    for var in pmesh.RANK_VARS:
        monkeypatch.delenv(var, raising=False)
    assert pmesh.resolve_process_id(3) == 3
    assert pmesh.resolve_process_id(None) is None
    with pytest.raises(ValueError, match="RANK"):
        pmesh.resolve_process_id("auto")
    monkeypatch.setenv("RANK", "5")
    assert pmesh.resolve_process_id("auto") == 5
    monkeypatch.setenv("SLURM_PROCID", "2")  # earlier in JAX's list
    assert pmesh.resolve_process_id("auto") == 2


def test_no_group_without_a_launcher_and_a_run_group_is_left_behind(
        monkeypatch):
    """Without ``distributed`` or torchrun's WORLD_SIZE a run has no group;
    a group of one joined for FSDP2 is destroyed when the run ends."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.maybe_initialize_distributed({}, "cpu") is None
    with pmesh.process_group({}, "cpu") as mesh:
        assert mesh is None and not pmesh.is_active()
    with pmesh.process_group({}, "cpu", single=True) as mesh:
        assert mesh.size() == 1 and pmesh.process_count() == 1
    assert not pmesh.is_active()


def test_a_rank_that_never_joins_fails_the_run_within_its_timeout(tmp_path):
    """Rank 1 of 2 never starts: rank 0's rendezvous cannot complete, and
    the launcher kills it at its timeout instead of hanging the suite."""
    with pytest.raises((TimeoutError, RuntimeError)):
        workers.launch(workers.vae_steps, 2, tmp_path, "ddp", TINY, None,
                       [], [], ranks=[0], timeout_s=10)
