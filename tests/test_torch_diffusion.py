"""The port's diffusion and flow toolkit (tempo_tpu_torch/models/
{diffusion,flow,masked}.py) against the JAX package's on the CPU: the four
noise schedules and dgamma/dt, VDM.get_loss and its three terms with the
same draws fed to both sides (fixed_linear and learned_nn), the gradients
of the score model and of the learned schedule against jax.grad, the
ancestral, DDNM and DDIM steps, ``sample`` from a fed z and JAX's own
per-step draws, CFG, SFM's interpolant and loss, both SDE integrators and
``predict`` with JAX's draws, and MaskedEncoder.

Weights: the port's VDM (seeded, then moved off the zero-init point) goes
to the JAX package through its own reader (tempo_tpu/interop/unet_ckpt.py
``params_from_torch_vdm``) and back into a fresh port model through
interop/jax_params.py ``vdm_state_dict_from_jax``, bit for bit.

Tolerances: fp32 outputs atol 3e-5, rtol 1e-4; scalar losses rtol 1e-4;
each gradient within 1e-4 relative L2 (sums over the batch and the
spatial axes in another order; the attention's key bias, whose exact
gradient is 0, only bounded); the multi-step samplers atol 1e-4 (each
step's rounding carried into the next through the network)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.interop.unet_ckpt import (params_from_torch_cunet,
                                         params_from_torch_vdm)
from tempo_tpu.models import diffusion as jd
from tempo_tpu.models import flow as jf
from tempo_tpu.models.masked import MaskedEncoder as JaxMaskedEncoder
from tempo_tpu.nn.unet import CUNet as JaxCUNet
from tempo_tpu_torch.interop.jax_params import vdm_state_dict_from_jax
from tempo_tpu_torch.models import diffusion as pd
from tempo_tpu_torch.models import flow as pf
from tempo_tpu_torch.models.masked import MaskedEncoder, random_token_masks
from tempo_tpu_torch.nn.unet import CUNet

torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=1e-4)
SAMPLER_TOL = dict(atol=1e-4, rtol=1e-4)
LOSS_REL = 1e-4
GRAD_REL = 1e-4
SHAPE = (8, 8, 3)
SCORE = dict(chs=(8, 12), norm_groups=4, n_attention_heads=2,
             dropout_prob=0.0, t_conditioning=True, t_embedding_dim=8)


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _nudge(module, scale=0.05, seed=7):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


def _score(seed=0, **extra):
    return CUNet(shape=SHAPE, device="cpu", seed=seed, **dict(SCORE, **extra))


def _vdm_pair(score_extra=None, **vdm_kw):
    """(JAX VDM, its params, the port's VDM) with the same weights, the
    params through both bridges."""
    score_extra = score_extra or {}
    seeded = _nudge(pd.VDM(_score(**score_extra), seed=0, **vdm_kw))
    params = params_from_torch_vdm(seeded.state_dict(), n_levels=2)
    port = pd.VDM(_score(seed=1, **score_extra), seed=1, **vdm_kw)
    port.load_state_dict(vdm_state_dict_from_jax(params))
    for k, v in seeded.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    jm = jd.VDM(JaxCUNet(shape=SHAPE, **dict(SCORE, **score_extra)),
                **vdm_kw)
    return jm, params, port


def _draws(b=4, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, *SHAPE)).astype(np.float32)
    noise = rng.standard_normal(x.shape).astype(np.float32)
    noise_0 = rng.standard_normal(x.shape).astype(np.float32)
    times = (0.0123 + np.arange(b) / b).astype(np.float32)
    return x, noise, noise_0, times


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["fixed_linear", "sigmoid",
                                  "learned_linear", "learned_nn"])
def test_schedules_and_dgamma_dt(name):
    """gamma(t) and the port's torch.func.jvp dgamma/dt against JAX's
    schedule and jax.jvp, at the same (learned) parameters."""
    _, params, port = _vdm_pair(noise_schedule=name, gamma_min=-6.0,
                                gamma_max=4.0)
    t = np.linspace(0.02, 0.98, 9).astype(np.float32)
    sched = jd.SCHEDULES[name](-6.0, 4.0)
    variables = {"params": params["gamma"]} if "gamma" in params else {}
    want, want_grad = jax.jvp(lambda x: sched.apply(variables, x),
                              (jnp.asarray(t),), (jnp.ones(9),))
    got, got_grad = port.gamma_and_grad(torch.from_numpy(t))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_grad.detach().numpy(),
                               np.asarray(want_grad), **TOL)


def test_kl_std_normal():
    rng = np.random.default_rng(0)
    m2 = np.abs(rng.standard_normal(10)).astype(np.float32)
    var = (np.abs(rng.standard_normal(10)) + 0.1).astype(np.float32)
    np.testing.assert_allclose(
        pd.kl_std_normal(*_t(m2, var)).numpy(),
        np.asarray(jd.kl_std_normal(jnp.asarray(m2), jnp.asarray(var))),
        **TOL)


# ------------------------------------------------------------- the loss

def _loss_and_grads_match(name):
    jm, params, port = _vdm_pair(noise_schedule=name)
    x, noise, noise_0, times = _draws()

    def jax_loss(p):
        return jm.apply({"params": p}, jnp.asarray(x),
                        noise=jnp.asarray(noise), times=jnp.asarray(times),
                        noise_0=jnp.asarray(noise_0), method=jd.VDM.get_loss)

    (want, want_m), want_g = jax.jit(jax.value_and_grad(
        jax_loss, has_aux=True))(params)
    xt, nt, n0t, tt = _t(x, noise, noise_0, times)
    loss, metrics = port.get_loss(xt, noise=nt, times=tt, noise_0=n0t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=LOSS_REL)
    for k in ("elbo", "diffusion_loss", "latent_loss",
              "reconstruction_loss"):
        np.testing.assert_allclose(metrics[k].item(), float(want_m[k]),
                                   rtol=LOSS_REL, err_msg=k)
    want_sd = vdm_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             want_g))
    got = dict(port.named_parameters())
    assert set(got) == set(want_sd)
    for k, g in want_sd.items():
        if not g.any():
            assert got[k].grad is None or not got[k].grad.any(), k
            continue
        if k.endswith("mid_attn1.k.bias"):
            # a bias on every key moves each query's scores by one constant:
            # the exact gradient is 0, both sides hold rounding
            assert got[k].grad.abs().max() <= 1e-6
            continue
        assert _rel_l2(got[k].grad, g) <= GRAD_REL, (k, _rel_l2(
            got[k].grad, g))
    return port


def test_vdm_loss_and_grads_fixed_linear():
    _loss_and_grads_match("fixed_linear")


def test_vdm_loss_and_grads_learned_nn():
    """The learned schedule's parameters get their gradient through
    dgamma/dt (and gamma): nonzero, and JAX's."""
    port = _loss_and_grads_match("learned_nn")
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for p in port.gamma.parameters())


def test_vdm_over_cmlp_loss():
    """A VDM whose score model is a CMLP (flat data) crosses both bridges
    (the JAX reader's score_kind 'cmlp') and gives JAX's loss."""
    from tempo_tpu.nn.unet import CMLP as JaxCMLP
    from tempo_tpu_torch.nn.unet import CMLP

    kw = dict(in_dim=6, h_dims=(16,), t_conditioning=True, t_embedding_dim=8)
    seeded = _nudge(pd.VDM(CMLP(device="cpu", **kw), "learned_linear"))
    params = params_from_torch_vdm(seeded.state_dict(), score_kind="cmlp")
    port = pd.VDM(CMLP(device="cpu", seed=1, **kw), "learned_linear", seed=1)
    port.load_state_dict(vdm_state_dict_from_jax(params))
    rng = np.random.default_rng(4)
    x, noise, noise_0 = (rng.standard_normal((4, 6)).astype(np.float32)
                         for _ in range(3))
    times = np.asarray([0.1, 0.35, 0.6, 0.85], np.float32)
    want, _ = jd.VDM(JaxCMLP(**kw), "learned_linear").apply(
        {"params": params}, *(jnp.asarray(a) for a in (x, noise, times)),
        method=lambda m, x_, n_, t_: m.get_loss(x_, noise=n_, times=t_,
                                                noise_0=jnp.asarray(noise_0)))
    with torch.no_grad():
        got, _ = port.get_loss(*_t(x), noise=_t(noise)[0], times=_t(times)[0],
                               noise_0=_t(noise_0)[0])
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_REL)


def test_vdm_loss_draws_and_per_sample_reduction():
    """Without fed draws the loss draws from the generator (the same
    generator state gives the same loss); reduction 'none' keeps [B]."""
    _, _, port = _vdm_pair()
    x = torch.from_numpy(_draws()[0])

    def loss(seed, **kw):
        return port.get_loss(x, torch.Generator().manual_seed(seed), **kw)

    with torch.no_grad():
        assert loss(3)[0].item() == loss(3)[0].item()
        assert loss(3)[0].item() != loss(4)[0].item()
        per, m = loss(3, reduction="none")
        assert per.shape == (4,) and m["elbo"].shape == (4,)
        np.testing.assert_allclose(per.mean().item(), loss(3)[0].item(),
                                   rtol=1e-6)
        times = port.sample_times(4, torch.Generator().manual_seed(0))
    gaps = np.diff(times.numpy())
    np.testing.assert_allclose(gaps, 0.25, atol=1e-6)  # antithetic


def test_vdm_cfg_masking_and_guided_prediction():
    """p_cfg = 1 masks every row to -1 (the loss equals the unconditioned
    one, in JAX too); w_cfg's guided prediction against JAX's."""
    extra = dict(v_conditioning_dims=(4,), v_embedding_dim=8,
                 v_conditioning_type="common_linear")
    jm, params, port = _vdm_pair(score_extra=extra, p_cfg=1.0, w_cfg=3.0)
    x, noise, noise_0, times = _draws(b=2)
    v = np.random.default_rng(9).standard_normal((2, 4)).astype(np.float32)
    want, _ = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(x), rng=jax.random.PRNGKey(2),
        noise=jnp.asarray(noise), times=jnp.asarray(times),
        noise_0=jnp.asarray(noise_0), v_conditionings=[jnp.asarray(v)],
        method=jd.VDM.get_loss))(params)
    xt, nt, n0t, tt, vt = _t(x, noise, noise_0, times, v)
    with torch.no_grad():
        got, _ = port.get_loss(xt, torch.Generator(), noise=nt, times=tt,
                               noise_0=n0t, v_conditionings=[vt])
        port.p_cfg = None
        uncond, _ = port.get_loss(xt, noise=nt, times=tt, noise_0=n0t,
                                  v_conditionings=[-torch.ones_like(vt)])
        gamma_t = torch.full((2,), 0.5)
        guided = port.get_pred_noise(xt, gamma_t, guided=True,
                                     v_conditionings=[vt])
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_REL)
    np.testing.assert_allclose(got.item(), uncond.item(), rtol=1e-6)
    want_guided = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(x), jnp.full((2,), 0.5), guided=True,
        v_conditionings=[jnp.asarray(v)], method=jd.VDM.get_pred_noise))(
        params)
    np.testing.assert_allclose(guided.numpy(), np.asarray(want_guided),
                               **TOL)


# ---------------------------------------------------------- the samplers

def test_ancestral_ddnm_and_ddim_steps():
    jm, params, port = _vdm_pair()
    rng = np.random.default_rng(5)
    zt = rng.standard_normal((2, *SHAPE)).astype(np.float32)
    noise = rng.standard_normal(zt.shape).astype(np.float32)
    t, s = np.float32(0.8), np.float32(0.55)
    ztt, nt = _t(zt, noise)

    def jax_step(method, **kw):
        return jm.apply({"params": params}, jnp.asarray(zt), t, s,
                        method=method, **kw)

    with torch.no_grad():
        anc = port.sample_zs_given_zt(ztt, t, s, noise=nt)
        np.testing.assert_allclose(
            anc.numpy(), np.asarray(jax_step(jd.VDM.sample_zs_given_zt,
                                             noise=jnp.asarray(noise))),
            **TOL)
        ddnm = port.sample_zs_given_zt(ztt, t, s, return_ddnm=True)
        for got, want in zip(ddnm, jax_step(jd.VDM.sample_zs_given_zt,
                                            return_ddnm=True)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for eta in (0.0, 1.0):
            ddim = port.sample_zs_given_zt_ddim(ztt, t, s, eta=eta,
                                                noise=nt)
            np.testing.assert_allclose(
                ddim.numpy(), np.asarray(jax_step(
                    jd.VDM.sample_zs_given_zt_ddim, eta=eta,
                    noise=jnp.asarray(noise))), **TOL)
        # eta 1 is the ancestral posterior
        np.testing.assert_allclose(ddim.numpy(), anc.numpy(), atol=1e-5,
                                   rtol=1e-5)


def _jax_step_draws(key, n_steps, shape):
    """The draws JAX's ``sample`` makes, step by step, from ``key`` when
    z is given: rng, key = split(rng) at each step."""
    out, rng = [], key
    for _ in range(n_steps):
        rng, k = jax.random.split(rng)
        out.append(np.asarray(jax.random.normal(k, shape, jnp.float32)))
    return out


@pytest.mark.parametrize("method,eta", [("ancestral", 0.0), ("ddim", 0.0),
                                        ("ddim", 0.5)])
def test_sample_with_fed_z_and_jax_draws(method, eta):
    jm, params, port = _vdm_pair()
    n, b = 4, 2
    z = np.random.default_rng(6).standard_normal((b, *SHAPE)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    want = jd.sample(jm, params, key, batch_size=b, n_sampling_steps=n,
                     sample_shape=SHAPE, z=jnp.asarray(z), method=method,
                     eta=eta, return_all=True)
    noise = _t(*_jax_step_draws(key, n, (b, *SHAPE)))
    got = pd.sample(port, None, b, n, SHAPE, z=torch.from_numpy(z),
                    noise=noise, method=method, eta=eta, return_all=True)
    assert got.shape == (n, b, *SHAPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLER_TOL)


def test_sample_draws_from_the_generator():
    _, _, port = _vdm_pair()

    def run(seed, method="ancestral"):
        return pd.sample(port, torch.Generator().manual_seed(seed), 2, 3,
                         SHAPE, method=method)

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    with pytest.raises(ValueError, match="unknown sampling method"):
        run(1, "euler")


# ------------------------------------------------- stochastic flow matching

def _sfm_pair():
    seeded = _nudge(pf.SFM(_score(s_conditioning_channels=SHAPE[-1])))
    params = {"velocity_model": params_from_torch_cunet(
        {k[len("velocity_model."):]: v
         for k, v in seeded.state_dict().items()}, n_levels=2)}
    port = pf.SFM(_score(seed=1, s_conditioning_channels=SHAPE[-1]))
    port.load_state_dict(vdm_state_dict_from_jax(params))
    for k, v in seeded.state_dict().items():
        assert torch.equal(port.state_dict()[k], v), k
    jm = jf.SFM(JaxCUNet(shape=SHAPE, s_conditioning_channels=SHAPE[-1],
                         **SCORE))
    return jm, params, port


def test_sfm_interpolant_and_loss():
    jm, params, port = _sfm_pair()
    rng = np.random.default_rng(7)
    x0, x1, eps = (rng.standard_normal((2, *SHAPE)).astype(np.float32)
                   for _ in range(3))
    t = np.asarray([0.25, 0.75], np.float32)
    j = [jnp.asarray(a) for a in (x0, x1, t, eps)]
    p = _t(x0, x1, t, eps)
    for name in ("get_xt", "get_rt"):
        want = jm.apply({"params": params}, *j,
                        method=getattr(jf.SFM, name))
        np.testing.assert_allclose(getattr(port, name)(*p).numpy(),
                                   np.asarray(want), **TOL)
    want = jm.apply({"params": params}, j[0], j[1], t=j[2], epsilon=j[3],
                    method=jf.SFM.compute_loss)
    with torch.no_grad():
        got = port.compute_loss(p[0], p[1], t=p[2], epsilon=p[3])
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_REL)


def _jax_sde_draws(key, n_steps, shape):
    """The draws JAX's sde_integrate makes: split(rng, n_steps)."""
    return [np.asarray(jax.random.normal(k, shape, jnp.float32))
            for k in jax.random.split(key, n_steps)]


@pytest.mark.parametrize("method", ["euler", "lm"])
def test_sde_integrate_with_jax_draws(method):
    x0 = np.random.default_rng(8).standard_normal((4, 3)).astype(np.float32)
    n, key = 8, jax.random.PRNGKey(4)

    def drift(t, x, x0_):
        return -x + 0.5 * x0_ * t

    want = jf.sde_integrate(drift, lambda t: 0.3 + t, jnp.asarray(x0), n,
                            key, method=method)
    got = pf.sde_integrate(drift, lambda t: 0.3 + t, torch.from_numpy(x0), n,
                           method=method,
                           noise=_t(*_jax_sde_draws(key, n, x0.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="unknown SDE method"):
        pf.sde_integrate(drift, lambda t: t, torch.from_numpy(x0), n,
                         method="rk4")


def test_lm_integrator_halves_noise_variance():
    x0 = torch.zeros(4096, 1)
    var = {m: pf.sde_integrate(lambda t, x, x0_: torch.zeros_like(x),
                               lambda t: 1.0, x0, 8,
                               torch.Generator().manual_seed(1),
                               method=m).var().item()
           for m in ("euler", "lm")}
    assert var["euler"] / var["lm"] == pytest.approx(2.0, rel=0.15)


@pytest.mark.parametrize("method", ["euler", "lm"])
def test_sfm_predict_with_jax_draws(method):
    jm, params, port = _sfm_pair()
    x0 = np.random.default_rng(9).standard_normal((2, *SHAPE)).astype(
        np.float32)
    n, key = 3, jax.random.PRNGKey(0)
    want = jf.predict(jm, params, jnp.asarray(x0), key, n_sampling_steps=n,
                      method=method)
    got = pf.predict(port, torch.from_numpy(x0), n_sampling_steps=n,
                     method=method,
                     noise=_t(*_jax_sde_draws(key, n, x0.shape)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAMPLER_TOL)


# ------------------------------------------------------ the masked encoder

@pytest.mark.parametrize("mask_channels,input_mask",
                         [(None, False), ((True, False, True, True), False),
                          (None, True)])
def test_masked_encoder(mask_channels, input_mask):
    rng = np.random.default_rng(3)
    c_in = 4 + (1 if input_mask else 0)
    w = rng.standard_normal((c_in, 4 + (1 if input_mask else 0))).astype(
        np.float32)
    x = rng.standard_normal((2, 6, 4)).astype(np.float32)
    masks = random_token_masks(torch.Generator().manual_seed(0), 2, 6, 0.5)
    assert masks.dtype == torch.bool and masks.shape == (2, 6)
    jax_enc = JaxMaskedEncoder(lambda h: h @ jnp.asarray(w),
                               mask_channels=mask_channels,
                               input_mask=input_mask)
    enc = MaskedEncoder(lambda h: h @ torch.from_numpy(w),
                        mask_channels=mask_channels, input_mask=input_mask)
    jm = jnp.asarray(masks.numpy())
    want_x, want_el = jax_enc.get_masked_x(jnp.asarray(x), jm)
    got_x, got_el = enc.get_masked_x(torch.from_numpy(x), masks)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_el.numpy(), np.asarray(want_el))
    np.testing.assert_allclose(
        enc.get_loss(torch.from_numpy(x), masks).item(),
        float(jax_enc.get_loss(jnp.asarray(x), jm)), rtol=LOSS_REL)
