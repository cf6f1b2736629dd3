"""The port's CUNet (2-D and 3-D), CMLP and timestep embedding against the
JAX package's on the CPU. Parameters cross both bridges: the port's
(seeded, then moved off the zero-init point so that every branch reaches
the output) go to the JAX package through its own reader
(tempo_tpu/interop/unet_ckpt.py ``params_from_torch_cunet`` /
``params_from_torch_cmlp``), and those JAX params come back into a fresh
port model through interop/jax_params.py ``cunet_state_dict_from_jax`` /
``cmlp_state_dict_from_jax``, bit for bit. The same numpy inputs from a
seed then go through the JAX module and the port, and the outputs agree to
fp32 atol 3e-5, rtol 1e-4. The cases mirror tests/test_unet.py; the 2-D
ones share one input shape so that the JAX package's eager ops compile
once a file."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.interop.unet_ckpt import (params_from_torch_cmlp,
                                         params_from_torch_cunet)
from tempo_tpu.nn.unet import CMLP as JaxCMLP
from tempo_tpu.nn.unet import CUNet as JaxCUNet
from tempo_tpu.nn.unet import timestep_embedding as jax_timestep_embedding
from tempo_tpu_torch.interop.jax_params import (cmlp_state_dict_from_jax,
                                                cunet_state_dict_from_jax)
from tempo_tpu_torch.nn.unet import CMLP, CUNet, scale_params
from tempo_tpu_torch.nn.unet import timestep_embedding

torch.set_num_threads(1)

TOL = dict(atol=3e-5, rtol=1e-4)
BASE = dict(chs=(8, 12), norm_groups=4, n_attention_heads=2,
            dropout_prob=0.0)
SHAPE = (8, 8, 3)


def nudge(module: torch.nn.Module, scale: float = 0.05,
          seed: int = 7) -> torch.nn.Module:
    """Every parameter moved off its init (the zero-init convs make every
    residual branch vanish there), in place."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen))
    return module


def through_jax(module: torch.nn.Module, to_jax, from_jax, make):
    """The module's params through the JAX package's reader and back
    through the port's; returns (JAX params, the fresh port model)."""
    params = to_jax(module.state_dict())
    fresh = make()
    fresh.load_state_dict(from_jax(params))
    for k, v in module.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    return params, fresh


def _inputs(shape, t=None, s_ch=0, v_dims=(), batch=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *shape)).astype(np.float32)
    kw = {}
    if t is not None:
        kw["t"] = np.asarray(t, np.float32)
    if s_ch:
        kw["s_conditioning"] = rng.standard_normal(
            (batch, *shape[:-1], s_ch)).astype(np.float32)
    if v_dims:
        kw["v_conditionings"] = [rng.standard_normal((batch, d)).astype(
            np.float32) for d in v_dims]
    return x, kw


def _jax(kw):
    return {k: [jnp.asarray(a) for a in v] if isinstance(v, list)
            else jnp.asarray(v) for k, v in kw.items()}


def _torch(kw):
    return {k: [torch.from_numpy(a) for a in v] if isinstance(v, list)
            else torch.from_numpy(np.asarray(v)) for k, v in kw.items()}


def _check(shape, t=None, s_ch=0, v_dims=(), **cfg):
    """The port's CUNet (seeded, nudged) through both bridges; the JAX
    module on those params and the port on the same inputs agree."""
    kw = dict(BASE, **cfg)
    seeded = nudge(CUNet(shape=shape, device="cpu", seed=0, **kw))
    params, tm = through_jax(
        seeded,
        lambda sd: params_from_torch_cunet(
            sd, n_levels=len(kw["chs"]),
            num_res_blocks=kw.get("num_res_blocks", 1)),
        lambda p: cunet_state_dict_from_jax(
            p, dropout=kw["dropout_prob"] > 0),
        lambda: CUNet(shape=shape, device="cpu", seed=1, **kw))
    x, inputs = _inputs(shape, t, s_ch, v_dims)
    want = np.asarray(JaxCUNet(shape=shape, **kw).apply(
        {"params": params}, jnp.asarray(x), **_jax(inputs)))
    tm.train()  # the forward is deterministic unless asked otherwise
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **_torch(inputs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    return tm, got


def test_cunet_unconditional():
    _check(SHAPE)


def test_cunet_t_and_v_conditioning():
    """Timestep + common-zerolinear vector conditioning, at two times."""
    for t in (0.3, 0.9):
        _check(SHAPE, t=t, v_dims=(5,), t_conditioning=True,
               v_conditioning_dims=(5,), v_embedding_dim=16,
               t_embedding_dim=8)


def test_cunet_per_sample_times():
    _check(SHAPE, t=[0.1, 0.7], t_conditioning=True, t_embedding_dim=8)


def test_cunet_s_conditioning_and_residual_out():
    """Spatial conditioning concatenated onto the input and the
    channel-changing zero-init residual output conv."""
    _check(SHAPE, s_ch=2, s_conditioning_channels=2, out_channels=5)


def test_cunet_mlp_cond_proj_and_no_s_gelu():
    _check(SHAPE, t=0.5, v_dims=(3, 4), t_conditioning=True,
           v_conditioning_dims=(3, 4), v_conditioning_type="common_mlp",
           v_embed_no_s_gelu=True, v_embedding_dim=8, t_embedding_dim=8)


def test_cunet_noncommon_conditioning():
    """Raw v vectors feed every block's projections."""
    _check(SHAPE, v_dims=(6,), v_conditioning_dims=(6,),
           v_conditioning_type="separate_linear")


def test_cunet_deeper_with_dropout_modules():
    """Two blocks a level and dropout > 0: the Dropout module moves each
    block's second conv to net2.3; the forward stays deterministic (in
    train mode too), as the JAX package's default."""
    tm, got = _check(SHAPE, num_res_blocks=2, dropout_prob=0.1)
    assert "downs.0.resnet_blocks.1.net2.3.weight" in tm.state_dict()
    x, _ = _inputs(SHAPE)
    with torch.no_grad():
        np.testing.assert_array_equal(tm(torch.from_numpy(x)).numpy(), got)
        dropped = tm(torch.from_numpy(x), deterministic=False,
                     generator=None).numpy()
    assert np.abs(dropped - got).max() > 0


def test_cunet_3d():
    """The volumetric path: 3x3x3 convs, kernel-2 stride-2 resamples over
    three axes, conditioning broadcast over the three spatial axes."""
    _check((8, 8, 8, 3), t=0.4, v_dims=(5,), chs=(8, 12), mid_attn=False,
           t_conditioning=True, v_conditioning_dims=(5,), v_embedding_dim=8,
           t_embedding_dim=8)


def test_cunet_3d_s_conditioning_and_residual_out():
    _check((8, 8, 8, 2), s_ch=3, chs=(8, 12), mid_attn=False,
           s_conditioning_channels=3, out_channels=4)


def test_cunet_3d_mid_attn_refused():
    with pytest.raises(ValueError, match="3D attention"):
        CUNet(shape=(8, 8, 8, 2), chs=(8, 12), norm_groups=4, device="cpu")


def test_cunet_identity_at_init_and_scale_params():
    """With out_channels == in_channels the zero-init output conv makes the
    net the identity at init; scale_params scales every parameter."""
    tm = CUNet(shape=(8, 8, 3), chs=(4, 6), norm_groups=2, mid_attn=False,
               dropout_prob=0.0, device="cpu", seed=3)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    scale_params(tm, 0.02)
    for k, v in tm.state_dict().items():
        torch.testing.assert_close(v, before[k] * 0.02)
    x = torch.randn(2, 8, 8, 3)
    with torch.no_grad():
        torch.testing.assert_close(tm(x), x, atol=1e-6, rtol=0)


def test_cunet_v_augment_draws_from_the_generator():
    tm = CUNet(shape=(8, 8, 3), chs=(4, 6), norm_groups=2, mid_attn=False,
               v_conditioning_dims=(5,), v_embedding_dim=4, v_augment=True,
               v_conditioning_type="common_linear", dropout_prob=0.0,
               device="cpu")
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(0.05 * torch.randn(p.shape,
                                      generator=torch.Generator()
                                      .manual_seed(p.numel())))
        x, v = torch.ones(2, 8, 8, 3), [torch.ones(2, 5)]

        def run(seed):
            return tm(x, v_conditionings=v,
                      generator=torch.Generator().manual_seed(seed))

        torch.testing.assert_close(run(2), run(2), atol=0, rtol=0)
        assert (run(2) - run(3)).abs().max() > 0
    with pytest.raises(ValueError, match="generator"):
        tm(x, v_conditionings=v)


@pytest.mark.parametrize("t_conditioning,v_dims", [(True, (3,)),
                                                    (False, (4, 2)),
                                                    (True, ())])
def test_cmlp(t_conditioning, v_dims):
    kw = dict(in_dim=6, out_dim=5, h_dims=(16, 12),
              v_conditioning_dims=v_dims, t_conditioning=t_conditioning,
              t_embedding_dim=8)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 6)).astype(np.float32)
    inputs = {}
    if t_conditioning:
        inputs["t"] = rng.random(3).astype(np.float32)
    if v_dims:
        inputs["v_conditionings"] = [rng.standard_normal((3, d)).astype(
            np.float32) for d in v_dims]
    params, tm = through_jax(
        nudge(CMLP(device="cpu", seed=0, **kw)), params_from_torch_cmlp,
        cmlp_state_dict_from_jax, lambda: CMLP(device="cpu", seed=1, **kw))
    want = np.asarray(JaxCMLP(**kw).apply({"params": params},
                                          jnp.asarray(x), **_jax(inputs)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), **_torch(inputs)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_timestep_embedding():
    t = np.array([0.0, 0.013, 0.5, 0.999], np.float32)
    for dim in (8, 64):
        want = np.asarray(jax_timestep_embedding(jnp.asarray(t), dim))
        got = timestep_embedding(torch.from_numpy(t), dim).numpy()
        np.testing.assert_allclose(got, want, **TOL)
