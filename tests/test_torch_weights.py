"""The weight bridge (tempo_tpu_torch/interop/jax_params.py): JAX params ->
the port's reference-named state_dict, checked against the inverse in
tempo_tpu/interop/torch_ckpt.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.interop.torch_ckpt import params_from_torch_state_dict
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")


def _jax_params(cfg):
    c, h, w = cfg["shape"]
    params = JaxVAE(JaxConfig(**cfg)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, c)),
        rng=jax.random.PRNGKey(1))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("extra", [{}, {"attn_sizes": (8,),
                                        "num_res_blocks": 2}],
                         ids=["tiny", "attn_2res"])
def test_round_trip_is_bit_equal(extra):
    """JAX params -> state_dict -> torch_ckpt.params_from_torch_state_dict
    gives back the original tree, every leaf bit-equal."""
    cfg = dict(TINY, **extra)
    params = _jax_params(cfg)
    sd = state_dict_from_jax_params(params)
    back = params_from_torch_state_dict(
        sd, n_levels=len(cfg["chs"]),
        num_res_blocks=cfg.get("num_res_blocks", 1))
    a, b = _flatten(params), _flatten(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("extra", [{}, {"attn_sizes": (8,)},
                                   {"dropout_prob": 0.1}],
                         ids=["tiny", "attn", "dropout"])
def test_state_dict_names_and_shapes_match_the_port(extra):
    """The bridged state_dict has exactly the port module's names and
    shapes (the reference model's), so load_state_dict is strict."""
    cfg = dict(TINY, **extra)
    sd = state_dict_from_jax_params(_jax_params(cfg),
                                    dropout="dropout_prob" in extra)
    port = AutoencoderKL(VAEConfig(**cfg), device="cpu").state_dict()
    assert sd.keys() == port.keys()
    for k in sd:
        assert sd[k].shape == port[k].shape, k
    assert ("encoder.mid1.net2.3.weight" in sd) == ("dropout_prob" in extra)
    AutoencoderKL(VAEConfig(**cfg), device="cpu").load_state_dict(sd)


def test_layouts():
    """Spot checks of each layout conversion against its definition."""
    params = _jax_params(TINY)
    sd = state_dict_from_jax_params(params)
    enc = params["encoder"]
    # HWIO -> OIHW
    np.testing.assert_array_equal(
        sd["encoder.conv_in.weight"][5, 3, 2, 1].item(),
        enc["conv_in"]["kernel"][2, 1, 3, 5])
    # dense [in, out] -> [out, in, 1, 1]
    np.testing.assert_array_equal(
        sd["quant_conv.weight"][:, :, 0, 0].numpy(),
        params["quant_conv"]["kernel"].T)
    # s2d kernel [(kh, kw, cin), cout] -> [out, in, 2, 2]
    kd = enc["down0"]["down_kernel"]
    cin = kd.shape[0] // 4
    np.testing.assert_array_equal(
        sd["encoder.downs.0.down.weight"][7, 2, 1, 0].item(),
        kd[(1 * 2 + 0) * cin + 2, 7])
    # d2s kernel [cin, (di, dj, cout)] -> ConvTranspose [in, out, 2, 2]
    ku = params["decoder"]["up0"]["up_kernel"]
    cout = ku.shape[1] // 4
    np.testing.assert_array_equal(
        sd["decoder.ups.0.up.weight"][3, 5, 0, 1].item(),
        ku[3, (0 * 2 + 1) * cout + 5])
    assert sd["logvar"].shape == () and float(sd["logvar"]) == 6.0
