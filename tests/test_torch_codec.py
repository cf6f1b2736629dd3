"""The port's GranuleCodec (tempo_tpu_torch/infer/granule_codec.py) and its
numpy helpers against the JAX package, on the CPU at f32.

The codec normalizes with the torch normalize_radiance on its device: its
crop is held within 1e-4 abs of the JAX package's numpy one, and no
farther from a float64 normalize than that one is, plus 1e-5
(tests/test_torch_granule.py states the rule)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.data.normalize import normalize_radiance as jax_normalize
from tempo_tpu.infer.granule_codec import GranuleCodec as JaxCodec
from tempo_tpu.infer.granule_codec import crop_to_multiple as jax_crop
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu_torch.data.normalize import normalize_radiance
from tempo_tpu_torch.infer.granule_codec import GranuleCodec, crop_to_multiple
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
TOL = dict(atol=1e-4, rtol=0)


def assert_near_numpy_normalize(got, rad, mean, std, multiple=16):
    """The codec's crop against the numpy normalize's and a float64 one."""
    want = jax_crop(jax_normalize(rad, mean, std), multiple)
    z64 = jax_crop(np.clip((np.log(np.clip(rad.astype(np.float64), 1.0, None))
                            - mean.astype(np.float64))
                           / (std.astype(np.float64) + 1e-8), -10, 10),
                   multiple)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.abs(got - z64).max() <= np.abs(want - z64).max() + 1e-5


def _radiance(shape, seed):
    rng = np.random.default_rng(seed)
    return np.exp(rng.normal(3.0, 1.0, shape)).astype(np.float32)


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
    mean = rng.normal(3.0, 0.1, 12).astype(np.float32)
    std = rng.uniform(0.8, 1.2, 12).astype(np.float32)
    return (JaxCodec(jm, params, mean, std, multiple=16),
            GranuleCodec(port, mean, std, multiple=16, device="cpu"))


def test_crop_and_normalize_are_bit_equal():
    rad = _radiance((37, 70, 12), 1)
    rad[0, 0, :3] = 0.0  # clamped at min_radiance
    np.testing.assert_array_equal(crop_to_multiple(rad, 16),
                                  jax_crop(rad, 16))
    for stats in [(None, None), (np.full(12, 3.0, np.float32),
                                 np.full(12, 0.5, np.float32))]:
        np.testing.assert_array_equal(normalize_radiance(rad, *stats),
                                      jax_normalize(rad, *stats))


def test_codec_matches_jax(codecs):
    jc, pc = codecs
    gt = jc.normalize(_radiance((37, 70, 12), 2))
    assert gt.shape == (32, 64, 12)
    assert_near_numpy_normalize(pc.normalize(_radiance((37, 70, 12), 2)),
                                _radiance((37, 70, 12), 2), pc.mean_spectrum,
                                pc.std_spectrum)
    jlat = np.asarray(jc.encode(gt))
    plat = pc.encode(gt)
    assert plat.shape == (8, 16, 4)
    np.testing.assert_allclose(plat.numpy(), jlat, **TOL)
    jpost, ppost = jc.encode_posterior(gt), pc.encode_posterior(gt)
    np.testing.assert_allclose(ppost.logvar.numpy(),
                               np.asarray(jpost.logvar), **TOL)
    np.testing.assert_allclose(pc.decode(jlat), jc.decode(jlat), **TOL)
    np.testing.assert_allclose(pc.reconstruct(gt, sample_posterior=False),
                               jc.reconstruct(gt, sample_posterior=False),
                               **TOL)
    rad = _radiance((40, 50, 12), 3)
    jgt, jrec = jc.reconstruct_raw(rad, sample_posterior=False)
    pgt, prec = pc.reconstruct_raw(rad, sample_posterior=False)
    assert_near_numpy_normalize(pgt, rad, pc.mean_spectrum, pc.std_spectrum)
    assert prec.shape == (32, 48, 12)
    np.testing.assert_allclose(prec, jrec, **TOL)


def test_sampled_reconstruction_is_seeded(codecs):
    _, pc = codecs
    gt = pc.normalize(_radiance((32, 32, 12), 4))
    a = GranuleCodec(pc.model, multiple=16, seed=5, device="cpu")
    b = GranuleCodec(pc.model, multiple=16, seed=5, device="cpu")
    ra, rb = a.reconstruct(gt), b.reconstruct(gt)
    np.testing.assert_array_equal(ra, rb)
    assert not np.array_equal(ra, a.reconstruct(gt))  # the stream advances
    assert np.isfinite(ra).all() and ra.shape == gt.shape
