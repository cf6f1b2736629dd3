"""The port's codec export (tempo_tpu_torch/infer/export_codec.py,
cli/export_codec.py) on the CPU, against the port's eager model and the
JAX package's StableHLO export of the same weights.

Mirrors tests/test_export.py::test_export_roundtrip (its TINY config, tile
16) and tests/test_e2e.py::test_export_codec_cli at tiny size. Tolerances:
the port's artifacts against its eager model, atol 1e-6 (the same ops on
the same device); against JAX's artifacts, rtol 1e-4 and atol 1e-4, the
VAE parity tolerance (tests/test_torch_vae.py)."""

import json
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from tempo_tpu.infer.export_codec import export_codec as jax_export_codec
from tempo_tpu.infer.export_codec import load_exported as jax_load_exported
from tempo_tpu.interop.torch_ckpt import params_from_torch_state_dict
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu_torch.infer.export_codec import export_codec, load_exported
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig

torch.set_num_threads(1)

TINY = dict(shape=(8, 16, 16), chs=(12, 8, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
TILE = (16, 16)
JAX_TOL = dict(rtol=1e-4, atol=1e-4)
META_KEYS = ("spectral_channels", "tile_hw", "latent_hw", "embed_dim",
             "downsample_factor", "compute_dtype")


def _port_model(cfg=TINY, seed=0):
    """The port's VAE with every parameter nudged off its init (the
    zero-init output convs included), so each layer shapes the output."""
    model = AutoencoderKL(VAEConfig(**cfg), device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _x(batch, seed):
    return np.random.default_rng(seed).standard_normal(
        (batch, *TILE, TINY["shape"][0])).astype(np.float32)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    model = _port_model()
    out = export_codec(model, tmp_path_factory.mktemp("codec"), tile_hw=TILE)
    return model, out


def test_artifacts_and_meta(exported):
    _, out = exported
    assert (out / "encode.pt2").exists() and (out / "decode.pt2").exists()
    meta = json.loads((out / "meta.json").read_text())
    assert set(META_KEYS) <= set(meta)
    assert meta["spectral_channels"] == 8 and meta["downsample_factor"] == 4
    assert meta["tile_hw"] == [16, 16] and meta["latent_hw"] == [4, 4]
    assert meta["format"] == "torch.export"
    assert meta["devices"] == ["cpu", "cuda"]


@pytest.mark.parametrize("batch", [2, 5])
def test_exported_equals_eager(exported, batch):
    """One artifact, a symbolic batch: encode and decode equal the eager
    model's within 1e-6 at batches 2 and 5."""
    model, out = exported
    encode, decode, _ = load_exported(out, device="cpu")
    x = torch.from_numpy(_x(batch, batch))
    with torch.no_grad():
        want_z = model.encode(x).mean
        want_rec = model.decode(want_z)
    got_z = encode(x)
    got_rec = decode(got_z)
    assert got_z.shape == (batch, 4, 4, 4) and got_rec.shape == x.shape
    np.testing.assert_allclose(got_z.numpy(), want_z.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_rec.numpy(), want_rec.numpy(), atol=1e-6)


def test_export_packs_exactly_the_convs_k2_reads(monkeypatch):
    """Inside packed_for_export, the convs holding a packed weight are the
    ones whose weight reaches a K2 call, each with its packed buffer (the
    encoder's first conv, which no K2 call reads, holds none); outside it
    none holds one."""
    from tempo_tpu_torch.nn import blocks
    from tempo_tpu_torch.ops import cuda_gn_conv

    model = _port_model()
    reached = {}
    real = cuda_gn_conv.gn_act_conv3x3

    def spy(x, scale, bias, weight, *args, packed=None, **kwargs):
        reached[id(weight)] = packed
        return real(x, scale, bias, weight, *args, packed=packed, **kwargs)

    monkeypatch.setattr(cuda_gn_conv, "gn_act_conv3x3", spy)
    convs = [m for m in model.modules() if isinstance(m, blocks.Conv2d)]
    with torch.no_grad(), blocks.packed_for_export(model):
        packed = {id(m.weight): m.export_packed for m in convs
                  if m.export_packed is not None}
        model.decode(model.encode(torch.from_numpy(_x(1, 0))).mean)
    assert packed.keys() == reached.keys()
    assert all(reached[k] is packed[k] for k in packed)
    assert id(model.encoder.conv_in.weight) not in packed
    assert all(m.export_packed is None for m in convs)


def test_a_trace_outside_packed_for_export_raises():
    """torch.export of the model without packed_for_export raises instead
    of packing K2's weights at every call of the program."""
    from tempo_tpu_torch.infer.export_codec import _Encode

    with torch.no_grad(), pytest.raises(RuntimeError,
                                        match="packed_for_export"):
        torch.export.export(_Encode(_port_model()).eval(),
                            (torch.zeros(2, *TILE, 8),), strict=False)


@pytest.fixture(scope="module")
def jax_exported(exported, tmp_path_factory):
    """JAX's export_codec of the same weights (params_from_torch_state_dict
    of the port's state dict)."""
    model, _ = exported
    jcfg = JaxConfig(**TINY)
    template = JaxVAE(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, *TILE, 8), jnp.float32),
        rng=jax.random.PRNGKey(1))["params"]
    params = serialization.from_state_dict(
        template, params_from_torch_state_dict(model.state_dict()))
    out = jax_export_codec(params, jcfg, tmp_path_factory.mktemp("jax"),
                           tile_hw=TILE)
    return jax_load_exported(out)


@pytest.mark.parametrize("batch", [2, 5])
def test_exported_equals_jax_artifacts(exported, jax_exported, batch):
    _, out = exported
    encode, decode, meta = load_exported(out, device="cpu")
    jencode, jdecode, jmeta = jax_exported
    for key in META_KEYS:
        assert meta[key] == jmeta[key], key
    x = _x(batch, 10 + batch)
    jz = jencode(jnp.asarray(x))
    z = encode(torch.from_numpy(x))
    assert tuple(z.shape) == tuple(jz.shape)
    assert str(z.dtype).split(".")[-1] == str(jz.dtype)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **JAX_TOL)
    jrec = jdecode(jz)
    rec = decode(torch.from_numpy(np.array(jz)))
    assert tuple(rec.shape) == tuple(jrec.shape)
    assert str(rec.dtype).split(".")[-1] == str(jrec.dtype)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **JAX_TOL)


def test_loading_needs_no_model_code(exported):
    """A process that loads and runs the artifacts imports neither jax nor
    the port's models or nn."""
    _, out = exported
    code = textwrap.dedent(f"""
        import sys, torch
        from tempo_tpu_torch.infer.export_codec import load_exported
        encode, decode, meta = load_exported({str(out)!r}, device="cpu")
        x = torch.randn(3, 16, 16, meta["spectral_channels"])
        rec = decode(encode(x))
        assert rec.shape == x.shape and torch.isfinite(rec).all()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "tempo_tpu")
                     or m.startswith(("tempo_tpu_torch.models",
                                      "tempo_tpu_torch.nn")))
        print(bad)
        sys.exit(1 if bad else 0)
        """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_export_codec_cli(tmp_path):
    """cli/export_codec.run on a .pt checkpoint of the port's
    save_checkpoint: the artifacts rehydrate without model code and
    roundtrip a batch, equal to the checkpoint's eager model."""
    from tempo_tpu_torch.cli.export_codec import main
    from tempo_tpu_torch.train.checkpoint import save_checkpoint
    from tempo_tpu_torch.train.state import create_train_state, make_optimizer

    model_cfg = dict(TINY, shape=[16, 16, 16], chs=[16, 12, 8])
    model = _port_model(model_cfg, seed=3)
    ckpt = save_checkpoint(tmp_path / "run" / "checkpoints",
                           create_train_state(model, make_optimizer()))
    (tmp_path / "run" / "config.yaml").write_text(
        json.dumps({"model": model_cfg}))
    cfg = tmp_path / "export.yaml"
    cfg.write_text(json.dumps({
        "output_dir": str(tmp_path / "export"),
        "model": {"checkpoint_path": str(ckpt),
                  "training_config_path": str(tmp_path / "run" /
                                              "config.yaml")}}))
    main(str(cfg), device="cpu")
    assert (tmp_path / "export" / "config.yaml").exists()

    encode, decode, meta = load_exported(tmp_path / "export" / "codec",
                                         device="cpu")
    tile = meta["tile_hw"][0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (3, tile, tile, meta["spectral_channels"])).astype(np.float32))
    z = encode(x)
    assert tuple(z.shape) == (3, *meta["latent_hw"], meta["embed_dim"])
    rec = decode(z)
    assert rec.shape == x.shape and torch.isfinite(rec).all()
    with torch.no_grad():
        np.testing.assert_allclose(z.numpy(), model.encode(x).mean.numpy(),
                                   atol=1e-6)
