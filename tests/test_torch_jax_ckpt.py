"""The JAX checkpoint bridge of the port (tempo_tpu_torch/interop/
{msgpack_reader,jax_ckpt}.py, train/checkpoint.py ``load_params``) on the
CPU, against the JAX package:

- the reader gives what ``flax.serialization.msgpack_restore`` gives on
  payloads flax writes (every dtype the trainers save, numpy scalars,
  nested and empty dicts, negative and 64-bit ints, strings, bins, lists,
  complex numbers, chunked arrays, a whole JAX trainer checkpoint), with
  bfloat16 widened exactly to float32;
- ``load_params`` of a checkpoint written by the JAX package's
  ``save_checkpoint`` gives each port model (VAE, L2 VAE, VDM over a CUNet
  and over a CMLP, SFM, GPT) the JAX model's output within the fp32
  tolerances of the models' own tests (test_torch_vae.py,
  test_torch_vae_l2.py, test_torch_diffusion.py, test_torch_transformer.py),
  and the weights the JAX tree was made from, bit for bit;
- ``export_lm`` over a JAX GPT run directory serves JAX's greedy tokens.
The JAX trees are made from seeded port models through the JAX package's
own readers of reference checkpoints (tempo_tpu/interop/{torch_ckpt,
unet_ckpt,gpt_ckpt}.py), so no JAX model is initialized.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from tempo_tpu.interop.gpt_ckpt import params_from_torch_transformer
from tempo_tpu.interop.torch_ckpt import (l2_params_from_torch_state_dict,
                                          params_from_torch_state_dict)
from tempo_tpu.interop.unet_ckpt import (params_from_torch_cunet,
                                         params_from_torch_vdm)
from tempo_tpu.models import diffusion as jd
from tempo_tpu.models import flow as jf
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.models.vae_l2 import VAEWithL2Head as JaxL2
from tempo_tpu.nn import transformer as jt
from tempo_tpu.nn.unet import CMLP as JaxCMLP
from tempo_tpu.nn.unet import CUNet as JaxCUNet
from tempo_tpu.train import checkpoint as jckpt
from tempo_tpu.train import state as jstate
from tempo_tpu_torch.interop import msgpack_reader
from tempo_tpu_torch.interop.jax_ckpt import (jax_state_dict_for,
                                              read_jax_checkpoint)
from tempo_tpu_torch.models import diffusion as pd
from tempo_tpu_torch.models import flow as pf
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.nn.unet import CMLP, CUNet
from tempo_tpu_torch.train.checkpoint import (latest_checkpoint,
                                              list_checkpoints,
                                              load_checkpoint, load_params)
from tempo_tpu_torch.train.state import create_train_state

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
HIDDEN = (16, 16)
VAE_TOL = dict(rtol=1e-4, atol=1e-4)   # test_torch_vae.py
L2_REL = 1e-5                          # test_torch_vae_l2.py
LOSS_REL = 1e-4                        # test_torch_diffusion.py
GPT_REL = 1e-5                         # test_torch_transformer.py
SHAPE = (8, 8, 3)
SCORE = dict(chs=(8, 12), norm_groups=4, n_attention_heads=2,
             dropout_prob=0.0, t_conditioning=True, t_embedding_dim=8)


# ------------------------------------------------------------- the reader

def _same(got, want, path="") -> None:
    """``got`` (the port's reader) is ``want`` (flax's): the same tree,
    types, dtypes, shapes and bits; flax's bfloat16 as exact float32."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), path
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype == jnp.bfloat16:
            assert got.dtype == np.float32, path
            want = (np.float32(want) if isinstance(want, np.generic)
                    else np.asarray(want, np.float32))
        assert type(got) is type(want) and got.dtype == want.dtype, path
        assert np.shape(got) == np.shape(want), path
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes(), path
    else:
        assert type(got) is type(want) and got == want, path


def _payload() -> dict:
    rng = np.random.default_rng(0)
    return {
        "params": {"dense": {"kernel": rng.standard_normal((3, 5)).astype(
            np.float32), "bias": np.zeros(5, np.float32)},
            "logvar": np.asarray(6.0, np.float32)},
        "bf16": np.asarray(jnp.asarray(rng.standard_normal((4, 3)),
                                       jnp.bfloat16)),
        "bf16_0d": jnp.bfloat16(-2.75),  # a 0-d array
        "bf16_scalar": np.asarray(jnp.bfloat16(0.3125))[()],
        "f64": rng.standard_normal(7),
        "f16": rng.standard_normal(3).astype(np.float16),
        "i32": np.arange(-3, 3, dtype=np.int32),
        "i64": np.asarray([-2 ** 40, 2 ** 40], np.int64),
        "u8": np.arange(256, dtype=np.uint8),
        "mask": np.asarray([True, False]),
        "rng": np.asarray([0, 4294967295], np.uint32),  # a PRNG key
        "scalars": {"f32": np.float32(1.5), "i64": np.int64(-7),
                    "u32": np.uint32(3), "bool": np.bool_(True)},
        "empty": {}, "nested": {"a": {"b": {}}},
        "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63,
                 -1, -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1,
                 -2 ** 63],
        "floats": [0.5, -1e300, 3.0],
        "strs": ["", "é", "x" * 31, "y" * 32, "z" * 300, "w" * 70000],
        "none": None, "yes": True, "no": False,
        "bytes": {"short": b"\x00\x01", "long": bytes(range(256)) * 300},
        "complex": 1.5 - 2j,
        "metrics": json.dumps([{"step": 1, "loss": 0.5}]),
        "many": {str(i): i for i in range(70)},  # map16
        "list16": list(range(20)),
    }


def test_reader_equals_msgpack_restore():
    data = serialization.msgpack_serialize(_payload())
    got = msgpack_reader.restore(data)
    _same(got, serialization.msgpack_restore(data))
    assert got["bf16_0d"] == np.float32(-2.75)
    assert type(got["bf16_scalar"]) is np.float32
    assert got["bf16_scalar"] == np.float32(0.3125)


def test_reader_joins_chunked_arrays(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "deep": {"w": np.arange(70, dtype=np.int64)},
            "small": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = msgpack_reader.restore(data)
    _same(got, serialization.msgpack_restore(data))
    assert got["big"].shape == (4, 25)


def test_reader_refuses_broken_data():
    data = serialization.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="ends inside"):
        msgpack_reader.restore(data[:-3])
    with pytest.raises(ValueError, match="after the msgpack"):
        msgpack_reader.restore(data + b"\xc0")
    with pytest.raises(ValueError, match="not a msgpack type"):
        msgpack_reader.restore(b"\xc1")


def _jax_checkpoint(tmp: Path, params, step: int = 5) -> Path:
    """A checkpoint of the JAX package's trainer: its save_checkpoint of a
    TrainState over ``params`` with AdamW's state, an EMA and histories."""
    tx = jstate.make_optimizer(lr=1e-3)
    state = jstate.create_train_state(params, tx, jax.random.PRNGKey(0))
    state = state.replace(step=jnp.asarray(step, jnp.int32),
                          ema={"loss": jnp.asarray(0.25, jnp.float32)})
    return jckpt.save_checkpoint(tmp / "checkpoints", state,
                                 [{"step": step, "loss": 0.25}], [])


def _nudged_vae(cls, *args, seed=0, **kw):
    model = cls(*args, device="cpu", seed=seed, **kw)
    gen = torch.Generator().manual_seed(seed + 7)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _bitwise(model, seeded) -> None:
    want = seeded.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_reader_equals_msgpack_restore_on_a_trainer_checkpoint(tmp_path):
    seeded = _nudged_vae(AutoencoderKL, VAEConfig(**TINY))
    path = _jax_checkpoint(tmp_path, params_from_torch_state_dict(
        seeded.state_dict(), n_levels=3))
    raw = read_jax_checkpoint(path)
    _same(raw, serialization.msgpack_restore(path.read_bytes()))
    assert raw["step"] == 5 and raw["ema"] == {"loss": 0.25}
    assert json.loads(raw["train_metrics"]) == [{"step": 5, "loss": 0.25}]
    with pytest.raises(ValueError, match="no 'params'"):
        (tmp_path / "x.msgpack").write_bytes(
            serialization.msgpack_serialize({"a": 1}))
        read_jax_checkpoint(tmp_path / "x.msgpack")


# -------------------------------------------- load_params, model by model

def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("dropout", [0.0, 0.1], ids=["vae", "vae_dropout"])
def test_load_params_vae(tmp_path, dropout):
    cfg = dict(TINY, dropout_prob=dropout)
    seeded = _nudged_vae(AutoencoderKL, VAEConfig(**cfg))
    params = params_from_torch_state_dict(seeded.state_dict(), n_levels=3)
    path = _jax_checkpoint(tmp_path, params)
    model = load_params(path, AutoencoderKL(VAEConfig(**cfg), device="cpu",
                                            seed=9))
    _bitwise(model, seeded)
    if dropout:
        assert any(".net2.3." in k for k in model.state_dict())
        return
    c, h, w = TINY["shape"]
    x = np.random.default_rng(5).standard_normal((2, h, w, c)).astype(
        np.float32)
    want = JaxVAE(JaxConfig(**TINY)).apply(
        {"params": params}, jnp.asarray(x), sample_posterior=False,
        method=JaxVAE.reconstruct)
    with torch.no_grad():
        got = model.reconstruct(torch.from_numpy(x), sample_posterior=False)
    np.testing.assert_allclose(_np(got), np.asarray(want), **VAE_TOL)


def test_load_params_l2_vae_and_its_vae_half(tmp_path):
    seeded = _nudged_vae(VAEWithL2Head, VAEConfig(**TINY), HIDDEN)
    params = l2_params_from_torch_state_dict(seeded.state_dict(),
                                             mlp_hidden=HIDDEN, n_levels=3)
    path = _jax_checkpoint(tmp_path, params)
    model = load_params(path, VAEWithL2Head(VAEConfig(**TINY), HIDDEN,
                                            device="cpu", seed=9))
    _bitwise(model, seeded)
    base = load_params(path, AutoencoderKL(VAEConfig(**TINY), device="cpu",
                                           seed=8))
    _bitwise(base, seeded.vae)
    c, h, w = TINY["shape"]
    x = np.random.default_rng(6).standard_normal((2, h, w, c)).astype(
        np.float32)
    jm = JaxL2(JaxConfig(**TINY), mlp_hidden=HIDDEN)
    v = {"params": params}
    mean = jm.apply(v, jnp.asarray(x), method=JaxL2.encode).mean
    want = jm.apply(v, mean, method=lambda m, z: m.l2_head(z))
    with torch.no_grad():
        got_mean = model.encode(torch.from_numpy(x)).mean
        got = model.l2_head(got_mean)
    np.testing.assert_allclose(_np(got_mean), np.asarray(mean), **VAE_TOL)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=L2_REL,
                               atol=L2_REL)


def _draws(seed=5, b=4, shape=SHAPE):
    rng = np.random.default_rng(seed)
    x, noise, noise_0 = (rng.standard_normal((b, *shape)).astype(np.float32)
                         for _ in range(3))
    times = (0.0123 + np.arange(b) / b).astype(np.float32)
    return x, noise, noise_0, times


def _vdm_loss_close(model, jm, params, shape=SHAPE) -> None:
    x, noise, noise_0, times = _draws(shape=shape)
    want, _ = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(x), noise=jnp.asarray(noise),
        times=jnp.asarray(times), noise_0=jnp.asarray(noise_0),
        method=jd.VDM.get_loss))(params)
    with torch.no_grad():
        got, _ = model.get_loss(*(torch.from_numpy(a) for a in (x,)),
                                noise=torch.from_numpy(noise),
                                times=torch.from_numpy(times),
                                noise_0=torch.from_numpy(noise_0))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_REL)


def test_load_params_vdm_over_a_cunet(tmp_path):
    seeded = _nudged_vae(lambda device, seed: pd.VDM(
        CUNet(shape=SHAPE, device=device, seed=seed, **SCORE),
        "learned_nn", seed=seed))
    params = params_from_torch_vdm(seeded.state_dict(), n_levels=2)
    path = _jax_checkpoint(tmp_path, params)
    model = load_params(path, pd.VDM(CUNet(shape=SHAPE, device="cpu",
                                           seed=3, **SCORE), "learned_nn",
                                     seed=3))
    _bitwise(model, seeded)
    _vdm_loss_close(model, jd.VDM(JaxCUNet(shape=SHAPE, **SCORE),
                                  "learned_nn"), params)


def test_load_params_vdm_over_a_cmlp(tmp_path):
    kw = dict(in_dim=6, h_dims=(16,), t_conditioning=True, t_embedding_dim=8)
    seeded = _nudged_vae(lambda device, seed: pd.VDM(
        CMLP(device=device, seed=seed, **kw), "learned_linear", seed=seed))
    params = params_from_torch_vdm(seeded.state_dict(), score_kind="cmlp")
    path = _jax_checkpoint(tmp_path, params)
    model = load_params(path, pd.VDM(CMLP(device="cpu", seed=3, **kw),
                                     "learned_linear", seed=3))
    _bitwise(model, seeded)
    _vdm_loss_close(model, jd.VDM(JaxCMLP(**kw), "learned_linear"), params,
                    shape=(6,))


def test_load_params_sfm(tmp_path):
    score = dict(SCORE, s_conditioning_channels=SHAPE[-1])
    seeded = _nudged_vae(lambda device, seed: pf.SFM(
        CUNet(shape=SHAPE, device=device, seed=seed, **score)))
    params = {"velocity_model": params_from_torch_cunet(
        {k[len("velocity_model."):]: v
         for k, v in seeded.state_dict().items()}, n_levels=2)}
    path = _jax_checkpoint(tmp_path, params)
    model = load_params(path, pf.SFM(CUNet(shape=SHAPE, device="cpu",
                                           seed=3, **score)))
    _bitwise(model, seeded)
    rng = np.random.default_rng(7)
    x0, x1, eps = (rng.standard_normal((2, *SHAPE)).astype(np.float32)
                   for _ in range(3))
    t = np.asarray([0.25, 0.75], np.float32)
    want = jf.SFM(JaxCUNet(shape=SHAPE, **score)).apply(
        {"params": params}, jnp.asarray(x0), jnp.asarray(x1),
        t=jnp.asarray(t), epsilon=jnp.asarray(eps),
        method=jf.SFM.compute_loss)
    with torch.no_grad():
        got = model.compute_loss(*(torch.from_numpy(a) for a in (x0, x1)),
                                 t=torch.from_numpy(t),
                                 epsilon=torch.from_numpy(eps))
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_REL)


GPT = dict(in_size=29, block_size=16, n_layer=2, n_head=2, n_embd=32)


def _gpt_params(seed=0):
    pcfg, jcfg = pt.TransformerConfig(**GPT), jt.TransformerConfig(**GPT)
    seeded = pt.Transformer(pcfg, device="cpu", seed=seed)
    return seeded, params_from_torch_transformer(seeded.state_dict(), jcfg)


def test_load_params_gpt(tmp_path):
    seeded, params = _gpt_params()
    path = _jax_checkpoint(tmp_path, params)
    model = load_params(path, pt.Transformer(pt.TransformerConfig(**GPT),
                                             device="cpu", seed=4))
    _bitwise(model, seeded)
    toks = np.random.default_rng(2).integers(0, 29, (2, 9)).astype(np.int32)
    want = np.asarray(jt.Transformer(jt.TransformerConfig(**GPT)).apply(
        {"params": params}, jnp.asarray(toks)), np.float64)
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).double().numpy()
    assert np.abs(got - want).max() / np.abs(want).max() <= GPT_REL


def test_the_bridge_names_what_it_cannot_take(tmp_path):
    seeded, params = _gpt_params()
    path = _jax_checkpoint(tmp_path, params)
    with pytest.raises(TypeError, match="Linear"):
        jax_state_dict_for(torch.nn.Linear(2, 2), params)
    # the full state resumes (tests/test_torch_msgpack_resume.py holds
    # every optimizer layout against JAX's next step)
    model = pt.Transformer(pt.TransformerConfig(**GPT), device="cpu", seed=4)
    tx = pt.make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95))
    state, train_m, val_m = load_checkpoint(
        path, create_train_state(model, tx, 0))
    _bitwise(model, seeded)
    assert state.step == 5 and state.ema["loss"].item() == 0.25
    assert (train_m, val_m) == ([{"step": 5, "loss": 0.25}], [])
    assert all(float(st["step"]) == 0.0 and not st["exp_avg"].any()
               for st in state.optimizer.state.values())
    (tmp_path / "checkpoints" / "ckpt_step=000002.pt").write_bytes(b"")
    assert [p.name for p in list_checkpoints(tmp_path / "checkpoints")] == [
        "ckpt_step=000002.pt", "ckpt_step=000005.msgpack"]
    assert latest_checkpoint(tmp_path / "checkpoints") == path


# ------------------------------------------------------------ end to end

def test_export_lm_over_a_jax_gpt_run(tmp_path):
    """A JAX train_gpt run directory (config.yaml, training_info.yaml, a
    .msgpack checkpoint): the port's export_lm reads its latest checkpoint,
    and the exported programs decode JAX's greedy tokens."""
    from tempo_tpu_torch.cli import export_lm
    from tempo_tpu_torch.infer.export_lm import greedy_decode_exported

    _, params = _gpt_params(seed=1)
    run = tmp_path / "jax_run"
    _jax_checkpoint(run, params, step=3)
    model_cfg = {k: v for k, v in GPT.items() if k != "in_size"}
    (run / "config.yaml").write_text(yaml.safe_dump({"model": model_cfg}))
    (run / "training_info.yaml").write_text(yaml.safe_dump(
        {"vocab_size": GPT["in_size"]}))
    cfg = tmp_path / "export.yaml"
    cfg.write_text(yaml.safe_dump({"run_dir": str(run),
                                   "output_dir": str(tmp_path / "out"),
                                   "decode_chunk": 0}))
    export_lm.main(str(cfg), device="cpu")
    info = yaml.safe_load((tmp_path / "out" / "export_info.yaml").read_text())
    assert info["checkpoint"].endswith("ckpt_step=000003.msgpack")
    prompt = np.asarray([[3, 1, 4, 1]], np.int64)
    got = greedy_decode_exported(tmp_path / "out" / "lm", prompt, 6,
                                 device="cpu")
    want = jt.generate(jt.Transformer(jt.TransformerConfig(**GPT)), params,
                       jnp.asarray(prompt, jnp.int32), 6,
                       rng=jax.random.PRNGKey(0), temperature=0.0)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
