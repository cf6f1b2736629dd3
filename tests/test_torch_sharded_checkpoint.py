"""The port's sharded checkpoint (tempo_tpu_torch/train/sharded_checkpoint.py:
``ckpt_step=NNNNNN.shards/`` in the JAX package's format) against the JAX
package's (tempo_tpu/train/sharded_checkpoint.py), both ways, with the
port's ranks as gloo processes on the CPU (tests/torch_parallel_workers.py).

JAX's recipe (tests/test_parallel.py:355): the tiny VAE, TP over a model
axis of 4 on its 8-device mesh, an EMA, one step, a sharded save. The
port's two ranks, TP over a model axis of 2, load that directory; take a
step; write their own directory, each rank its own bytes, with every
whole-leaf gather of the port refused while they do; and resume from it.
JAX's loaders read the port's directory. In the same launch a JAX
``.msgpack`` full state resumes under FSDP2, and FSDP2's dim-0 shards are
written in the format and read back. Equalities are bitwise: the layouts
only move bytes."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import torch_parallel_workers as workers
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.parallel.mesh import make_place_fn
from tempo_tpu.parallel.tensor import create_tp_mesh, shard_state_tp
from tempo_tpu.train import checkpoint as jckpt
from tempo_tpu.train import sharded_checkpoint as jsharded
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.train import checkpoint as pckpt
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep
from tempo_tpu_torch.train.sharded_checkpoint import save_checkpoint_sharded

torch.set_num_threads(1)

# tests/test_parallel.py's TINY
TINY = dict(shape=(8, 16, 16), chs=(12, 8, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
B = 8

_RUNS: dict = {}


def _once(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _setup():
    model = JaxVAE(JaxConfig(**TINY))
    x = jnp.zeros((8, 16, 16, 8), jnp.float32)
    params = model.init(jax.random.PRNGKey(0), x,
                        rng=jax.random.PRNGKey(1))["params"]
    tx = jstate.make_optimizer(lr=1e-3)
    return model, tx, jstate.create_train_state(params, tx,
                                                jax.random.PRNGKey(42))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _adam(opt_state) -> dict:
    return serialization.to_state_dict(opt_state)["1"]["0"]


def _case(tmp_path_factory):
    def make():
        root = tmp_path_factory.mktemp("sharded")
        model, tx, state = _setup()
        mesh = create_tp_mesh(n_model=4)
        state = jstep.init_ema(shard_state_tp(state, mesh), ["loss"])
        step = jstep.make_train_step(jstep.vae_loss_fn(model), tx,
                                     donate=False)
        batch = np.random.default_rng(9).standard_normal(
            (B, 16, 16, 8)).astype(np.float32)
        state, _ = step(state, make_place_fn(mesh)(batch))
        jax_dir = jsharded.save_checkpoint_sharded(
            root / "jax", state, train_metrics=[{"step": 1, "loss": 1.0}])
        msgpack = jckpt.save_checkpoint(root / "jax_mp", state)
        one = _one_process(root, batch)
        got = workers.launch(workers.sharded_checkpoints, 2, root / "port",
                             TINY, str(jax_dir), str(msgpack), batch,
                             str(root / "port"), one["files"])
        return state, got, one
    return _once("case", make)


def _one_process(root, batch) -> dict:
    """The port on one process: a step, the state saved as a .pt and as
    a directory, then the next step (what a resume of either must give)."""
    tx = pstate.make_optimizer(lr=1e-3)
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=5)
    state = pstate.create_train_state(model, tx, 13)
    state.ema = {}
    step = pstep.make_train_step(pstep.vae_loss_fn(model), tx)
    x = torch.from_numpy(batch)
    state, _ = step(state, x)
    files = {"pt": str(pckpt.save_checkpoint(root / "one_pt", state)),
             "shards": str(save_checkpoint_sharded(root / "one_shards",
                                                   state))}
    state, m = step(state, x)
    return {"files": files, "loss": float(m["loss"]),
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(torch.as_tensor(got[k]), torch.as_tensor(v)), k


def test_a_jax_tp_directory_loads_into_the_port_tp_state(tmp_path_factory):
    """JAX's directory (TP over 4) into the port's TP state over 2:
    parameters, AdamW's moments, step, EMA and history equal JAX's, and
    each rank holds its shards."""
    state, got, _ = _case(tmp_path_factory)
    want = state_dict_from_jax_params(_np(state.params))
    adam = _adam(_np(state.opt_state))
    mu = state_dict_from_jax_params(adam["mu"])
    nu = state_dict_from_jax_params(adam["nu"])
    for rank in got:
        _equal(rank["loaded"], want)
        _equal({k: m for k, (m, _) in rank["loaded_moments"].items()}, mu)
        _equal({k: n for k, (_, n) in rank["loaded_moments"].items()}, nu)
        assert rank["loaded_step"] == 1
        assert rank["train_metrics"] == [{"step": 1, "loss": 1.0}]
        assert set(rank["ema"]) == {"loss"}
        assert rank["local_shapes"]["encoder.conv_in.weight"] == (6, 8, 3, 3)
        assert rank["local_shapes"]["logvar"] == ()


def test_the_port_directory_is_jaxs_and_resumes_bitwise(tmp_path_factory):
    """The port's directory: written by both ranks with every whole-leaf
    gather refused, index.json last; JAX's load_checkpoint_sharded and
    load_params_sharded read it and equal the port's state; the port's
    own resume keeps each rank's shards and equals the live next step,
    bitwise; it is listed."""
    _, got, _ = _case(tmp_path_factory)
    rank0 = got[0]
    path = rank0["path"]
    index = json.loads(open(f"{path}/index.json").read())
    assert index["format"] == 1 and index["step"] == 2
    assert len(index["torch_generators"]) == 2
    assert [r["key"] for r in index["leaves"]] == sorted(
        r["key"] for r in index["leaves"])
    _, _, template = _setup()
    template = jstep.init_ema(shard_state_tp(template, create_tp_mesh(
        n_model=4)), ["loss"])
    restored, train_m, _ = jsharded.load_checkpoint_sharded(path, template)
    assert int(restored.step) == 2
    assert train_m == [{"step": 2, "loss": 1.0}]
    _equal(state_dict_from_jax_params(_np(restored.params)), rank0["saved"])
    adam = _adam(_np(restored.opt_state))
    _equal(state_dict_from_jax_params(adam["mu"]),
           {k: m for k, (m, _) in rank0["saved_moments"].items()})
    _equal(state_dict_from_jax_params(adam["nu"]),
           {k: n for k, (_, n) in rank0["saved_moments"].items()})
    assert int(adam["count"]) == 2
    params = jsharded.load_params_sharded(path, _setup()[2].params)
    _equal(state_dict_from_jax_params(_np(params)), rank0["saved"])
    for rank in got:
        assert rank["resumed_local_shapes"] == rank["local_shapes"]
        _equal(rank["resumed"], rank["live"])
        assert rank["resumed_metrics"] == rank["live_metrics"]
    ckpt_dir = f"{path}/.."
    assert [str(p) for p in pckpt.list_checkpoints(ckpt_dir)] == [
        str(pckpt.latest_checkpoint(ckpt_dir))]
    assert pckpt.checkpoint_step(path) == 2


def test_load_params_on_one_process_equals_the_gathered_weights(
        tmp_path_factory):
    """The port's directory and its TP .pt save each load on one device:
    load_params gives the gathered weights bitwise, load_checkpoint the
    state of the next step."""
    _, got, _ = _case(tmp_path_factory)
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=3)
    _equal(pckpt.load_params(got[0]["path"], model).state_dict(),
           got[0]["saved"])
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=4)
    state = pstate.create_train_state(model, pstate.make_optimizer(lr=1e-3))
    state, _, _ = pckpt.load_checkpoint(got[0]["pt"], state)
    _equal(model.state_dict(), got[0]["live"])
    assert state.step == 3


@pytest.mark.parametrize("fmt", ["pt", "shards"])
def test_a_one_process_checkpoint_resumes_at_tp_with_peers_drawing_alike(
        fmt, tmp_path_factory):
    """One process's .pt and directory (one generator state, not one a
    data rank) resumed at (1, 2): the model-axis peer takes rank 0's
    generator, so both ranks sample the same posterior and the next step
    equals one process's (a peer that kept its own seed would compute its
    output channels from another z)."""
    _, got, one = _case(tmp_path_factory)
    for rank in got:
        res = rank["one_process"][fmt]
        assert abs(res["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert set(res["params"]) == set(one["params"])
        for k, v in one["params"].items():
            torch.testing.assert_close(res["params"][k], v, atol=1e-5,
                                       rtol=1e-4, msg=k)


def test_a_jax_msgpack_full_state_resumes_under_fsdp2(tmp_path_factory):
    state, got, _ = _case(tmp_path_factory)
    want = state_dict_from_jax_params(_np(state.params))
    adam = _adam(_np(state.opt_state))
    for rank in got:
        _equal(rank["fsdp_params"], want)
        _equal({k: m for k, (m, _) in rank["fsdp_moments"].items()},
               state_dict_from_jax_params(adam["mu"]))
        assert rank["fsdp_step"] == 1


def test_fsdp2_shards_write_and_load_the_sharded_format(tmp_path_factory):
    """FSDP2's dim-0 shards, each rank its rows, no whole-leaf gather: the
    directory loads back into a fresh FSDP2 state and on one device,
    bitwise, and JAX's load_params_sharded reads it."""
    _, got, _ = _case(tmp_path_factory)
    for rank in got:
        _equal(rank["fsdp_loaded"], rank["fsdp_saved"])
        for k, (m, n) in rank["fsdp_saved_moments"].items():
            lm, ln = rank["fsdp_loaded_moments"][k]
            assert torch.equal(lm, m) and torch.equal(ln, n), k
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=6)
    _equal(pckpt.load_params(got[0]["fsdp_path"], model).state_dict(),
           got[0]["fsdp_saved"])
    params = jsharded.load_params_sharded(got[0]["fsdp_path"],
                                          _setup()[2].params)
    _equal(state_dict_from_jax_params(_np(params)), got[0]["fsdp_saved"])


def test_an_incomplete_directory_is_no_checkpoint(tmp_path):
    """A .shards directory without index.json is neither listed nor
    loaded."""
    (tmp_path / "ckpt_step=000004.shards").mkdir()
    assert pckpt.list_checkpoints(tmp_path) == []
    with pytest.raises(FileNotFoundError, match="index.json"):
        pckpt.load_params(tmp_path / "ckpt_step=000004.shards",
                          AutoencoderKL(VAEConfig(**TINY), device="cpu"))
