"""The port's tensor parallelism (tempo_tpu_torch/parallel/tensor.py:
output-channel shards over a ('data', 'model') mesh) against the JAX
package's (tempo_tpu/parallel/tensor.py) on its 8-device CPU mesh and
against the one-process port, with the port's ranks as gloo processes on
the CPU (tests/torch_parallel_workers.py).

Meshes: world 2 as (data 1, model 2), world 4 as (2, 2) and as (1, 4).
The same global batch of 8 goes to JAX's (2, 4) TP mesh and, cut over the
port's data axis, to its ranks; every posterior draw is JAX's global one,
each data row fed its rows. Cases: the tiny VAE's recipe for 3 steps with
the clip active (JAX's tests/test_parallel.py:119), each rank holding
exactly its JAX-rule slices of the parameters and moments afterwards;
encode (:166); one L2 step (:187, whose TP step is slow in JAX: against
JAX's data-parallel step on its 8-device mesh, which JAX's tests hold
equal to the unsharded and so to the TP one; the unsharded step itself
sums this loss of ~2e4 in another order, 1e-5 away), at (2, 2) with
uneven NaN shares on the two data rows; GPT loss and gradients (:748);
a width where a rank's channel share cuts through a GroupNorm group
(norm_groups 2 at model 4) against the one-process port; JAX's sharding rule leaf by leaf over the flagship's and
GPT-2-small's trees; the refusals; and a gather whose backward sums over
the ranks, which gives n_model times the gradients.

Tolerances are JAX's own: loss rel 1e-5, parameters atol 1e-5 / rtol 1e-4
(the unused down/up convs and the zero-gradient key bias as in
tests/test_torch_parallel.py), GPT loss rel 1e-6 and gradients atol 1e-5 /
rtol 1e-4; the moments, which JAX's tests do not compare, are held to the
one-process port's at rtol 1e-3 / atol 1e-9."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.models.vae_l2 import VAEWithL2Head as JaxL2
from tempo_tpu.nn import transformer as jt
from tempo_tpu.parallel.mesh import create_mesh, make_place_fn, shard_state
from tempo_tpu.parallel.tensor import create_tp_mesh as jax_tp_mesh
from tempo_tpu.parallel.tensor import shard_params_tp as jax_shard_params
from tempo_tpu.parallel.tensor import shard_state_tp as jax_shard_state
from tempo_tpu.parallel.tensor import tp_sharding_rule as jax_rule
from tempo_tpu.train import state as jstate
from tempo_tpu.train import step as jstep
from tempo_tpu_torch.cli import parallel_plan
from tempo_tpu_torch.interop import jax_layout
from tempo_tpu_torch.interop.jax_params import (gpt_state_dict_from_jax,
                                                l2_state_dict_from_jax,
                                                state_dict_from_jax_params)
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.models.vae_l2 import L2_PRODUCTS
from tempo_tpu_torch.nn.distributions import DiagonalGaussian
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.parallel import tensor
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
HIDDEN = (16, 16)
GPT = dict(in_size=61, block_size=16, n_layer=2, n_head=2, n_embd=32)
B = 8
LOSS_REL, ATOL, RTOL = 1e-5, 1e-5, 1e-4
LR = 1e-3
UNUSED = ("encoder.downs.2.down", "decoder.ups.2.up")
ZERO_GRAD = ("mid_attn1.k.bias",)
MESHES = {"1x2": (2, 2), "2x2": (4, 2), "1x4": (4, 4)}

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


def _noise(key):
    return np.asarray(jax.random.normal(key, (B, 4, 4, TINY["embed_dim"]),
                                        jnp.float32))


def _close(got: dict, want: dict, steps: int = 3) -> None:
    assert set(got) == set(want)
    for name, w in want.items():
        if name.startswith(UNUSED):
            continue
        g = np.asarray(got[name], np.float32)
        w = np.asarray(w, np.float32)
        if name.endswith(ZERO_GRAD):
            assert np.abs(g - w).max() <= 2 * steps * LR, name
            continue
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL, err_msg=name)


# ------------------------------------------------------------ the cases

def _vae_case(groups: int = 4):
    def make():
        cfg = dict(TINY, norm_groups=groups)
        jm = JaxVAE(JaxConfig(**cfg))
        c, h, w = TINY["shape"]
        params = _nudged(jm.init(jax.random.PRNGKey(0),
                                 jnp.zeros((1, h, w, c)),
                                 rng=jax.random.PRNGKey(1))["params"])
        rng = np.random.default_rng(1)
        batches = [rng.standard_normal((B, h, w, c)).astype(np.float32)
                   for _ in range(3)]
        key = jax.random.PRNGKey(3)
        noises = [_noise(jax.random.fold_in(key, i)) for i in range(3)]
        x = rng.standard_normal((4, h, w, c)).astype(np.float32)
        return (cfg, jm, params, state_dict_from_jax_params(params), batches,
                noises, x)
    return _once(("vae", groups), make)


def _jax_vae_tp():
    """JAX's TP step on its (2, 4) mesh, 3 steps, and its TP encode."""
    def make():
        cfg, jm, params, _, batches, _, x = _vae_case()
        tx = jstate.make_optimizer(lr=LR, weight_decay=0.05)
        mesh = jax_tp_mesh(n_model=4)
        state = jax_shard_state(jstate.create_train_state(
            params, tx, jax.random.PRNGKey(3)), mesh)
        step = jstep.make_train_step(jstep.vae_loss_fn(jm), tx, donate=False)
        metrics = []
        for b in batches:
            state, m = step(state, make_place_fn(mesh)(b))
            metrics.append({k: float(v) for k, v in m.items()})
        encode = jax.jit(lambda p, xx: jm.apply(
            {"params": p}, xx, method=JaxVAE.encode).mean)(
                jax_shard_params(params, mesh), jnp.asarray(x))
        return metrics, state_dict_from_jax_params(
            jax.tree_util.tree_map(np.asarray, state.params)), np.asarray(
                encode)
    return _once("jax_vae", make)


def _one_process_vae(groups: int):
    """The one-process port's 3 steps on the same draws: metrics,
    parameters and moments by name."""
    def make():
        cfg, _, _, sd, batches, noises, _ = _vae_case(groups)
        model = AutoencoderKL(VAEConfig(**cfg), device="cpu", seed=0)
        model.load_state_dict(sd)
        tx = pstate.make_optimizer(lr=LR, weight_decay=0.05)
        state = pstate.create_train_state(model, tx, 3)
        step = pstep.make_train_step(pstep.vae_loss_fn(model), tx)
        saved = DiagonalGaussian.sample
        try:
            DiagonalGaussian.sample = workers.posterior_feed(noises,
                                                             slice(None))
            metrics = []
            for b in batches:
                state, m = step(state, workers.take(b, slice(None)))
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            DiagonalGaussian.sample = saved
        names = dict(model.named_parameters())
        return metrics, {n: (p.detach().clone(),
                             state.optimizer.state.get(p, {}))
                         for n, p in names.items()}
    return _once(("one_vae", groups), make)


def _l2_case():
    def make():
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
        step = jstep.make_train_step(jstep.vae_l2_loss_fn(jm), tx,
                                     donate=False)
        state, m = step(state, make_place_fn(mesh)(batch))
        k_vae, k_head = jax.random.split(jax.random.fold_in(key, 0))
        return (batch, [_noise(k_vae), _noise(k_head)],
                l2_state_dict_from_jax(params, HIDDEN),
                {k: float(v) for k, v in m.items()},
                l2_state_dict_from_jax(jax.tree_util.tree_map(
                    np.asarray, state.params), HIDDEN))
    return _once("l2", make)


def _gpt_case():
    def make():
        cfg = jt.TransformerConfig(tokenized=True, tie_emb=True, **GPT)
        model = jt.Transformer(cfg)
        tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(1),
                                               (B, 16), 0, GPT["in_size"]))
        targets = np.asarray(jax.random.randint(jax.random.PRNGKey(2),
                                                (B, 16), 0, GPT["in_size"]))
        params = model.init(jax.random.PRNGKey(0), jnp.asarray(tokens))[
            "params"]

        def loss_fn(p):
            logits = model.apply({"params": p}, jnp.asarray(tokens))
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            return -jnp.take_along_axis(logp, jnp.asarray(targets)[..., None],
                                        -1).mean()

        mesh = jax_tp_mesh(n_model=4)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax_shard_params(params, mesh))
        np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa
        return (tokens, targets, gpt_state_dict_from_jax(np_tree(params),
                                                         cfg),
                float(loss), gpt_state_dict_from_jax(np_tree(grads), cfg))
    return _once("gpt", make)


def _port(mesh: str, tmp_path_factory):
    """Every case of a mesh in one launch of its ranks."""
    def make():
        world, n_model = MESHES[mesh]
        cfg, _, _, sd, batches, noises, x = _vae_case()
        cases = {"vae": (cfg, sd, batches, noises, x)}
        if mesh in ("1x2", "2x2"):
            batch, l2_noises, l2_sd, _, _ = _l2_case()
            cases["l2"] = (TINY, HIDDEN, l2_sd, batch, l2_noises)
        if mesh in ("1x2", "1x4"):
            tokens, targets, gpt_sd, _, _ = _gpt_case()
            cases["gpt"] = (GPT, gpt_sd, tokens, targets)
        if mesh == "1x4":
            cfg2, _, _, sd2, batches2, noises2, x2 = _vae_case(2)
            cases["vae:groups2"] = (cfg2, sd2, batches2, noises2, x2)
        return workers.launch(workers.tp_cases, world,
                              tmp_path_factory.mktemp(f"tp{mesh}"), n_model,
                              cases)
    return _once(("port", mesh), make)


# ------------------------------------------------------------ the tests

@pytest.mark.parametrize("mesh", list(MESHES))
def test_vae_steps_match_the_jax_tp_mesh(mesh, tmp_path_factory):
    """3 steps of the VAE recipe, the clip active, on every rank of the
    port's mesh against JAX's TP step on its (2, 4) mesh: the global
    metrics on every rank, and the gathered parameters."""
    want_m, want_p, _ = _jax_vae_tp()
    assert want_m[0]["grad_norm"] > 1.0  # the clip acted
    for rank, got in enumerate(_port(mesh, tmp_path_factory)):
        for g, w in zip(got["vae"]["metrics"], want_m):
            for k in ("loss", "nll_loss", "kl_loss", "pixel_mse",
                      "grad_norm"):
                assert abs(g[k] - w[k]) <= LOSS_REL * abs(w[k]), (
                    rank, k, g[k], w[k])
        _close(got["vae"]["params"], want_p)


def _tp(rank: int, world: int) -> tensor.TensorParallel:
    return tensor.TensorParallel(rank, world, None, 0, 1, None)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_each_rank_holds_its_jax_rule_slices(mesh, tmp_path_factory):
    """After the steps each rank holds exactly its JAX-rule slice of every
    sharded parameter and of its moments (the one-process port's values,
    cut by the rule), every other one whole, and its parameter + moment
    bytes shrink with the model axis."""
    _, one = _one_process_vae(4)
    _, n_model = MESHES[mesh]
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    layout = jax_layout.jax_layout(model)
    for rank, got in enumerate(_port(mesh, tmp_path_factory)):
        m_rank = got["axes"][0]
        for name, (kind, param, mu, nu) in got["vae"]["local"].items():
            full, st = one[name]
            leaf = layout[name]
            rule = tensor.tp_sharding_rule(torch.empty(
                jax_layout.jax_shape(leaf.kind, full.shape), device="meta"),
                n_model)
            assert (kind is not None) == (rule is not None), name
            cut = (tensor.local_of(full, kind, _tp(m_rank, n_model))
                   if kind else full)
            assert param.shape == cut.shape, name
            if name.startswith(UNUSED) or name.endswith(ZERO_GRAD):
                continue
            np.testing.assert_allclose(param, cut, atol=ATOL, rtol=RTOL,
                                       err_msg=name)
            for mine, theirs in ((mu, st.get("exp_avg")),
                                 (nu, st.get("exp_avg_sq"))):
                want = (tensor.local_of(theirs, kind, _tp(m_rank, n_model))
                        if kind else theirs)
                assert mine.shape == want.shape, name
                np.testing.assert_allclose(mine, want, rtol=1e-3, atol=1e-9,
                                           err_msg=name)
        whole = sum(p.numel() * 4 * 3 for p in model.parameters())
        assert got["vae"]["bytes"] <= whole / n_model * 1.02, rank


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_encode_matches_the_jax_tp_encode(mesh, tmp_path_factory):
    _, _, want = _jax_vae_tp()
    for got in _port(mesh, tmp_path_factory):
        np.testing.assert_allclose(got["vae"]["encode"], want, atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
def test_l2_step_matches_jax(mesh, tmp_path_factory):
    """One L2 step; at (2, 2) the two data rows hold 5% and 60% NaN, and
    the product losses divide by the global count of valid positions
    (summed over the data axis only)."""
    _, _, _, want_m, want_p = _l2_case()
    for got in _port(mesh, tmp_path_factory):
        for k, v in want_m.items():
            assert abs(got["l2"]["metrics"][k] - v) <= LOSS_REL * abs(v), (
                k, got["l2"]["metrics"][k], v)
        _close(got["l2"]["params"], want_p, steps=1)


@pytest.mark.parametrize("mesh", ["1x2", "1x4"])
def test_gpt_loss_and_gradients_match_jax(mesh, tmp_path_factory):
    """The tied GPT's loss and every gradient under TP (wte and wpe
    sharded on n_embd, the head gathering wte) against JAX's TP
    value_and_grad."""
    _, _, _, want_loss, want_grads = _gpt_case()
    for got in _port(mesh, tmp_path_factory):
        assert abs(got["gpt"]["loss"] - want_loss) <= 1e-6 * abs(want_loss)
        assert set(got["gpt"]["grads"]) == set(want_grads)
        for name, w in want_grads.items():
            np.testing.assert_allclose(got["gpt"]["grads"][name], w,
                                       atol=ATOL, rtol=RTOL, err_msg=name)
        assert got["gpt"]["exchanged"]["weights"] > 0  # the head's wte


def test_a_channel_share_that_cuts_a_group_changes_nothing(tmp_path_factory):
    """norm_groups 2 at model 4: each rank's 4 of a level's 16 channels are
    half a group; the statistics are the whole activations', so the steps
    equal the one-process port's."""
    want_m, one = _one_process_vae(2)
    for got in _port("1x4", tmp_path_factory):
        for g, w in zip(got["vae:groups2"]["metrics"], want_m):
            for k in ("loss", "grad_norm"):
                assert abs(g[k] - w[k]) <= LOSS_REL * abs(w[k]), (k, g, w)
        _close(got["vae:groups2"]["params"],
               {n: p for n, (p, _) in one.items()})


@pytest.mark.parametrize("n_model", [2, 4])
def test_sharding_rule_matches_jax_leaf_by_leaf(n_model):
    """The flagship VAE's and GPT-2-small's trees, shapes only: every port
    parameter's JAX leaf has the shape the layout table gives, and the
    port shards it exactly where JAX's tp_sharding_rule does."""
    mesh = jax_tp_mesh(n_model=n_model)
    jvae = JaxVAE(JaxConfig())
    c, h, w = JaxConfig().shape
    vae_tree = jax.eval_shape(lambda: jvae.init(
        jax.random.PRNGKey(0), jnp.zeros((1, h, w, c)),
        rng=jax.random.PRNGKey(1)))["params"]
    gcfg = jt.TransformerConfig()
    gpt_tree = jax.eval_shape(lambda: jt.Transformer(gcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    cases = [(AutoencoderKL(VAEConfig(), device="cpu"), vae_tree),
             (pt.Transformer(pt.TransformerConfig(), device="meta"),
              gpt_tree)]
    for model, tree in cases:
        layout = jax_layout.jax_layout(model)
        seen = set()
        for name, p in model.named_parameters():
            leaf = tree
            for key in layout[name].path:
                leaf = leaf[key]
            seen.add(layout[name].path)
            shape = jax_layout.jax_shape(layout[name].kind, p.shape)
            assert shape == tuple(leaf.shape), name
            jax_sharded = jax_rule(leaf, mesh).spec[-1:] == ("model",)
            port = tensor.tp_sharding_rule(
                torch.empty(shape, dtype=p.dtype, device="meta"), n_model)
            assert (port is not None) == jax_sharded, name
        paths = {tuple(k.key for k in kp) for kp, _ in
                 jax.tree_util.tree_flatten_with_path(tree)[0]}
        assert seen == paths  # every JAX leaf, once


def _cfg(**parallel):
    return {"parallel": parallel, "model": {}, "finetune": {}}


@pytest.mark.parametrize("trainer, parallel, error, match", [
    ("train_vae", {"tensor": 2, "fsdp": True}, ValueError, "fsdp"),
    ("train_gpt", {"tensor": 2, "fsdp": True}, ValueError, "fsdp"),
    ("train_gpt", {"tensor": 2, "pipeline": 2}, ValueError, "pipeline"),
    ("train_gpt", {"tensor": 2, "expert": 2}, ValueError, "expert"),
    ("train_gpt", {"tensor": 2, "context": 2}, ValueError, "context"),
    ("train_gpt", {"pipeline": 2}, None, None),
], ids=["vae_fsdp", "gpt_fsdp", "gpt_pipeline", "gpt_expert", "gpt_context",
        "gpt_pipeline_alone"])
def test_parallel_table_refuses_what_jax_refuses(trainer, parallel, error,
                                                 match):
    """JAX refuses tensor parallelism beside another axis; a pipeline
    alone it runs, and so does the port."""
    if error is None:
        assert parallel_plan(_cfg(**parallel), trainer).n_pipe == 2
    else:
        with pytest.raises(error, match=match):
            parallel_plan(_cfg(**parallel), trainer)
    assert parallel_plan(_cfg(tensor=2), trainer).n_model == 2
    # the L2 trainer reads no fsdp, as JAX's
    assert parallel_plan(_cfg(tensor=2, fsdp=True),
                         "train_vae_l2").n_model == 2


def test_refusals_of_the_tp_plan(tmp_path):
    """MoE under TP is a CLI path (JAX refuses tensor only beside another
    axis: its experts are channel-sharded), LoRA under TP is refused as
    under FSDP, a model the plan does not cover (an int8 MoE) raises, and
    a process count the model axis does not divide raises ValueError."""
    from tempo_tpu_torch.cli import train_gpt

    base = {"output_dir": str(tmp_path / "run"),
            "data": {"synthetic": {"vocab_size": 61, "length": 4096}},
            "model": dict(GPT), "training": {"n_steps": 1}}
    train_gpt.validate_config(dict(base, parallel={"tensor": 2},
                                   model=dict(GPT, n_experts=2)))
    with pytest.raises(ValueError, match="lora_rank"):
        train_gpt.validate_config(dict(
            base, parallel={"tensor": 2},
            finetune={"lora_rank": 2, "base_checkpoint": "x.pt"}))
    moe = pt.Transformer(pt.TransformerConfig(n_experts=2, quantize="int8",
                                              **GPT), device="cpu")
    with pytest.raises(NotImplementedError):
        tensor.shard_params_tp(moe, _tp(0, 2))
    with pytest.raises(ValueError, match="not divisible"):
        tensor.create_tp_mesh(2, "cpu")


def test_a_summed_gather_backward_gives_n_times_the_gradient(monkeypatch):
    """The gather's backward takes the rank's slice of the whole gradient
    every rank holds; summing it over the ranks (what a reduce-scatter
    backward computes) would give n_model times it. Checked without
    processes: a fake model axis of 2 whose all-gather and all-reduce act
    on one rank's copies."""
    tp = _tp(0, 2)
    calls = []

    def fake_gather(bufs, buf, group=None):
        for b in bufs:
            b.copy_(buf)

    def fake_reduce(buf, group=None):
        calls.append(buf.numel())
        buf.mul_(2)  # two ranks holding the same value

    monkeypatch.setattr(torch.distributed, "all_gather", fake_gather)
    monkeypatch.setattr(torch.distributed, "all_reduce", fake_reduce)
    monkeypatch.setattr(tensor, "comm_device", lambda t, op, g: t.device)
    x = torch.randn(3, 4, requires_grad=True)
    y = tensor.gather(x, tp)
    assert y.shape == (3, 8)
    g = torch.randn(3, 8)
    y.backward(g)
    torch.testing.assert_close(x.grad, g[:, :4])  # the slice, not a sum
    assert not calls
    # the entry sums the input gradient's shares over the ranks
    w = torch.randn(3, requires_grad=True)
    (e,) = tensor.enter(tp, w)
    e.sum().backward()
    torch.testing.assert_close(w.grad, torch.full((3,), 2.0))
    assert calls == [3]
