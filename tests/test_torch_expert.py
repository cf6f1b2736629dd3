"""The port's expert parallelism (tempo_tpu_torch/parallel/expert.py) and
its MoE over several processes with JAX's global routing
(tempo_tpu_torch/nn/moe.py) against the JAX package's one-program MoE, with
the port's ranks as gloo processes on the CPU (one launch of 2 ranks,
tests/torch_parallel_workers.py ``expert_cases``, whose results feed every
case).

Cases: JAX's EP test (tests/test_moe.py:93: 4 experts, the NLL of the
whole batch, against JAX's EP on its 2-device 'expert' mesh), each rank
holding 2 experts, the owned experts' gradients before the 1/n scale
twice JAX's; two GPT steps (the NLL plus 0.01 x the Switch loss, the
two-group AdamW) of an MoE model under EP, DDP (top-1 and top-2), FSDP2
and tensor parallelism, each rank training its rows of the global batch
(every row under TP), against JAX's steps on the whole batch, with a
capacity factor of 0.5 that drops routes on both ranks' sides of the
batch (a case checked to route otherwise if the lower rank's counts were
left out); JAX's name-keyed decay mask on the sharded model
(tests/test_moe.py:163); an EP state's .pt and .shards checkpoints resumed
bitwise and read on one device; and one process's MoE bitwise the
block's math without a group.

Tolerances are JAX's: loss rel 1e-5, gradients and parameters atol 1e-5 /
rtol 1e-4."""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as workers
from tempo_tpu.nn import transformer as jt
from tempo_tpu.nn.moe import moe_lm_loss_fn
from tempo_tpu.parallel.expert import create_ep_mesh, shard_params_ep
from tempo_tpu_torch.interop import jax_layout
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.nn.moe import MoEBlock, route_globally
from tempo_tpu_torch.nn.transformer import top_k
from tempo_tpu_torch.ops.norms import gelu_exact
from tempo_tpu_torch.train.checkpoint import load_params

torch.set_num_threads(1)

WORLD = 2
EP_CFG = dict(in_size=31, block_size=8, n_layer=2, n_head=2, n_embd=16,
              rmlp=2, n_experts=4, expert_capacity_factor=8.0)
STEP_CFG = dict(EP_CFG, expert_capacity_factor=0.5)  # routes overflow
STEP_BATCH, LR = 8, 1e-3
MODES = ("ep", "ddp:top1", "ddp:top2", "fsdp", "tp")
LOSS_REL, ATOL, RTOL = 1e-5, 1e-5, 1e-4

_RUNS: dict = {}


def _once(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _cfg(mode: str) -> dict:
    return dict(STEP_CFG, expert_top_k=2 if mode.endswith("top2") else 1)


def _ep_case():
    """JAX's EP test: params, tokens, targets, the loss and gradients on
    its 2-device 'expert' mesh."""
    def make():
        cfg = jt.TransformerConfig(**EP_CFG)
        model = jt.Transformer(cfg)
        tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 8), 0, 31)
        targets = jax.random.randint(jax.random.PRNGKey(2), (4, 8), 0, 31)
        params = model.init(jax.random.PRNGKey(0), tokens)["params"]

        def loss_fn(p):
            logits = model.apply({"params": p}, tokens)
            logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            return -jnp.take_along_axis(logp, targets[..., None], -1).mean()

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            shard_params_ep(params, create_ep_mesh(WORLD)))
        return (_np(params), np.asarray(tokens), np.asarray(targets),
                float(loss), _np(grads))
    return _once("ep", make)


def _step_case(top: int):
    """JAX's MoE GPT steps on the whole batch: params, batches, each
    step's metrics, the first step's gradients, the parameters after."""
    def make():
        cfg = jt.TransformerConfig(**dict(STEP_CFG, expert_top_k=top))
        model = jt.Transformer(cfg)
        rng = np.random.default_rng(5)
        batches = [rng.integers(0, 31, (STEP_BATCH, 9)) for _ in range(2)]
        params = model.init(jax.random.PRNGKey(0),
                            jnp.asarray(batches[0][:, :-1]))["params"]
        tx = jt.make_gpt_optimizer(params, weight_decay=0.1,
                                   learning_rate=LR, betas=(0.9, 0.95))
        opt_state = tx.init(params)
        grad_fn = jax.jit(jax.value_and_grad(moe_lm_loss_fn(model, 0.01),
                                             has_aux=True))
        start, metrics, first = _np(params), [], None
        for b in batches:
            b = jnp.asarray(b)
            (loss, m), grads = grad_fn(params, b[:, :-1], b[:, 1:])
            metrics.append({"loss": float(loss), "nll": float(m["nll"]),
                            "moe_aux": float(m["moe_aux"])})
            first = first or _np(grads)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
        return start, batches, metrics, first, _np(params)
    return _once(("step", top), make)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every case in one launch of 2 ranks."""
    def make():
        params, tokens, targets, _, _ = _ep_case()
        ep_cfg = pt.TransformerConfig(**EP_CFG)
        cases = {"ep_grads": (EP_CFG, gpt_state_dict_from_jax(params, ep_cfg),
                              tokens, targets)}
        for mode in MODES:
            start, batches, _, _, _ = _step_case(2 if mode.endswith("top2")
                                                 else 1)
            cfg = _cfg(mode)
            cases[f"moe_steps:{mode}"] = (
                mode.split(":")[0], cfg, gpt_state_dict_from_jax(
                    start, pt.TransformerConfig(**cfg)), batches, LR)
        start, batches, _, _, _ = _step_case(1)
        cases["ep_checkpoints"] = (
            STEP_CFG, gpt_state_dict_from_jax(
                start, pt.TransformerConfig(**STEP_CFG)), batches, LR,
            str(tmp_path_factory.mktemp("ep_ckpt")))
        return workers.launch(workers.expert_cases, WORLD,
                              tmp_path_factory.mktemp("ep_launch"), cases,
                              timeout_s=300)
    return _once("ranks", make)


def _close(got: dict, want: dict, what: str) -> None:
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float32),
                                   np.asarray(w, np.float32), atol=ATOL,
                                   rtol=RTOL, err_msg=f"{what} {name}")


def test_expert_parallel_matches_jax(ranks):
    """JAX's EP test: the loss and gradients of the whole batch, each rank
    routing its rows over the global batch and holding 2 of the 4
    experts; the router and every other parameter whole."""
    _, _, _, loss, grads = _ep_case()
    want = gpt_state_dict_from_jax(grads, pt.TransformerConfig(**EP_CFG))
    for r in ranks:
        res = r["ep_grads"]
        assert abs(res["loss"] - loss) <= LOSS_REL * abs(loss)
        _close(res["grads"], want, "EP gradient")
        assert res["shards"] == sorted(
            f"transformer.h.{i}.moe.{leaf}" for i in range(2)
            for leaf in ("w1", "b1", "w2", "b2"))
        assert res["shapes"]["transformer.h.0.moe.w1"] == (2, 16, 32)
        assert res["shapes"]["transformer.h.0.moe.router.weight"] == (4, 16)
        norm = math.sqrt(sum(float(np.square(np.asarray(v, np.float64)).sum())
                             for v in want.values()))
        assert abs(res["norm"] - norm) <= 1e-5 * norm


def test_owned_expert_gradients_need_the_one_over_n_scale(ranks):
    """Before ``average_grads`` an owner holds the sum over the ranks'
    local means: twice JAX's global-mean gradient at 2 ranks. Without the
    1/n scale the EP test above fails."""
    _, _, _, _, grads = _ep_case()
    want = gpt_state_dict_from_jax(grads, pt.TransformerConfig(**EP_CFG))
    raw = ranks[0]["ep_grads"]["raw"]
    for name in ranks[0]["ep_grads"]["shards"]:
        np.testing.assert_allclose(raw[name], WORLD * want[name],
                                   atol=2 * ATOL, rtol=RTOL, err_msg=name)
        assert np.abs(np.asarray(raw[name]) - np.asarray(want[name])).max() \
            > 10 * ATOL


def test_decay_mask_of_the_sharded_model_is_jax_name_keyed(ranks):
    """JAX's gpt_decay_mask (tests/test_moe.py:163), leaf by leaf, on the
    EP-sharded model's parameters: experts' w1/w2 and the router decay,
    their biases do not."""
    params = _ep_case()[0]
    jmask = jt.gpt_decay_mask(params)
    mask = ranks[0]["ep_grads"]["mask"]
    layout = jax_layout.gpt_layout(list(mask))
    for name, decays in mask.items():
        node = jmask
        for key in layout[name].path:
            node = node[key]
        assert decays == bool(node), name
    assert mask["transformer.h.0.moe.w1"] and not mask[
        "transformer.h.0.moe.b1"]


@pytest.mark.parametrize("mode", MODES)
def test_moe_steps_route_over_the_global_batch(ranks, mode):
    """Two GPT steps under ``mode`` against JAX's on the whole batch: each
    step's loss, NLL and Switch loss, the first step's gradients (whole,
    and their global norm in the metrics), and the parameters after both
    steps."""
    _, _, metrics, first, after = _step_case(2 if mode.endswith("top2")
                                             else 1)
    cfg = pt.TransformerConfig(**_cfg(mode))
    want = gpt_state_dict_from_jax(after, cfg)
    first_norm = math.sqrt(sum(float(np.square(np.asarray(
        v, np.float64)).sum()) for v in jax.tree_util.tree_leaves(first)))
    for r in ranks:
        res = r[f"moe_steps:{mode}"]
        for got, w in zip(res["metrics"], metrics):
            for key in ("loss", "nll", "moe_aux"):
                assert abs(got[key] - w[key]) <= LOSS_REL * abs(w[key]), (
                    key, got, w)
        assert abs(res["metrics"][0]["grad_norm"] - first_norm) <= (
            1e-5 * first_norm)
        _close(res["grads"], gpt_state_dict_from_jax(first, cfg),
               f"{mode} first gradients")
        _close(res["params"], want, f"{mode} parameters")


def test_overflow_depends_on_the_lower_ranks_counts():
    """The steps' capacity factor drops routes, and the first MoE layer's
    kept routes on rank 1 differ from what its own counts alone would keep:
    leaving the lower rank's counts out of the positions changes the
    answer (so the steps above would fail without them)."""
    start, batches, _, _, _ = _step_case(1)
    cfg = pt.TransformerConfig(**STEP_CFG)
    model = pt.Transformer(cfg, device="cpu")
    model.load_state_dict(gpt_state_dict_from_jax(start, cfg))
    seen = {}
    block = model.transformer["h"][0].moe
    block.register_forward_pre_hook(
        lambda m, args: seen.setdefault("x", args[0].detach()))
    with torch.no_grad():
        model(torch.from_numpy(batches[0][:, :-1]))
    x = seen["x"].reshape(-1, cfg.n_embd)
    probs = torch.softmax(block.router(x.float()), -1)
    assign = (top_k(probs, 1)[1] == torch.arange(4)).float()   # [N, E]
    n = x.shape[0]
    cap = math.ceil(n / 4 * STEP_CFG["expert_capacity_factor"])
    pos = ((torch.cumsum(assign, 0) - assign) * assign).sum(-1)
    half = assign[n // 2:]
    alone = ((torch.cumsum(half, 0) - half) * half).sum(-1)
    assert bool((pos >= cap).any())                       # routes overflow
    assert not torch.equal(pos[n // 2:] < cap, alone < cap)


def test_ep_checkpoints_resume_bitwise_and_load_on_one_device(ranks):
    """An EP state's .pt (gathered by rank 0, one device's keys) and
    .shards directory (each rank its experts' rows of the JAX leaves),
    each resumed into a fresh EP state bitwise on both ranks, and each
    loaded on one device equal to the gathered parameters."""
    res = [r["ep_checkpoints"] for r in ranks]
    assert all(r["pt_bitwise"] and r["shards_bitwise"] for r in res)
    assert all(r["pt_step"] == r["shards_step"] == 2 for r in res)
    cfg = pt.TransformerConfig(**STEP_CFG)
    for key in ("pt", "shards"):
        model = load_params(res[0][key], pt.Transformer(cfg, device="cpu",
                                                        seed=9))
        for name, v in model.state_dict().items():
            assert torch.equal(v, res[0]["whole"][name]), (key, name)


def _block_math(block: MoEBlock, x: torch.Tensor) -> torch.Tensor:
    """The MoE block's forward without a group, transcribed from JAX's
    MoEBlock: one flat rank-major cumsum for the positions."""
    cfg = block.config
    e, k = cfg.n_experts, cfg.expert_top_k
    b, t, d = x.shape
    n = b * t
    capacity = max(1, math.ceil(k * n / e * cfg.expert_capacity_factor))
    tokens = x.reshape(n, d)
    probs = torch.softmax(block.router(tokens.float()), dim=-1)
    top_p, top_i = top_k(probs, k)
    gates = top_p / top_p.sum(-1, keepdim=True) if k > 1 else top_p
    assign_k = (top_i[..., None] == torch.arange(e)).float()
    assign_flat = assign_k.transpose(0, 1).reshape(k * n, e)
    pos_flat = torch.cumsum(assign_flat, 0) * assign_flat - assign_flat
    pos = pos_flat.sum(-1).long().reshape(k, n).T
    fits = pos < capacity
    keep = fits.float() * gates
    pos_hot = (pos[..., None] == torch.arange(capacity)).float()
    dispatch_k = (assign_k[..., None] * pos_hot[:, :, None, :]
                  * fits[:, :, None, None])
    dispatch = dispatch_k.sum(1)
    combine = (dispatch_k * keep[:, :, None, None]).sum(1)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, tokens)
    h = gelu_exact(torch.einsum("ecd,edh->ech", expert_in, block.w1)
                   + block.b1[:, None])
    out = torch.einsum("ech,ehd->ecd", h, block.w2) + block.b2[:, None]
    return torch.einsum("nec,ecd->nd", combine, out).reshape(b, t, d)


@pytest.mark.parametrize("top", [1, 2])
def test_one_process_moe_is_bitwise_the_block_math(top):
    """Without a routing group (one process, or a group of one:
    ``route_globally`` keeps local routing) the block's output and
    gradients are bitwise its math without a group."""
    cfg = pt.TransformerConfig(**dataclasses.replace(
        pt.TransformerConfig(**STEP_CFG), expert_top_k=top).__dict__)
    torch.manual_seed(0)
    block = MoEBlock(cfg)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(0.3 * torch.randn(p.shape))
    route_globally(block, None)
    x = torch.randn(4, 8, 16, requires_grad=True)
    y, _ = block(x)
    want = _block_math(block, x)
    assert torch.equal(y, want)
    (gy,) = torch.autograd.grad(y.square().sum(), x)
    (gw,) = torch.autograd.grad(want.square().sum(), x)
    assert torch.equal(gy, gw)
