"""The port's pipeline parallelism (tempo_tpu_torch/parallel/pipeline.py:
the GPipe schedule over stage processes, with data and tensor axes and
``fsdp_experts``) against the JAX package's (tempo_tpu/parallel/pipeline.py)
on its 8-device CPU mesh, with the port's ranks as gloo processes on the
CPU: one launch of 2 ranks and one of 4 (tests/torch_parallel_workers.py
``pipeline_cases``), whose results feed every case.

Cases, JAX's tests/test_parallel.py and tests/test_moe.py: 4 stages x 4
microbatches, the logits of the whole batch on every stage (:543);
2 stages x 8 microbatches, one update of the clipped AdamW (:573);
('data', 'pipe') at (2, 2) against JAX's (2, 4) (:618); ('data', 'pipe',
'model') at (1, 2, 2) against JAX's (2, 2, 2) (:653); an MoE model through
2 stages (test_moe.py:140); ``fsdp_experts`` on ('data', 'pipe') (2, 2),
the expert axis held half a rank (test_moe.py:236); the (1, 2, 2) run's
state through the .pt and the sharded format, resumed bitwise, its
directory read by JAX's ``load_checkpoint_sharded`` with a (rest,
stage_stack) template (:703); JAX's split and merge of the stage stacks;
and JAX's pipeline checkpoints (.msgpack, .shards) read by the port's
``load_params`` into one model and resumed by ``load_checkpoint`` into the
port's 2-stage state.

Tolerances are JAX's: loss rel 1e-5, gradients and parameters atol 1e-5 /
rtol 1e-4, logits 2e-5."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_parallel_workers as workers
from tempo_tpu.nn import transformer as jt
from tempo_tpu.parallel import pipeline as jp
from tempo_tpu.train import state as jstate
from tempo_tpu_torch.interop.jax_params import gpt_state_dict_from_jax
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.parallel import pipeline
from tempo_tpu_torch.train.checkpoint import load_params

torch.set_num_threads(1)

GPT = dict(in_size=61, block_size=16, n_layer=4, n_head=2, n_embd=32)
MOE = dict(in_size=31, block_size=16, n_layer=4, n_head=2, n_embd=16,
           rmlp=2, n_experts=4, expert_capacity_factor=8.0)
LOSS_REL, ATOL, RTOL, LOGITS_ATOL = 1e-5, 1e-5, 1e-4, 2e-5
LR = 1e-3

_RUNS: dict = {}


def _once(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _setup(kind: str):
    """JAX's _pp_setup (the GPT) or test_moe.py's 4-layer MoE: config,
    model, params, tokens, targets."""
    def make():
        cfg = (jt.TransformerConfig(tokenized=True, tie_emb=True, **GPT)
               if kind == "gpt" else jt.TransformerConfig(**MOE))
        model = jt.Transformer(cfg)
        vocab = cfg.in_size
        tokens = jax.random.randint(jax.random.PRNGKey(1), (8, 16), 0, vocab)
        targets = jax.random.randint(jax.random.PRNGKey(2), (8, 16), 0, vocab)
        params = model.init(jax.random.PRNGKey(0), tokens)["params"]
        return cfg, model, params, tokens, targets
    return _once(("setup", kind), make)


def _sd(kind: str, tree) -> dict:
    return gpt_state_dict_from_jax(_np(tree), pt.TransformerConfig(
        **(GPT if kind == "gpt" else MOE)))


def _jax_pp(kind: str, n_pipe: int, n_data: int, n_model: int,
            fsdp: bool = False):
    """JAX's pipelined loss and gradients (merged) on its mesh."""
    def make():
        cfg, _, params, tokens, targets = _setup(kind)
        mesh = jp.create_pp_mesh(n_pipe, n_data=n_data, n_model=n_model)
        rest, stack = jp.place_pipeline_params(
            mesh, *jp.split_pipeline_params(params, n_pipe),
            fsdp_experts=fsdp)
        loss_fn = jp.make_pp_loss_fn(cfg, n_pipe, 4, mesh, fsdp_experts=fsdp)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            (rest, stack), tokens, targets)
        return float(loss), _sd(kind, jp.merge_pipeline_params(
            *jax.device_get(grads)))
    return _once(("jax_pp", kind, n_pipe, n_data, n_model, fsdp), make)


def _jax_train_step():
    """JAX's :573: one clipped-AdamW update through 2 stages x 8
    microbatches: the loss and the parameters after (merged)."""
    def make():
        cfg, _, params, tokens, targets = _setup("gpt")
        mesh = jp.create_pp_mesh(2)
        rest, stack = jp.place_pipeline_params(
            mesh, *jp.split_pipeline_params(params, 2))
        tx = jstate.make_optimizer(lr=LR)
        loss_fn = jp.make_pp_loss_fn(cfg, 2, 8, mesh)
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(
            (rest, stack), tokens, targets)
        upd, _ = tx.update(grads, tx.init((rest, stack)), (rest, stack))
        new = optax.apply_updates((rest, stack), upd)
        return float(loss), _sd("gpt", jp.merge_pipeline_params(
            *jax.device_get(new)))
    return _once("jax_step", make)


def _batch(kind: str) -> list:
    _, _, _, tokens, targets = _setup(kind)
    return [{"tokens": np.asarray(tokens), "targets": np.asarray(targets)}]


def _jax_pipeline_files(root):
    """JAX's train state of a 2-stage pipeline run after one update (its
    params and moments (rest, stage_stack) trees), saved as a .msgpack and
    as a .shards directory: (the state, the two paths)."""
    from tempo_tpu.train.checkpoint import save_checkpoint
    from tempo_tpu.train.sharded_checkpoint import save_checkpoint_sharded

    _, _, params, _, _ = _setup("gpt")
    split = jp.split_pipeline_params(params, 2)
    tx = jt.make_gpt_optimizer(split, weight_decay=0.1, learning_rate=LR,
                               betas=(0.9, 0.95))
    state = jstate.create_train_state(split, tx, jax.random.PRNGKey(3))
    grads = jax.tree_util.tree_map(lambda p: 0.1 * p + 0.01, split)
    updates, opt_state = tx.update(grads, state.opt_state, split)
    state = state.replace(params=optax.apply_updates(split, updates),
                          opt_state=opt_state, step=state.step + 1)
    return state, (str(save_checkpoint(root / "msgpack", state)),
                   str(save_checkpoint_sharded(root / "shards", state)))


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    def make():
        _, _, moe, tokens, _ = _setup("moe")
        _, _, gpt, _, _ = _setup("gpt")
        jax_state, paths = _jax_pipeline_files(
            tmp_path_factory.mktemp("jax_pp"))
        _RUNS["jax_state"] = jax_state
        cases = {
            "pp_apply:moe": ((1, 2, 1), MOE, _sd("moe", moe),
                             np.asarray(tokens), 4),
            "pp_steps:clip": ((1, 2, 1), GPT, _sd("gpt", gpt),
                              _batch("gpt"), 8, "clip", LR),
            "pp_resume:jax": ((1, 2, 1), GPT, _sd("gpt", gpt), paths, LR)}
        return workers.launch(workers.pipeline_cases, 2,
                              tmp_path_factory.mktemp("pp2"), cases,
                              timeout_s=300)
    return _once("ranks2", make)


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    def make():
        _, _, gpt, tokens, targets = _setup("gpt")
        _, _, moe, moe_tok, moe_tgt = _setup("moe")
        tok, tgt = np.asarray(tokens), np.asarray(targets)
        cases = {
            "pp_apply:4": ((1, 4, 1), GPT, _sd("gpt", gpt), tok, 4),
            "pp_grads:data": ((2, 2, 1), GPT, _sd("gpt", gpt), tok, tgt, 4),
            "pp_grads:model": ((1, 2, 2), GPT, _sd("gpt", gpt), tok, tgt, 4),
            "pp_grads:fsdp": ((2, 2, 1), MOE, _sd("moe", moe),
                              np.asarray(moe_tok), np.asarray(moe_tgt), 4,
                              True),
            "pp_steps:ckpt": ((1, 2, 2), GPT, _sd("gpt", gpt),
                              _batch("gpt") * 2, 4, "gpt", LR,
                              str(tmp_path_factory.mktemp("pp_ckpt")))}
        return workers.launch(workers.pipeline_cases, 4,
                              tmp_path_factory.mktemp("pp4"), cases,
                              timeout_s=300)
    return _once("ranks4", make)


def _close(got: dict, want: dict, what: str, atol=ATOL, rtol=RTOL) -> None:
    assert set(got) == set(want), what
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name], np.float32),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol, err_msg=f"{what} {name}")


def test_four_stage_forward_matches_jax(ranks4):
    """4 stages x 4 microbatches (:543): every stage holds one block
    under its global name and returns the unpipelined logits."""
    _, model, params, tokens, _ = _setup("gpt")
    ref = np.asarray(model.apply({"params": params}, tokens))
    for rank, r in enumerate(ranks4):
        res = r["pp_apply:4"]
        assert res["stage"] == rank
        assert {n.split(".")[2] for n in res["blocks"]} == {str(rank)}
        np.testing.assert_allclose(res["logits"].numpy(), ref,
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)


def test_moe_blocks_through_two_stages_match_jax(ranks2):
    """test_moe.py:140: 2 stages x 4 microbatches of MoE blocks, each
    microbatch routed by itself."""
    _, model, params, tokens, _ = _setup("moe")
    ref = np.asarray(model.apply({"params": params}, tokens))
    for r in ranks2:
        np.testing.assert_allclose(r["pp_apply:moe"]["logits"].numpy(), ref,
                                   atol=LOGITS_ATOL, rtol=LOGITS_ATOL)


def test_train_step_matches_jax(ranks2):
    """:573: one clipped-AdamW update through 2 stages x 8 microbatches
    (the clip reads the global norm): the loss and every parameter."""
    loss, want = _jax_train_step()
    res = ranks2[0]["pp_steps:clip"]
    got = res["metrics"][0]["loss"]
    assert abs(got - loss) <= LOSS_REL * abs(loss)
    assert ranks2[1]["pp_steps:clip"]["metrics"][0]["loss"] == got
    _close(res["params"], want, "parameters after the update")


@pytest.mark.parametrize("case, jax_mesh", [
    ("data", (4, 2, 1)), ("model", (2, 2, 2))], ids=["data_pipe",
                                                     "data_pipe_model"])
def test_compositions_match_jax(ranks4, case, jax_mesh):
    """('data', 'pipe') (2, 2) against JAX's (2, 4) (:618) and ('data',
    'pipe', 'model') (1, 2, 2) against JAX's (2, 2, 2) (:653): the loss
    of the whole batch and its gradients, reduced over the pipe and data
    axes and gathered over 'model'; the global norm."""
    loss, want = _jax_pp("gpt", *jax_mesh)
    res = ranks4[0][f"pp_grads:{case}"]
    assert abs(res["loss"] - loss) <= LOSS_REL * abs(loss)
    _close(res["grads"], want, f"{case} gradient")
    norm = float(np.sqrt(sum(np.square(np.asarray(v, np.float64)).sum()
                             for v in want.values())))
    assert abs(res["norm"] - norm) <= 1e-5 * norm
    assert [r[f"pp_grads:{case}"]["loss"] for r in ranks4] == [
        res["loss"]] * 4


def test_fsdp_experts_match_jax(ranks4):
    """test_moe.py:236: ('data', 'pipe') (2, 2) with the stacked experts
    stored half a data rank and gathered at stage entry: the loss and
    gradients of JAX's run on the same mesh."""
    loss, want = _jax_pp("moe", 2, 2, 1, fsdp=True)
    res = ranks4[0]["pp_grads:fsdp"]
    assert abs(res["loss"] - loss) <= LOSS_REL * abs(loss)
    _close(res["grads"], want, "fsdp_experts gradient")
    assert res["expert_shapes"]["transformer.h.0.moe.w1"] == (2, 16, 32)
    assert len(res["expert_shapes"]) == 2 * 4  # stage 0's two MoE blocks


def test_pipeline_checkpoints_resume_bitwise_and_jax_reads_them(ranks4):
    """The (1, 2, 2) run's state after 2 steps: the .pt and the .shards
    directory each resume into a fresh pipelined state bitwise on every
    rank and load into a placed model; JAX's load_checkpoint_sharded
    reads the directory with a (rest, stage_stack) template, equal to the
    port's parameters bit for bit (:703), and the port's load_params reads
    it into one model."""
    from tempo_tpu.train.sharded_checkpoint import load_checkpoint_sharded

    res = [r["pp_steps:ckpt"] for r in ranks4]
    for key in ("pt_bitwise", "shards_bitwise", "pt_load_params",
                "shards_load_params"):
        assert all(r[key] for r in res), key
    cfg, _, params, _, _ = _setup("gpt")
    split = jp.split_pipeline_params(params, 2)
    tx = jt.make_gpt_optimizer(split, weight_decay=0.1, learning_rate=LR,
                               betas=(0.9, 0.95))
    restored, _, _ = load_checkpoint_sharded(
        res[0]["shards"], jstate.create_train_state(
            split, tx, jax.random.PRNGKey(3)))
    assert int(restored.step) == 2
    got = _sd("gpt", jp.merge_pipeline_params(*jax.device_get(
        restored.params)))
    want = res[0]["params"]
    assert set(got) == set(want)
    for name, v in want.items():
        assert torch.equal(got[name], v), name
    one = load_params(res[0]["shards"], pt.Transformer(
        pt.TransformerConfig(**GPT), device="cpu", seed=9))
    for name, v in one.state_dict().items():
        assert torch.equal(v, want[name]), name


def test_jax_pipeline_checkpoints_resume_a_pipelined_state(ranks2):
    """load_checkpoint of JAX's pipeline run (.msgpack and .shards, its
    (rest, stage_stack) params and moments) into the port's 2-stage
    state: the step, every parameter and both AdamW moments bitwise JAX's
    merged trees, gathered on stage 0."""
    state = _RUNS["jax_state"]
    want = _sd("gpt", jp.merge_pipeline_params(*state.params))
    adam = state.opt_state[0]  # the masked adamw's ScaleByAdamState
    moments = {k: _sd("gpt", jp.merge_pipeline_params(*getattr(adam, k)))
               for k in ("mu", "nu")}
    for path, got in ranks2[0]["pp_resume:jax"].items():
        assert got["step"] == 1, path
        for name, v in want.items():
            assert torch.equal(got["params"][name], v), (path, name)
            st = got["moments"][name]
            assert torch.equal(st["exp_avg"], moments["mu"][name]), name
            assert torch.equal(st["exp_avg_sq"], moments["nu"][name]), name


def test_split_and_merge_are_jax_s():
    """split_pipeline_params / merge_pipeline_params on JAX's tree: the
    same (rest, stage_stack) as JAX's, and back."""
    _, _, params, _, _ = _setup("moe")
    tree = _np(params)
    rest, stack = pipeline.split_pipeline_params(tree, 2)
    jrest, jstack = _np(jp.split_pipeline_params(params, 2))
    for a, b in zip(jax.tree_util.tree_leaves((rest, stack)),
                    jax.tree_util.tree_leaves((jrest, jstack))):
        np.testing.assert_array_equal(a, b)
    assert stack["moe"]["w1"].shape == (2, 2, 4, 16, 32)
    merged = pipeline.merge_pipeline_params(rest, stack)
    for a, b in zip(jax.tree_util.tree_leaves(merged),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple of n_stages=3"):
        pipeline.split_pipeline_params(tree, 3)


@pytest.mark.parametrize("fmt", ["msgpack", "sharded"])
def test_jax_pipeline_checkpoints_load_into_one_model(tmp_path, fmt):
    """A JAX pipeline run's checkpoint (its params (rest, stage_stack)):
    the .msgpack and the .shards directory, each read by load_params into
    one unsplit model, bitwise the merged JAX parameters."""
    from tempo_tpu.train.checkpoint import save_checkpoint
    from tempo_tpu.train.sharded_checkpoint import save_checkpoint_sharded

    cfg, _, params, _, _ = _setup("gpt")
    split = jp.split_pipeline_params(params, 2)
    tx = jt.make_gpt_optimizer(split, weight_decay=0.1, learning_rate=LR,
                               betas=(0.9, 0.95))
    state = jstate.create_train_state(split, tx, jax.random.PRNGKey(3))
    save = save_checkpoint if fmt == "msgpack" else save_checkpoint_sharded
    path = save(tmp_path, state)
    model = load_params(path, pt.Transformer(pt.TransformerConfig(**GPT),
                                             device="cpu", seed=9))
    want = _sd("gpt", params)
    for name, v in model.state_dict().items():
        assert torch.equal(v, want[name]), name

