"""LoRA fine-tuning in the port (tempo_tpu_torch/nn/lora.py, cli/train_gpt.py
``finetune``) against tempo_tpu's on the CPU in fp32: the adapters' shapes
and step 0 equal to the base; ``apply_lora`` / ``merge_lora`` over JAX's
adapters (bridged by ``lora_state_dict_from_jax``), the stacked MoE
experts included; one fine-tune AdamW step from JAX's adapters against
JAX's (the base frozen, the adapters undecayed); and ``train_gpt``'s
merged_final.pt. Merged weights agree to 1e-6 (fp32 matmuls of rank r in
another order), the loss to 1e-5 relative and the updated adapters to
1e-4 relative L2."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.cli.train_gpt import _lm_loss_fn
from tempo_tpu.nn import lora as jlora
from tempo_tpu.nn import transformer as jt
from tempo_tpu_torch.cli import train_gpt
from tempo_tpu_torch.interop.jax_params import (gpt_state_dict_from_jax,
                                                lora_state_dict_from_jax)
from tempo_tpu_torch.nn import lora as plora
from tempo_tpu_torch.nn import transformer as pt
from tempo_tpu_torch.train import state as pstate
from tempo_tpu_torch.train import step as pstep

from test_torch_moe import perturbed

torch.set_num_threads(1)

VOCAB, BLOCK, RANK = 37, 16, 3
CASES = {"dense": {}, "untied_moe": dict(n_experts=2, tie_emb=False)}


def _rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _bridged(case, seed=0):
    kw = dict(in_size=VOCAB, block_size=BLOCK, n_layer=2, n_head=2,
              n_embd=32, **CASES[case])
    pcfg = pt.TransformerConfig(attn_impl="xla", **kw)
    jcfg = jt.TransformerConfig(attn_impl="xla", **kw)
    jmodel = jt.Transformer(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, BLOCK), jnp.int32))["params"]
    params = perturbed(jax.tree_util.tree_map(np.asarray, params), seed + 1)
    model = pt.Transformer(pcfg, device="cpu")
    model.load_state_dict(gpt_state_dict_from_jax(params, pcfg))
    # JAX's adapters, b moved off 0 so that the deltas are not 0
    lora = jlora.init_lora(params, RANK, jax.random.PRNGKey(seed + 7))
    lora = perturbed(jax.tree_util.tree_map(np.asarray, lora), seed + 2,
                     scale=0.02)
    return jmodel, params, model, lora, pcfg


@pytest.mark.parametrize("case", list(CASES))
def test_init_shapes_and_step_zero_is_the_base(case):
    _, params, model, jl, pcfg = _bridged(case)
    ad = plora.init_lora(model, RANK, seed=1)
    want = lora_state_dict_from_jax(jl, pcfg)
    assert set(ad) == set(want)
    for name, ab in ad.items():
        for k in ("a", "b"):
            assert ab[k].shape == want[name][k].shape, (name, k)
        assert torch.count_nonzero(ab["b"]) == 0
    assert plora.num_lora_params(ad) == jlora.num_lora_params(jl)
    if case == "untied_moe":
        assert ad["transformer.h.0.moe.w1"]["a"].shape == (2, 32, RANK)
        assert ad["transformer.h.1.moe.router.weight"]["b"].shape == (RANK,
                                                                       2)
        assert "lm_head.weight" in ad
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, VOCAB, (2, BLOCK)))
    adapted = plora.LoRA(model, ad)
    with torch.no_grad():
        assert torch.equal(adapted(toks), model(toks))
    with pytest.raises(ValueError, match="rank"):
        plora.init_lora(model, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_apply_and_merge_lora_match_jax(case):
    _, params, model, jl, pcfg = _bridged(case)
    want = gpt_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jlora.merge_lora(params, jl, scale=0.7)), pcfg)
    ad = lora_state_dict_from_jax(jl, pcfg)
    got = plora.merge_lora(model.state_dict(), ad, 0.7)
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
    merged = plora.LoRA(model, ad, 0.7).merged_state_dict()
    for name, w in got.items():
        assert torch.equal(merged[name], w), name


@pytest.mark.parametrize("case", list(CASES))
def test_one_finetune_step_matches_jax(case):
    jmodel, params, model, jl, pcfg = _bridged(case)
    toks = np.random.default_rng(5).integers(0, VOCAB, (3, BLOCK + 1))
    scale, lr, wd = 0.5, 1e-2, 0.1
    # JAX: the CLI's LM loss over apply_lora(base, adapters), AdamW over
    # the adapter tree with the GPT decay mask (a and b: no decay)
    inner = _lm_loss_fn(jmodel, 0.01)
    base = jax.tree_util.tree_map(jnp.asarray, params)

    def jloss(lora, batch):
        return inner(jlora.apply_lora(base, lora, scale), batch, None)

    lora = jax.tree_util.tree_map(jnp.asarray, jl)
    (want_loss, _), grads = jax.value_and_grad(jloss, has_aux=True)(
        lora, jnp.asarray(toks, jnp.int32))
    tx = jt.make_gpt_optimizer(lora, wd, lr, (0.9, 0.95))
    upd, _ = tx.update(grads, tx.init(lora), lora)
    want = lora_state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, jax.tree_util.tree_map(lambda p, u: p + u, lora, upd)),
        pcfg)
    assert not any(jax.tree_util.tree_leaves(jt.gpt_decay_mask(lora)))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    adapted = plora.LoRA(model, lora_state_dict_from_jax(jl, pcfg), scale)
    ptx = pt.make_gpt_optimizer(adapted, wd, lr, (0.9, 0.95))
    assert not any(pt.gpt_decay_mask(adapted).values())
    state = pstate.create_train_state(adapted, ptx)
    state, metrics = pstep.make_train_step(pstep.lm_loss_fn(model), ptx)(
        state, torch.from_numpy(toks))
    np.testing.assert_allclose(metrics["loss"].item(), float(want_loss),
                               rtol=1e-5)
    for name, ab in adapted.lora().items():
        for k in ("a", "b"):
            assert _rel_l2(ab[k].detach().numpy(),
                           want[name][k].numpy()) <= 1e-4, (name, k)
    # the base is frozen: untouched, no gradient, not in the state
    for name, v in model.state_dict().items():
        assert torch.equal(v, before[name]), name
    assert all(not p.requires_grad and p.grad is None
               for p in model.parameters())
    assert all(k.startswith("adapters.") for k in adapted.state_dict())


def test_lora_loss_fn_reaches_only_the_adapters():
    _, params, model, jl, pcfg = _bridged("dense")
    ad = {n: {k: v.clone().requires_grad_() for k, v in ab.items()}
          for n, ab in lora_state_dict_from_jax(jl, pcfg).items()}
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, VOCAB, (2, BLOCK + 1)))
    loss_fn = plora.lora_loss_fn(pstep.lm_loss_fn(model), model, 0.5)
    loss, _ = loss_fn(ad, toks, None)
    loss.backward()
    assert all(t.grad is not None for ab in ad.values() for t in ab.values())
    assert all(p.grad is None for p in model.parameters())
    want, _ = pstep.lm_loss_fn(model)(
        plora.LoRA(model, lora_state_dict_from_jax(jl, pcfg), 0.5), toks,
        None)
    assert loss.item() == want.item()


def test_train_gpt_finetune_writes_merged_final(tmp_path):
    base_cfg = {
        "output_dir": str(tmp_path / "base"), "seed": 3,
        "data": {"synthetic": {"vocab_size": 17, "length": 3000},
                 "batch_size": 4},
        "model": {"n_layer": 2, "n_head": 2, "n_embd": 32, "block_size": 32},
        "optimizer": {"lr": 3e-3},
        "training": {"n_steps": 3, "save_every": 3, "val_every": 3,
                     "plot_every": 1000},
        "generation": {"n_tokens": 0}}
    train_gpt.run(base_cfg, device="cpu")
    base_path = tmp_path / "base" / "checkpoints" / "ckpt_step=000003.pt"
    base_bytes = base_path.read_bytes()
    ft = dict(base_cfg, output_dir=str(tmp_path / "ft"),
              training=dict(base_cfg["training"], n_steps=4, save_every=4,
                            val_every=4),
              finetune={"lora_rank": 4, "lora_scale": 2.0,
                        "base_checkpoint": str(base_path)},
              generation={"n_tokens": 5})
    trainer, _ = train_gpt.run(ft, device="cpu")
    assert base_path.read_bytes() == base_bytes
    ckpts = tmp_path / "ft" / "checkpoints"
    adapters = torch.load(ckpts / "ckpt_step=000004.pt",
                          weights_only=True)["model"]
    base = torch.load(base_path, weights_only=True)["model"]
    merged = torch.load(ckpts / "merged_final.pt", weights_only=True)
    assert merged["step"] == 4 and set(merged["model"]) == set(base)
    moved = 0
    for name, w in base.items():
        key = "adapters." + name.replace(".", "/")
        if key + ".a" not in adapters:
            assert torch.equal(merged["model"][name], w), name
            continue
        delta = plora.lora_delta(name, adapters[key + ".a"],
                                 adapters[key + ".b"], 2.0)
        assert torch.equal(merged["model"][name], w + delta), name
        moved += int(torch.count_nonzero(adapters[key + ".b"]) > 0)
    assert moved > 0
    gen = np.load(tmp_path / "ft" / "generation_final.npy")
    model = pt.Transformer(pt.TransformerConfig(
        in_size=17, n_layer=2, n_head=2, n_embd=32, block_size=32),
        device="cpu")
    model.load_state_dict(merged["model"])
    want = pt.generate(model, torch.from_numpy(gen[:, :8].astype(np.int64)),
                       5, temperature=0.0)
    np.testing.assert_array_equal(gen, want.numpy())
    assert dataclasses.is_dataclass(trainer.state.model.config)
