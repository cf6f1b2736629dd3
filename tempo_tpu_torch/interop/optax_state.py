"""The JAX package's full train state (a ``ckpt_step=*.msgpack`` of
tempo_tpu/train/checkpoint.py) restored into the port's TrainState: the
resume of a JAX run.

The payload is ``{"step", "params", "opt_state", "rng", "ema",
"train_metrics", "val_metrics"}``, ``opt_state`` being optax's state
through flax's ``to_state_dict`` (tuples become dicts keyed "0", "1", ...,
namedtuples dicts of their fields). Every optimizer the JAX CLIs build
holds exactly one ``ScaleByAdamState`` {count, mu, nu}:

- ``chain(clip_by_global_norm, adamw)`` (train/state.py, the VAE, L2 and
  diffusion trainers): {"0": {} (clip), "1": {"0": adam, "1": {} (decay),
  "2": {} or {"count"} (a constant or scheduled lr)}};
- GPT's masked ``adamw`` (nn/transformer.py make_gpt_optimizer): {"0":
  adam, "1": {"inner_state": {}} (MaskedState), "2": ...}, its mu in bf16
  under ``moments_dtype: bfloat16`` (optax's ``mu_dtype``; the reader
  widens it exactly to fp32, and ``MuAdamW`` stores it back in bf16);
- a LoRA run's: the same over the adapter tree, which is its ``params``.

``adam_state`` finds it wherever it sits. Each moment tree is laid out as
the parameters are (kernels transposed, HWIO -> OIHW, the tied ``wte``
once) and goes through the parameters' own converter
(interop/jax_ckpt.py ``jax_state_dict_for``), so mu and nu land on torch's
AdamW ``exp_avg`` / ``exp_avg_sq`` of the same parameter; optax's single
``count`` is every parameter's ``step`` and the TrainState's step. The
EMA and the metric histories are restored. A JAX PRNG key has no torch
counterpart: the port's generator is seeded with ``generator_seed(key)``,
the key's uint32 words read as one integer (word i times 2^(32 i)), so a
resumed run is deterministic but draws other noise (the VAE's posterior
samples, dropout masks) than the JAX run would have.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from tempo_tpu_torch.parallel import pipeline

ADAM_FIELDS = frozenset({"count", "mu", "nu"})


def adam_state(opt_state: Any) -> Mapping[str, Any]:
    """The one ScaleByAdamState ({count, mu, nu}) in an optax state
    dict; raises unless there is exactly one."""
    found: List[Mapping[str, Any]] = []

    def walk(node: Any) -> None:
        if not isinstance(node, Mapping):
            return
        if ADAM_FIELDS <= set(node):
            found.append(node)
            return
        for sub in node.values():
            walk(sub)

    walk(opt_state)
    if len(found) != 1:
        raise ValueError(f"expected one optax AdamW state (count, mu, nu) "
                         f"in the checkpoint's opt_state, found "
                         f"{len(found)}")
    return found[0]


def generator_seed(key: Any) -> int:
    """The seed of the port's generator for a JAX PRNG key: its uint32
    words as one non-negative integer, word i times 2^(32 i)."""
    words = np.asarray(key, dtype=np.uint32).reshape(-1)
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def load_jax_train_state(raw: Mapping[str, Any], state,
                         load_full=None) -> Tuple[Any, List[Dict], List[Dict]]:
    """Restore ``state`` (train/state.py TrainState of the port model
    and optimizer matching the JAX run) in place from a decoded JAX
    checkpoint ``raw`` (interop/jax_ckpt.py ``read_jax_checkpoint``);
    returns it with the train and validation metric histories. The
    moments take the optimizer's types (MuAdamW's first moment bf16).
    ``load_full(state, model_sd, opt_sd)`` loads the one-device state
    dicts (train/checkpoint.py ``load_full_state``, which gives each
    shard its slice under FSDP2 or tensor parallelism); None loads them
    as they are."""
    from tempo_tpu_torch.interop.jax_ckpt import jax_state_dict_for

    model, opt = state.model, state.optimizer
    model_sd = jax_state_dict_for(model, raw["params"])
    adam = adam_state(raw["opt_state"])
    mu = jax_state_dict_for(model, adam["mu"])
    nu = jax_state_dict_for(model, adam["nu"])
    count = int(np.asarray(adam["count"]))
    torch_sd = opt.state_dict()
    pp = pipeline.of(model)
    if pp is None:
        names = {id(p): n for n, p in model.named_parameters()}
        order = [names[id(p)] for g in opt.param_groups for p in g["params"]]
    else:  # one device's optimizer indices, over every stage's parameters
        order = pipeline.one_device_order(model, state.tx)
    torch_sd["state"] = {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, name in enumerate(order)}
    if load_full is None:
        model.load_state_dict(model_sd)
        opt.load_state_dict(torch_sd)
    else:
        load_full(state, model_sd, torch_sd)
    state.generator.manual_seed(generator_seed(raw["rng"]))
    if raw.get("ema"):
        device = next(model.parameters()).device
        state.ema = {k: torch.tensor(float(v), dtype=torch.float32,
                                     device=device)
                     for k, v in raw["ema"].items()}
    state.step = int(np.asarray(raw["step"]))
    return (state, json.loads(raw.get("train_metrics", "[]")),
            json.loads(raw.get("val_metrics", "[]")))
