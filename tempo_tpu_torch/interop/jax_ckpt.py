"""The JAX package's ``.msgpack`` checkpoints, read into the port's models.

``read_jax_checkpoint(path)`` decodes a checkpoint of
tempo_tpu/train/checkpoint.py (``{"step", "params", "opt_state", "rng",
"ema", "train_metrics", "val_metrics"}``) with interop/msgpack_reader.py:
no msgpack, flax or JAX is needed. ``jax_state_dict_for(model, params)``
turns its ``params`` tree into ``model``'s state_dict, by the model's class,
through interop/jax_params.py:

- ``AutoencoderKL``: ``state_dict_from_jax_params`` (from the ``vae``
  subtree where the checkpoint is an L2-supervised one);
- ``VAEWithL2Head``: ``l2_state_dict_from_jax`` with the head's widths;
- ``VDM`` and ``SFM``: ``vdm_state_dict_from_jax`` (a CUNet or CMLP score
  model, a learned schedule, an SFM's velocity model);
- ``Transformer``: ``gpt_state_dict_from_jax`` with the model's config
  (untokenized and embedder-mode trees too; a pipeline run's (rest,
  stage_stack), flax's {"0", "1"}, merged back to h_0 ... first:
  parallel/pipeline.py ``merge_pipeline_params``);
- ``LoRA`` (nn/lora.py): ``lora_state_dict_from_jax``, the adapters as
  ``adapters.<name with / for .>.{a, b}``.

Where the model's ResNet blocks hold a Dropout module (their second conv at
``net2.3``), the converters are told so. The converters take any tree laid
out as the parameters are, so optax's moments cross the same way
(interop/optax_state.py, the full-state resume).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping, Union

import torch
from torch import nn

from tempo_tpu_torch.interop import msgpack_reader
from tempo_tpu_torch.interop.jax_params import (gpt_state_dict_from_jax,
                                                l2_state_dict_from_jax,
                                                lora_state_dict_from_jax,
                                                state_dict_from_jax_params,
                                                vdm_state_dict_from_jax)


def read_jax_checkpoint(path: Union[str, Path]) -> Dict[str, Any]:
    """The decoded payload of a JAX ``ckpt_step=*.msgpack`` file."""
    raw = msgpack_reader.read(path)
    if not isinstance(raw, dict) or "params" not in raw:
        raise ValueError(f"{path}: not a checkpoint of the JAX package (no "
                         f"'params' in it)")
    return raw


def _has_dropout(model: nn.Module) -> bool:
    return any(".net2.3." in k for k in model.state_dict())


def jax_state_dict_for(model: nn.Module, params: Mapping[str, Any]
                       ) -> Dict[str, torch.Tensor]:
    """``params`` (a JAX model's parameter tree, numpy leaves) as the
    state_dict of ``model``, a port model of the same architecture."""
    from tempo_tpu_torch.models.diffusion import VDM
    from tempo_tpu_torch.models.flow import SFM
    from tempo_tpu_torch.models.vae import AutoencoderKL
    from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head
    from tempo_tpu_torch.nn.lora import LoRA
    from tempo_tpu_torch.nn.transformer import Transformer

    tree = params.get("params", params)
    if isinstance(model, LoRA):
        return {f"adapters.{name.replace('.', '/')}.{k}": v
                for name, ab in lora_state_dict_from_jax(
                    tree, model.config).items() for k, v in ab.items()}
    dropout = _has_dropout(model)
    if isinstance(model, VAEWithL2Head):
        return l2_state_dict_from_jax(tree, model.mlp_hidden, dropout)
    if isinstance(model, AutoencoderKL):
        if "l2_head" in tree:  # an L2-supervised checkpoint's VAE
            tree = tree["vae"]
        return state_dict_from_jax_params(tree, dropout)
    if isinstance(model, (VDM, SFM)):
        return vdm_state_dict_from_jax(tree, dropout)
    if isinstance(model, Transformer):
        if set(tree) == {"0", "1"}:  # a pipeline run's (rest, stage_stack)
            from tempo_tpu_torch.parallel.pipeline import (
                merge_pipeline_params)

            tree = merge_pipeline_params(tree["0"], tree["1"])
        return gpt_state_dict_from_jax(tree, model.config)
    raise TypeError(f"no JAX checkpoint converter for "
                    f"{type(model).__name__} (AutoencoderKL, VAEWithL2Head, "
                    f"VDM, SFM, Transformer, LoRA)")


def load_jax_params(path: Union[str, Path], model: nn.Module) -> nn.Module:
    """Load a JAX checkpoint's parameters into ``model`` (in place,
    strict; each shard or pipeline stage taking its part) and return
    it."""
    from tempo_tpu_torch.train.checkpoint import load_full_params

    params = read_jax_checkpoint(path)["params"]
    load_full_params(model, jax_state_dict_for(model, params))
    return model
