"""tempo_tpu parameter trees -> the port's state_dicts.

The port names its parameters after the reference PyTorch model
(``encoder.downs.{i}.resnet_blocks.{j}.net1.0.weight`` ...), so reference
checkpoints load with ``load_state_dict``. The readers here are the
inverse of tempo_tpu/interop/torch_ckpt.py ``params_from_torch_state_dict``
(and of unet_ckpt.py, gpt_ckpt.py): each walks the JAX tree through the
model's rules in interop/jax_layout.py, the one table of names, leaves and
layout changes (HWIO kernels -> OIHW, dense kernels -> 1x1 convs or
nn.Linear weights, the resample matmul kernels -> kernel-2 convs, scale
-> weight), which the sharded checkpoint and chip_smoke.py's JAX-layout
writer read the other way:

- ``state_dict_from_jax_params``: the AutoencoderKL (and its vestigial
  NO2 probe); ``l2_state_dict_from_jax``: the L2-supervised VAE;
- ``cunet_state_dict_from_jax``, ``cmlp_state_dict_from_jax`` and
  ``vdm_state_dict_from_jax``: the diffusion toolkit's networks (2-D and
  3-D kernels alike; an SFM's velocity model too);
- ``gpt_state_dict_from_jax``: the GPT, its MoE and int8 trees and the
  untokenized table, and the dict mode's embedders and unembedders
  (``_module``, a generic walk of their flax submodules).

``lora_state_dict_from_jax`` reads the GPT's LoRA adapters and
``probe_state_dict_from_jax`` the probes of tempo_tpu/analysis/probes.py.
A tree comes as nested dicts of numpy arrays (``{"params": ...}`` or the
bare tree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch

from tempo_tpu_torch.interop import jax_layout


def _linear(k: np.ndarray) -> np.ndarray:
    """Dense kernel [in, out] -> nn.Linear weight [out, in]."""
    return np.transpose(k, (1, 0))


def _tensors(out: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _c2(dropout: bool) -> str:
    """The ResNetBlock's second conv's index: 3 behind a Dropout."""
    return "3" if dropout else "2"


def _n_probe(tree: Mapping) -> int:
    return sum(k.startswith("no2_probe_") for k in tree)


def _sfx(unet: Mapping) -> str:
    """"3" for a 3-D CUNet's tree (its resample kernels' kind), else ""."""
    return "3" if unet["conv_in"]["kernel"].ndim == 5 else ""


def state_dict_from_jax_params(params: Mapping[str, Any],
                               dropout: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> the port's (and the reference's)
    state_dict. ``dropout`` says the ResNetBlocks hold a Dropout module,
    which moves their second conv from ``net2.2`` to ``net2.3``."""
    tree = params.get("params", params)
    return _tensors(jax_layout.to_torch(
        jax_layout.vae_rules(_n_probe(tree)), tree, c2=_c2(dropout)))


def l2_state_dict_from_jax(params: Mapping[str, Any],
                           mlp_hidden=(512, 512), dropout: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """JAX VAEWithL2Head params ({'vae', 'l2_head'}) -> the port's (and
    the reference VAEWithL2Supervision's) state_dict: ``vae.*`` as
    ``state_dict_from_jax_params``, and ``l2_head.mlp.{3i}`` (the bias-free
    dense), ``l2_head.mlp.{3i+1}`` (its GroupNorm) for each hidden width,
    then the output dense; the inverse of tempo_tpu/interop/torch_ckpt.py
    ``l2_params_from_torch_state_dict``. ``dropout`` as for
    ``state_dict_from_jax_params``."""
    tree = params.get("params", params)
    return _tensors(jax_layout.to_torch(
        jax_layout.l2_rules(len(mlp_hidden), _n_probe(tree["vae"])), tree,
        c2=_c2(dropout)))


def gpt_state_dict_from_jax(params: Mapping[str, Any],
                            config: Any = None) -> Dict[str, torch.Tensor]:
    """JAX Transformer params (numpy leaves) -> the port's state_dict.

    The inverse of tempo_tpu/interop/gpt_ckpt.py
    ``params_from_torch_transformer`` (reference layout), through
    ``jax_layout.gpt_rules``: dense kernels [in, out] become nn.Linear
    weights [out, in]; LayerNorm scale/bias become weight/bias;
    ``wte``/``wpe`` tables keep their layout. An MoE block's ``moe``
    subtree becomes ``moe.router.weight`` [E, d] and the stacked kernels
    as they are ([E, in, out]). An int8 tree (nn/quant.py) maps
    ``kernel_q`` [in, out] to ``kernel_q`` [out, in] beside its ``scale``,
    ``wte_q``/``wte_scale`` to ``transformer.wte.kernel_q``/``scale`` and
    the experts' ``w1_q``/``w1_scale``, ``w2_q``/``w2_scale`` as they are;
    int8 leaves stay int8, every other leaf becomes fp32. An untokenized
    model's ``wte`` {kernel [in, embd]} becomes ``transformer.wte.lin.weight``
    [embd, in]; the dict mode's ``embedders_<k>`` / ``unembedders_<k>``
    subtrees become ``embedders.<k>.*`` / ``unembedders.<k>.*``
    (``_module``). The tree gives the layers, norms, ``wpe`` and
    ``lm_head``; ``config`` (either package's TransformerConfig) is not
    read."""
    tree = params.get("params", params)
    modes = ("embedders", "unembedders")
    out = jax_layout.to_torch(jax_layout.gpt_rules(), {
        k: v for k, v in tree.items()
        if not k.startswith(tuple(m + "_" for m in modes))})
    for key, sub in tree.items():
        for kind in modes:
            if key.startswith(kind + "_"):
                _module(out, f"{kind}.{key[len(kind) + 1:]}", sub)
    return {k: _tensor_as_stored(v) for k, v in out.items()}


def _module(out: Dict, prefix: str, tree: Mapping) -> None:
    """A flax submodule's tree under the torch module at ``prefix``: Dense
    ``kernel`` [in, out] -> Linear ``weight`` [out, in], Embed
    ``embedding`` and LayerNorm ``scale`` -> ``weight``, ``bias`` as it
    is; nested modules by their names (the embedders and unembedders of
    the GPT's dict mode)."""
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            _module(out, f"{prefix}.{key}", sub)
        elif key == "kernel":
            out[f"{prefix}.weight"] = _linear(sub)
        elif key in ("embedding", "scale"):
            out[f"{prefix}.weight"] = sub
        else:
            out[f"{prefix}.{key}"] = sub


def _tensor_as_stored(value) -> torch.Tensor:
    """int8 leaves as int8 (the quantized kernels), the rest as fp32."""
    arr = np.asarray(value)
    if arr.dtype == np.int8:
        return torch.from_numpy(np.array(arr))
    return torch.from_numpy(np.array(arr, dtype=np.float32))


def lora_state_dict_from_jax(lora: Mapping[str, Any],
                             config: Any) -> Dict[str, Dict[str, torch.Tensor]]:
    """A JAX adapter tree (tempo_tpu/nn/lora.py ``init_lora``: {'a', 'b'}
    under each adapted leaf's path) -> the port's adapters (nn/lora.py):
    {parameter name: {'a', 'b'}}, the factors as they are ([..., in, r]
    and [..., r, out], JAX's orientation). The names are the ones
    ``gpt_state_dict_from_jax`` gives the adapted leaves: a dense
    ``kernel`` is the Linear's ``weight``, ``w1``/``w2`` keep theirs."""
    tree = lora.get("params", lora)
    flat: Dict[str, Any] = {}

    def walk(node: Mapping, path: Tuple[str, ...]) -> None:
        if "a" in node and "b" in node and not isinstance(node["a"],
                                                          Mapping):
            flat["/".join(path)] = node
            return
        for key, sub in node.items():
            walk(sub, path + (key,))

    walk(tree, ())
    names = {}
    for i in range(config.n_layer):
        jref, ref = f"h_{i}", f"transformer.h.{i}"
        for sub in ("attn/c_attn", "attn/c_proj", "mlp/c_fc", "mlp/c_proj",
                    "moe/router"):
            names[f"{jref}/{sub}/kernel"] = \
                f"{ref}.{sub.replace('/', '.')}.weight"
        for leaf in ("w1", "w2"):
            names[f"{jref}/moe/{leaf}"] = f"{ref}.moe.{leaf}"
    names["lm_head/kernel"] = "lm_head.weight"
    out = {}
    for path, factors in flat.items():
        if path not in names:
            raise KeyError(f"no port parameter for the adapted leaf {path}")
        out[names[path]] = {k: torch.from_numpy(
            np.array(factors[k], dtype=np.float32)) for k in ("a", "b")}
    return out


def probe_state_dict_from_jax(params: Sequence[Mapping[str, Any]]
                              ) -> Dict[str, torch.Tensor]:
    """A JAX probe's [{kernel [in, out], bias [out]}] -> the state_dict of
    the port's analysis/probes.py ``Probe`` (``layers.{i}`` nn.Linear
    weights [out, in])."""
    out: Dict[str, np.ndarray] = {}
    for i, layer in enumerate(params):
        out[f"layers.{i}.weight"] = _linear(layer["kernel"])
        out[f"layers.{i}.bias"] = layer["bias"]
    return _tensors(out)


def cunet_state_dict_from_jax(params: Mapping[str, Any],
                              dropout: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """JAX CUNet params -> the port's (and the reference's) state_dict,
    2-D or 3-D (read from the kernels' rank); the inverse of
    tempo_tpu/interop/unet_ckpt.py ``params_from_torch_cunet``.
    ``dropout``: the blocks hold a Dropout module (dropout_prob > 0),
    which moves their second conv to ``net2.3``."""
    tree = params.get("params", params)
    return _tensors(jax_layout.to_torch(
        jax_layout.cunet_rules(), tree, c2=_c2(dropout), sfx=_sfx(tree)))


def cmlp_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX CMLP params -> the port's (and the reference's) state_dict:
    ``embed_t_conditioning``, ``layers.{i}``, ``embedders.{i}.{k}``; the
    inverse of tempo_tpu/interop/unet_ckpt.py ``params_from_torch_cmlp``."""
    tree = params.get("params", params)
    return _tensors(jax_layout.to_torch(jax_layout.cmlp_rules(), tree))


def vdm_state_dict_from_jax(params: Mapping[str, Any],
                            dropout: bool = False
                            ) -> Dict[str, torch.Tensor]:
    """JAX VDM params -> the port's VDM state_dict: ``score_model.*`` (a
    CUNet's or, where the tree holds ``layer0``, a CMLP's) and a learned
    schedule's ``gamma.b``/``gamma.w`` (learned_linear) or
    ``gamma.l1``/``l2``/``l3`` (learned_nn, nn.Linear layouts); the
    inverse of tempo_tpu/interop/unet_ckpt.py ``params_from_torch_vdm``.
    An SFM's params ({'velocity_model': CUNet}) give ``velocity_model.*``."""
    tree = params.get("params", params)
    if "velocity_model" in tree:
        return _tensors(jax_layout.to_torch(
            jax_layout.sfm_rules(), tree, c2=_c2(dropout),
            sfx=_sfx(tree["velocity_model"])))
    score = tree["score_model"]
    if "layer0" in score:
        rules, sfx = jax_layout.vdm_rules(jax_layout.cmlp_rules()), ""
    else:
        rules, sfx = jax_layout.vdm_rules(jax_layout.cunet_rules()), _sfx(
            score)
    return _tensors(jax_layout.to_torch(rules, tree, c2=_c2(dropout),
                                        sfx=sfx))
