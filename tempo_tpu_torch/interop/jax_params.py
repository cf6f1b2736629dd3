"""tempo_tpu parameter trees -> the port's state_dicts.

The port names its parameters after the reference PyTorch model
(``encoder.downs.{i}.resnet_blocks.{j}.net1.0.weight`` ...), so reference
checkpoints load with ``load_state_dict``. This module is the inverse of
tempo_tpu/interop/torch_ckpt.py ``params_from_torch_state_dict`` and keeps
its own copy of the layout conversions, inverted:

- conv kernel HWIO -> OIHW
- dense kernel [in, out] -> 1x1 conv [out, in, 1, 1]
- space-to-depth matmul kernel [(kh, kw, cin), cout] -> Conv2d [out, in, 2, 2]
- depth-to-space matmul kernel [cin, (di, dj, cout)] -> ConvTranspose2d
  [in, out, 2, 2]
- GroupNorm scale/bias -> weight/bias

``cunet_state_dict_from_jax``, ``cmlp_state_dict_from_jax`` and
``vdm_state_dict_from_jax`` do it for the diffusion toolkit's networks
(the inverse of tempo_tpu/interop/unet_ckpt.py, whose reference names the
port's CUNet and CMLP carry; 2-D and 3-D kernels alike).
``l2_state_dict_from_jax`` does it for the L2-supervised VAE (the inverse
of ``l2_params_from_torch_state_dict``), ``gpt_state_dict_from_jax`` does the same for the GPT (the inverse of
tempo_tpu/interop/gpt_ckpt.py; MoE and int8 trees too), and
``lora_state_dict_from_jax`` for its LoRA adapters, ``probe_state_dict_from_jax`` for the
probes of tempo_tpu/analysis/probes.py. The tree comes as nested dicts of numpy arrays (``{"params": ...}`` or the
bare tree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence, Tuple

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    """HWIO -> OIHW (DHWIO -> OIDHW)."""
    nd = k.ndim - 2
    return np.transpose(k, (nd + 1, nd) + tuple(range(nd)))


def _dense(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (1, 0))[:, :, None, None]


def _linear(k: np.ndarray) -> np.ndarray:
    """Dense kernel [in, out] -> nn.Linear weight [out, in]."""
    return np.transpose(k, (1, 0))


def _down(k: np.ndarray, dim: int = 2) -> np.ndarray:
    cout = k.shape[1]
    return _conv(k.reshape((2,) * dim + (-1, cout)))


def _up(k: np.ndarray, dim: int = 2) -> np.ndarray:
    cin = k.shape[0]
    return np.transpose(k.reshape((cin,) + (2,) * dim + (-1,)),
                        (0, dim + 1) + tuple(range(1, dim + 1)))


def _resnet(out: Dict, prefix: str, tree: Mapping, dropout: bool) -> None:
    conv2 = "net2.3" if dropout else "net2.2"
    out[f"{prefix}.net1.0.weight"] = tree["norm1"]["scale"]
    out[f"{prefix}.net1.0.bias"] = tree["norm1"]["bias"]
    out[f"{prefix}.net1.2.weight"] = _conv(tree["conv1"]["kernel"])
    out[f"{prefix}.net1.2.bias"] = tree["conv1"]["bias"]
    out[f"{prefix}.net2.0.weight"] = tree["norm2"]["scale"]
    out[f"{prefix}.net2.0.bias"] = tree["norm2"]["bias"]
    out[f"{prefix}.{conv2}.weight"] = _conv(tree["conv2"]["kernel"])
    out[f"{prefix}.{conv2}.bias"] = tree["conv2"]["bias"]
    if "skip" in tree:
        out[f"{prefix}.skip_conv.weight"] = _dense(tree["skip"]["kernel"])
        out[f"{prefix}.skip_conv.bias"] = tree["skip"]["bias"]


def _attn(out: Dict, prefix: str, tree: Mapping) -> None:
    out[f"{prefix}.norm.weight"] = tree["norm"]["scale"]
    out[f"{prefix}.norm.bias"] = tree["norm"]["bias"]
    for name in ("q", "k", "v", "proj_out"):
        out[f"{prefix}.{name}.weight"] = _dense(tree[name]["kernel"])
        out[f"{prefix}.{name}.bias"] = tree[name]["bias"]


def _level(out: Dict, prefix: str, tree: Mapping, dropout: bool) -> None:
    for key, sub in tree.items():
        if key.startswith("res"):
            _resnet(out, f"{prefix}.resnet_blocks.{key[3:]}", sub, dropout)
        elif key.startswith("attn"):
            _attn(out, f"{prefix}.attention_blocks.{key[4:]}", sub)


def state_dict_from_jax_params(params: Mapping[str, Any],
                               dropout: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> the port's (and the reference's)
    state_dict. ``dropout`` says the ResNetBlocks hold a Dropout module,
    which moves their second conv from ``net2.2`` to ``net2.3``."""
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    for coder in ("encoder", "decoder"):
        t = tree[coder]
        for conv in ("conv_in", "conv_out"):
            out[f"{coder}.{conv}.weight"] = _conv(t[conv]["kernel"])
            out[f"{coder}.{conv}.bias"] = t[conv]["bias"]
        out[f"{coder}.norm_out.weight"] = t["norm_out"]["scale"]
        out[f"{coder}.norm_out.bias"] = t["norm_out"]["bias"]
        for mid in ("mid1", "mid2"):
            _resnet(out, f"{coder}.{mid}", t[mid], dropout)
        if "mid_attn1" in t:
            _attn(out, f"{coder}.mid_attn1", t["mid_attn1"])
        for key, sub in t.items():
            if coder == "encoder" and key.startswith("down"):
                prefix = f"encoder.downs.{key[4:]}"
                _level(out, prefix, sub, dropout)
                out[f"{prefix}.down.weight"] = _down(sub["down_kernel"])
                out[f"{prefix}.down.bias"] = sub["down_bias"]
            elif coder == "decoder" and key.startswith("up"):
                prefix = f"decoder.ups.{key[2:]}"
                _level(out, prefix, sub, dropout)
                out[f"{prefix}.up.weight"] = _up(sub["up_kernel"])
                out[f"{prefix}.up.bias"] = sub["up_bias"]
    for name in ("quant_conv", "post_quant_conv"):
        out[f"{name}.weight"] = _dense(tree[name]["kernel"])
        out[f"{name}.bias"] = tree[name]["bias"]
    out["logvar"] = tree["logvar"]
    probe = sorted((k for k in tree if k.startswith("no2_probe_")
                    and k != "no2_probe_out"), key=lambda k: int(k[10:]))
    for i, name in enumerate(probe + ["no2_probe_out"] if probe else []):
        out[f"no2_probe.{i}.weight"] = _dense(tree[name]["kernel"])
        out[f"no2_probe.{i}.bias"] = tree[name]["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


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
    out = {f"vae.{k}": v for k, v in
           state_dict_from_jax_params(tree["vae"], dropout).items()}
    head: Dict[str, np.ndarray] = {}
    h = tree["l2_head"]
    for i in range(len(mlp_hidden)):
        head[f"{3 * i}.weight"] = _dense(h[f"dense{i}_kernel"])
        head[f"{3 * i + 1}.weight"] = h[f"norm{i}"]["scale"]
        head[f"{3 * i + 1}.bias"] = h[f"norm{i}"]["bias"]
    last = 3 * len(mlp_hidden)
    head[f"{last}.weight"] = _dense(h["out_kernel"])
    head[f"{last}.bias"] = h["out_bias"]
    out.update({f"l2_head.mlp.{k}": torch.from_numpy(
        np.array(v, dtype=np.float32)) for k, v in head.items()})
    return out


def gpt_state_dict_from_jax(params: Mapping[str, Any],
                            config: Any) -> Dict[str, torch.Tensor]:
    """JAX Transformer params (numpy leaves) -> the port's state_dict.

    The inverse of tempo_tpu/interop/gpt_ckpt.py
    ``params_from_torch_transformer`` (reference layout): dense kernels
    [in, out] become nn.Linear weights [out, in]; LayerNorm scale/bias
    become weight/bias; ``wte``/``wpe`` tables keep their layout. An MoE
    block's ``moe`` subtree (``router/kernel``, ``w1``, ``w2``, ``b1``,
    ``b2``) becomes ``moe.router.weight`` [E, d] and the stacked kernels
    as they are ([E, in, out]). An int8 tree (nn/quant.py) maps
    ``kernel_q`` [in, out] to ``kernel_q`` [out, in] beside its ``scale``,
    ``wte_q``/``wte_scale`` to ``transformer.wte.kernel_q``/``scale`` and
    the experts' ``w1_q``/``w1_scale``, ``w2_q``/``w2_scale`` as they are;
    int8 leaves stay int8, every other leaf becomes fp32. An untokenized
    model's ``wte`` {kernel [in, embd]} becomes ``transformer.wte.lin.weight``
    [embd, in]; the dict mode's ``embedders_<k>`` / ``unembedders_<k>``
    subtrees become ``embedders.<k>.*`` / ``unembedders.<k>.*``
    (``_module``). ``config`` is either package's TransformerConfig (only
    ``n_layer``, ``ln`` and ``mlp`` are read; ``wpe`` and ``lm_head`` are
    taken where the tree holds them)."""
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    if "wte_q" in tree:
        out["transformer.wte.kernel_q"] = tree["wte_q"]
        out["transformer.wte.scale"] = tree["wte_scale"]
    elif isinstance(tree.get("wte"), Mapping):  # untokenized: TiedLinear
        out["transformer.wte.lin.weight"] = _linear(tree["wte"]["kernel"])
    elif "wte" in tree:
        out["transformer.wte.weight"] = tree["wte"]
    if "wpe" in tree:
        out["transformer.wpe.weight"] = tree["wpe"]
    for key, sub in tree.items():
        for kind in ("embedders", "unembedders"):
            if key.startswith(kind + "_"):
                _module(out, f"{kind}.{key[len(kind) + 1:]}", sub)

    def linear(prefix: str, sub: Mapping) -> None:
        if "kernel_q" in sub:
            out[f"{prefix}.kernel_q"] = np.transpose(sub["kernel_q"], (1, 0))
            out[f"{prefix}.scale"] = sub["scale"]
        else:
            out[f"{prefix}.weight"] = np.transpose(sub["kernel"], (1, 0))
        if "bias" in sub:
            out[f"{prefix}.bias"] = sub["bias"]

    def norm(prefix: str, sub: Mapping) -> None:
        out[f"{prefix}.weight"] = sub["scale"]
        if "bias" in sub:
            out[f"{prefix}.bias"] = sub["bias"]

    for i in range(config.n_layer):
        blk, ref = tree[f"h_{i}"], f"transformer.h.{i}"
        if config.ln:
            norm(f"{ref}.ln_1", blk["ln_1"])
        linear(f"{ref}.attn.c_attn", blk["attn"]["c_attn"])
        linear(f"{ref}.attn.c_proj", blk["attn"]["c_proj"])
        if config.mlp:
            if config.ln:
                norm(f"{ref}.ln_2", blk["ln_2"])
            if "moe" in blk:
                moe = blk["moe"]
                linear(f"{ref}.moe.router", moe["router"])
                for key, value in moe.items():
                    if key != "router":
                        out[f"{ref}.moe.{key}"] = value
            else:
                linear(f"{ref}.mlp.c_fc", blk["mlp"]["c_fc"])
                linear(f"{ref}.mlp.c_proj", blk["mlp"]["c_proj"])
    if config.ln:
        norm("transformer.ln_f", tree["ln_f"])
    if "lm_head" in tree:
        linear("lm_head", tree["lm_head"])
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
        out[f"layers.{i}.weight"] = np.transpose(layer["kernel"], (1, 0))
        out[f"layers.{i}.bias"] = layer["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _tensors(out: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}


def _embed_mlp(out: Dict, prefix: str, tree: Mapping) -> None:
    """A CondMLP's fc1/fc2 -> the Sequential's linears 0 and 2."""
    for i, name in ((0, "fc1"), (2, "fc2")):
        out[f"{prefix}.{i}.weight"] = _linear(tree[name]["kernel"])
        out[f"{prefix}.{i}.bias"] = tree[name]["bias"]


def _cond_resnet(out: Dict, prefix: str, tree: Mapping,
                 dropout: bool) -> None:
    """A CondResNetBlock: the ResNetBlock's entries and its cond_proj{k}
    (a linear, or a CondMLP for the ``mlp`` type)."""
    _resnet(out, prefix, tree, dropout)
    for key, sub in tree.items():
        if key.startswith("cond_proj"):
            name = f"{prefix}.cond_projs.{key[9:]}"
            if "fc1" in sub:
                _embed_mlp(out, name, sub)
            else:
                out[f"{name}.weight"] = _linear(sub["kernel"])
                out[f"{name}.bias"] = sub["bias"]


def cunet_state_dict_from_jax(params: Mapping[str, Any],
                              dropout: bool = False
                              ) -> Dict[str, torch.Tensor]:
    """JAX CUNet params -> the port's (and the reference's) state_dict,
    2-D or 3-D (read from the kernels' rank); the inverse of
    tempo_tpu/interop/unet_ckpt.py ``params_from_torch_cunet``.
    ``dropout``: the blocks hold a Dropout module (dropout_prob > 0),
    which moves their second conv to ``net2.3``."""
    tree = params.get("params", params)
    dim = tree["conv_in"]["kernel"].ndim - 2
    out: Dict[str, np.ndarray] = {}
    for name in ("conv_in", "conv_out", "conv_residual_out"):
        if name in tree:
            out[f"{name}.weight"] = _conv(tree[name]["kernel"])
            out[f"{name}.bias"] = tree[name]["bias"]
    out["norm_out.weight"] = tree["norm_out"]["scale"]
    out["norm_out.bias"] = tree["norm_out"]["bias"]
    if "embed_t" in tree:
        _embed_mlp(out, "embed_t_conditioning", tree["embed_t"])
    for key, sub in tree.items():
        if key.startswith("embed_v"):
            _embed_mlp(out, f"embeds_v_conditionings.{key[7:]}", sub)
        elif key in ("mid1", "mid2"):
            _cond_resnet(out, key, sub, dropout)
        elif key == "mid_attn":
            _attn(out, "mid_attn1", sub)
        elif key.startswith(("down", "up")) and "_" in key:
            side, rest = ("down", key[4:]) if key.startswith("down") else (
                "up", key[2:])
            level, part = rest.split("_", 1)
            prefix = f"{side}s.{level}"
            if part.startswith("res"):
                _cond_resnet(out, f"{prefix}.resnet_blocks.{part[3:]}", sub,
                             dropout)
            elif part == "down":
                out[f"{prefix}.down.weight"] = _down(sub["kernel"], dim)
                out[f"{prefix}.down.bias"] = sub["bias"]
            elif part == "up":
                out[f"{prefix}.up.weight"] = _up(sub["kernel"], dim)
                out[f"{prefix}.up.bias"] = sub["bias"]
    return _tensors(out)


def cmlp_state_dict_from_jax(params: Mapping[str, Any]
                             ) -> Dict[str, torch.Tensor]:
    """JAX CMLP params -> the port's (and the reference's) state_dict:
    ``embed_t_conditioning``, ``layers.{i}``, ``embedders.{i}.{k}``; the
    inverse of tempo_tpu/interop/unet_ckpt.py ``params_from_torch_cmlp``."""
    tree = params.get("params", params)
    out: Dict[str, np.ndarray] = {}
    for key, sub in tree.items():
        if key == "embed_t":
            _embed_mlp(out, "embed_t_conditioning", sub)
        elif key.startswith("layer"):
            out[f"layers.{key[5:]}.weight"] = _linear(sub["kernel"])
            out[f"layers.{key[5:]}.bias"] = sub["bias"]
        elif key.startswith("embed"):
            i, k = key[5:].split("_")
            _embed_mlp(out, f"embedders.{i}.{k}", sub)
    return _tensors(out)


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
        return {f"velocity_model.{k}": v for k, v in
                cunet_state_dict_from_jax(tree["velocity_model"],
                                          dropout).items()}
    score = tree["score_model"]
    sd = (cmlp_state_dict_from_jax(score) if "layer0" in score
          else cunet_state_dict_from_jax(score, dropout))
    out = {f"score_model.{k}": v for k, v in sd.items()}
    gamma: Dict[str, np.ndarray] = {}
    g = tree.get("gamma", {})
    if "b" in g:
        gamma = {"b": g["b"], "w": g["w"]}
    elif "l1" in g:
        for name in ("l1", "l2", "l3"):
            gamma[f"{name}.weight"] = _linear(g[name]["kernel"])
            if "bias" in g[name]:
                gamma[f"{name}.bias"] = g[name]["bias"]
    out.update({f"gamma.{k}": v for k, v in _tensors(gamma).items()})
    return out
