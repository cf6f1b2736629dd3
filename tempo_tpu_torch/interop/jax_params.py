"""tempo_tpu AutoencoderKL parameter tree -> the port's state_dict.

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

The tree comes as nested dicts of numpy arrays (``{"params": ...}`` or the
bare tree).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _conv(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (3, 2, 0, 1))


def _dense(k: np.ndarray) -> np.ndarray:
    return np.transpose(k, (1, 0))[:, :, None, None]


def _down(k: np.ndarray) -> np.ndarray:
    cout = k.shape[1]
    return _conv(k.reshape(2, 2, -1, cout))


def _up(k: np.ndarray) -> np.ndarray:
    cin = k.shape[0]
    return np.transpose(k.reshape(cin, 2, 2, -1), (0, 3, 1, 2))


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
    return {k: torch.from_numpy(np.array(v, dtype=np.float32))
            for k, v in out.items()}
