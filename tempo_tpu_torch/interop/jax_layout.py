"""The one table between the port's parameters and the JAX package's trees.

Each model's rules (``vae_rules``, ``l2_rules``, ``gpt_rules``,
``cunet_rules``, ``cmlp_rules``, ``vdm_rules``, ``sfm_rules``) pair a
template of port parameter names with a template of leaf paths in the JAX
model's parameter tree (dict keys, as flax's ``to_state_dict`` gives
them) and the ``kind`` of layout change between the two. The same rules
serve both ways: ``jax_layout(model)`` maps every parameter of a port
model to its leaf (the sharded checkpoint, chip_smoke.py's JAX-layout
writer), ``to_torch`` maps every leaf of a JAX tree to its parameter
(interop/jax_params.py's readers).

- ``conv``: OIHW <-> HWIO (OIDHW <-> DHWIO for a 3-D conv);
- ``dense``: a 1x1 conv [out, in, 1, 1] <-> a dense kernel [in, out];
- ``linear``: nn.Linear [out, in] <-> [in, out];
- ``down``: a kernel-2 Conv2d [out, in, 2, 2] <-> the space-to-depth
  matmul kernel [(kh, kw, in), out] (``down3``: the 3-D one);
- ``up``: a kernel-2 ConvTranspose2d [in, out, 2, 2] <-> the
  depth-to-space matmul kernel [in, (di, dj, out)] (``up3``: 3-D);
- ``id``: the same array (norm scales and biases, biases, ``wte``/``wpe``
  tables, ``logvar``).

``to_jax`` / ``from_jax`` convert a whole tensor or a box of it: a slice
along a torch dimension that the kind keeps whole in JAX (``jax_axis``
names the JAX axis it becomes) converts to the matching slice of the JAX
leaf. That is how a rank's shard of a parameter is written into, and read
from, its region of a JAX-layout file (train/sharded_checkpoint.py)
without the whole leaf. Both take numpy arrays and torch tensors.

``optax_paths`` gives where optax keeps AdamW's count, moments and the
schedule's count in the state of the optimizers the JAX CLIs build
(interop/optax_state.py describes those trees).
"""

from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

Path = Tuple[str, ...]

# torch axis -> JAX axis for the kinds that only permute
_PERM_TO_JAX = {"linear": (1, 0)}


def _conv_perm(ndim: int) -> tuple:
    """OI(D)HW -> (D)HWIO."""
    return tuple(range(2, ndim)) + (1, 0)


def _inverse(perm: tuple) -> tuple:
    return tuple(perm.index(i) for i in range(len(perm)))


def _spatial(kind: str) -> int:
    return 3 if kind.endswith("3") else 2


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter's JAX leaf: its path in the params tree and the kind of
    layout change (see the module doc)."""

    path: Path
    kind: str


def _perm(a, axes):
    return a.permute(*axes) if torch.is_tensor(a) else a.transpose(axes)


def to_jax(kind: str, a):
    """A torch-layout tensor or array (or a box of one along a dimension
    the kind keeps whole) in the JAX layout."""
    if kind == "id":
        return a
    if kind in _PERM_TO_JAX:
        return _perm(a, _PERM_TO_JAX[kind])
    if kind == "conv":
        return _perm(a, _conv_perm(a.ndim))
    if kind == "dense":
        return _perm(a[:, :, 0, 0], (1, 0))
    if kind.startswith("down"):
        return _perm(a, _conv_perm(a.ndim)).reshape(-1, a.shape[0])
    if kind.startswith("up"):
        k = a.ndim - 2
        return _perm(a, (0,) + tuple(range(2, k + 2)) + (1,)).reshape(
            a.shape[0], -1)
    raise ValueError(f"unknown layout kind {kind!r}")


def from_jax(kind: str, a):
    """The inverse of ``to_jax``."""
    if kind == "id":
        return a
    if kind == "conv":
        return _perm(a, _inverse(_conv_perm(a.ndim)))
    if kind == "linear":
        return _perm(a, (1, 0))
    if kind == "dense":
        return _perm(a, (1, 0))[:, :, None, None]
    k = _spatial(kind)
    if kind.startswith("down"):
        cout = a.shape[1]
        return _perm(a.reshape((2,) * k + (-1, cout)),
                     _inverse(_conv_perm(k + 2)))
    if kind.startswith("up"):
        cin = a.shape[0]
        return _perm(a.reshape((cin,) + (2,) * k + (-1,)),
                     (0, k + 1) + tuple(range(1, k + 1)))
    raise ValueError(f"unknown layout kind {kind!r}")


def jax_axis(kind: str, dim: int, ndim: int) -> int:
    """The JAX axis that torch dimension ``dim`` of an ``ndim``-d
    parameter of ``kind`` becomes; ValueError where the kind merges it
    with others (a box along it is no box of the JAX leaf)."""
    if kind == "id":
        return dim
    if kind in _PERM_TO_JAX:
        return _PERM_TO_JAX[kind].index(dim)
    if kind == "conv":
        return _conv_perm(ndim).index(dim)
    table = {"dense": {0: 1, 1: 0}, "down": {0: 1}, "up": {0: 0}}[
        kind.rstrip("3")]
    if dim not in table:
        raise ValueError(f"torch dimension {dim} of a {kind!r} parameter "
                         f"is merged with others in the JAX layout")
    return table[dim]


def torch_dim_of_last(kind: str, ndim: int) -> Optional[int]:
    """The torch dimension that becomes the JAX leaf's last axis, or None
    where that axis merges several (``up``: (di, dj, out))."""
    if kind.startswith("up"):
        return None
    jax_ndim = 2 if kind in ("dense", "down", "down3") else ndim
    for d in range(ndim):
        try:
            if jax_axis(kind, d, ndim) == jax_ndim - 1:
                return d
        except ValueError:
            continue
    return None


def jax_shape(kind: str, shape) -> tuple:
    """The JAX leaf's shape for a torch parameter of ``shape``."""
    return tuple(to_jax(kind, torch.empty(tuple(shape), device="meta")).shape)


# ------------------------------------------------------------ the table
#
# A rule pairs a template of port parameter names with a template of JAX
# leaf paths ('/'-joined) and a layout kind. ``{x}`` stands for a run of
# digits, or for one of the words _WORDS gives x; a placeholder of the
# name that the path lacks (``c2``: the second conv's index, 3 behind a
# Dropout) is fixed by the caller when reading a JAX tree, and ``{sfx}``
# in a kind ("3" for the 3-D CUNet) likewise. The same rule maps a name to
# its leaf (``jax_layout``) and a leaf to its name (``to_torch``).

Rule = Tuple[str, str, str]

_WORDS = {"coder": "encoder|decoder", "qc": "quant_conv|post_quant_conv",
          "c2": "2|3", "mid": "mid1|mid2",
          "conv": "conv_in|conv_out|conv_residual_out",
          "leaf": "[A-Za-z0-9_]+", "g": "b|w", "gl": "l1|l2|l3"}


def _mod(name: str, path: str, kind: str) -> List[Rule]:
    """A kernel-holding module: weight <-> kernel (as ``kind``), bias."""
    return [(f"{name}.weight", f"{path}/kernel", kind),
            (f"{name}.bias", f"{path}/bias", "id")]


def _norm(name: str, path: str) -> List[Rule]:
    """A GroupNorm or LayerNorm: weight <-> scale, bias."""
    return [(f"{name}.weight", f"{path}/scale", "id"),
            (f"{name}.bias", f"{path}/bias", "id")]


def _under(name: str, path: str, rules: List[Rule]) -> List[Rule]:
    return [(f"{name}.{n}", f"{path}/{q}", k) for n, q, k in rules]


_RES = (_norm("net1.0", "norm1") + _mod("net1.2", "conv1", "conv")
        + _norm("net2.0", "norm2") + _mod("net2.{c2}", "conv2", "conv")
        + _mod("skip_conv", "skip", "dense"))
_ATTN = _norm("norm", "norm") + [r for q in ("q", "k", "v", "proj_out")
                                 for r in _mod(q, q, "dense")]
_MLP = _mod("0", "fc1", "linear") + _mod("2", "fc2", "linear")
_COND_RES = (_RES + _mod("cond_projs.{k}", "cond_proj{k}", "linear")
             + _under("cond_projs.{k}", "cond_proj{k}", _MLP))

_VAE = (_mod("{coder}.{conv}", "{coder}/{conv}", "conv")
        + _norm("{coder}.norm_out", "{coder}/norm_out")
        + _under("{coder}.{mid}", "{coder}/{mid}", _RES)
        + _under("{coder}.mid_attn1", "{coder}/mid_attn1", _ATTN)
        + _under("encoder.downs.{l}.resnet_blocks.{j}",
                 "encoder/down{l}/res{j}", _RES)
        + _under("encoder.downs.{l}.attention_blocks.{j}",
                 "encoder/down{l}/attn{j}", _ATTN)
        + _under("decoder.ups.{l}.resnet_blocks.{j}",
                 "decoder/up{l}/res{j}", _RES)
        + _under("decoder.ups.{l}.attention_blocks.{j}",
                 "decoder/up{l}/attn{j}", _ATTN)
        + [("encoder.downs.{l}.down.weight", "encoder/down{l}/down_kernel",
            "down"),
           ("encoder.downs.{l}.down.bias", "encoder/down{l}/down_bias", "id"),
           ("decoder.ups.{l}.up.weight", "decoder/up{l}/up_kernel", "up"),
           ("decoder.ups.{l}.up.bias", "decoder/up{l}/up_bias", "id"),
           ("logvar", "logvar", "id")]
        + _mod("{qc}", "{qc}", "dense"))

_LINEAR_Q = [("{m}.kernel_q", "{m}/kernel_q", "linear"),
             ("{m}.scale", "{m}/scale", "id")]
_GPT_LINEARS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj",
                "moe.router")
_GPT = ([("transformer.wte.weight", "wte", "id"),
         ("transformer.wpe.weight", "wpe", "id"),
         # int8 (nn/quant.py) and untokenized (TiedLinear) tables
         ("transformer.wte.kernel_q", "wte_q", "id"),
         ("transformer.wte.scale", "wte_scale", "id"),
         ("transformer.wte.lin.weight", "wte/kernel", "linear")]
        + _under("transformer.h.{i}", "h_{i}", _norm("ln_1", "ln_1")
                 + _norm("ln_2", "ln_2")
                 + [r for m in _GPT_LINEARS for r in
                    _mod(m, m.replace(".", "/"), "linear")
                    + [(n.format(m=m), q.format(m=m.replace(".", "/")), k)
                       for n, q, k in _LINEAR_Q]]
                 # an MoE block's stacked experts (and their int8 forms)
                 + [("moe.{leaf}", "moe/{leaf}", "id")])
        + _norm("transformer.ln_f", "ln_f") + _mod("lm_head", "lm_head",
                                                   "linear")
        + [(n.format(m="lm_head"), q.format(m="lm_head"), k)
           for n, q, k in _LINEAR_Q])

_CUNET = (_mod("{conv}", "{conv}", "conv") + _norm("norm_out", "norm_out")
          + _under("embed_t_conditioning", "embed_t", _MLP)
          + _under("embeds_v_conditionings.{v}", "embed_v{v}", _MLP)
          + _under("{mid}", "{mid}", _COND_RES)
          + _under("mid_attn1", "mid_attn", _ATTN)
          + _under("downs.{l}.resnet_blocks.{j}", "down{l}_res{j}",
                   _COND_RES)
          + _under("ups.{l}.resnet_blocks.{j}", "up{l}_res{j}", _COND_RES)
          + [("downs.{l}.down.weight", "down{l}_down/kernel", "down{sfx}"),
             ("downs.{l}.down.bias", "down{l}_down/bias", "id"),
             ("ups.{l}.up.weight", "up{l}_up/kernel", "up{sfx}"),
             ("ups.{l}.up.bias", "up{l}_up/bias", "id")])

_CMLP = (_under("embed_t_conditioning", "embed_t", _MLP)
         + _mod("layers.{i}", "layer{i}", "linear")
         + _under("embedders.{i}.{k}", "embed{i}_{k}", _MLP))

_GAMMA = ([("gamma.{g}", "gamma/{g}", "id")]
          + _mod("gamma.{gl}", "gamma/{gl}", "linear"))


def _regex(template: str) -> "re.Pattern":
    out, seen = [], set()
    for i, part in enumerate(re.split(r"\{(\w+)\}", template)):
        if i % 2 == 0:
            out.append(re.escape(part))
        elif part in seen:
            out.append(f"(?P={part})")
        else:
            seen.add(part)
            out.append(f"(?P<{part}>{_WORDS.get(part, '[0-9]+')})")
    return re.compile("".join(out))


@functools.lru_cache(maxsize=None)
def _compiled(rules: Tuple[Rule, ...]) -> list:
    return [(_regex(n), _regex(q), n, q, k) for n, q, k in rules]


def _probe(n: int) -> List[Rule]:
    """The vestigial NO2 probe's ``n`` dense layers (the last one
    ``no2_probe_out``)."""
    return [r for i in range(n) for r in _mod(
        f"no2_probe.{i}", "no2_probe_out" if i == n - 1 else
        f"no2_probe_{i}", "dense")]


def vae_rules(n_probe: int = 0) -> Tuple[Rule, ...]:
    return tuple(_VAE + _probe(n_probe))


def l2_rules(n_hidden: int, n_probe: int = 0) -> Tuple[Rule, ...]:
    """The L2-supervised VAE: the VAE under ``vae``, then the head's
    bias-free dense and GroupNorm a hidden width (Sequential entries 3i,
    3i + 1) and its output dense."""
    head = [r for i in range(n_hidden) for r in
            [(f"mlp.{3 * i}.weight", f"dense{i}_kernel", "dense")]
            + _norm(f"mlp.{3 * i + 1}", f"norm{i}")]
    head += [(f"mlp.{3 * n_hidden}.weight", "out_kernel", "dense"),
             (f"mlp.{3 * n_hidden}.bias", "out_bias", "id")]
    return tuple(_under("vae", "vae", list(vae_rules(n_probe)))
                 + _under("l2_head", "l2_head", head))


def gpt_rules() -> Tuple[Rule, ...]:
    return tuple(_GPT)


def cunet_rules() -> Tuple[Rule, ...]:
    return tuple(_CUNET)


def cmlp_rules() -> Tuple[Rule, ...]:
    return tuple(_CMLP)


def vdm_rules(score: Tuple[Rule, ...]) -> Tuple[Rule, ...]:
    """A VDM over a score network of ``score``'s rules, with a learned
    schedule's ``gamma``."""
    return tuple(_under("score_model", "score_model", list(score))
                 + _GAMMA)


def sfm_rules() -> Tuple[Rule, ...]:
    return tuple(_under("velocity_model", "velocity_model", _CUNET))


def leaf_of(rules: Tuple[Rule, ...], name: str, **fixed: str) -> Leaf:
    """The JAX leaf of port parameter ``name`` under ``rules``."""
    for rn, _, _, q, k in _compiled(rules):
        m = rn.fullmatch(name)
        if m:
            values = dict(m.groupdict(), **fixed)
            return Leaf(tuple(q.format(**values).split("/")),
                        k.format(**values))
    raise KeyError(f"no JAX leaf for the parameter {name}")


def name_of(rules: Tuple[Rule, ...], path: Path, **fixed: str
            ) -> Tuple[str, str]:
    """(port parameter name, layout kind) of the JAX leaf at ``path``."""
    joined = "/".join(path)
    for _, rq, n, _, k in _compiled(rules):
        m = rq.fullmatch(joined)
        if m:
            values = dict(m.groupdict(), **fixed)
            return n.format(**values), k.format(**values)
    raise KeyError(f"no port parameter for the JAX leaf {joined}")


def _leaves(tree: Mapping, path: Path = ()):
    for key, sub in tree.items():
        if isinstance(sub, Mapping):
            yield from _leaves(sub, path + (key,))
        else:
            yield path + (key,), sub


def to_torch(rules: Tuple[Rule, ...], tree: Mapping,
             **fixed: str) -> Dict[str, np.ndarray]:
    """Every leaf of a JAX tree (nested dicts of arrays) under its port
    name, in the port's layout (views where the layout only permutes)."""
    out = {}
    for path, leaf in _leaves(tree):
        name, kind = name_of(rules, path, **fixed)
        out[name] = from_jax(kind, np.asarray(leaf))
    return out


def probe_depth(names) -> int:
    """How many layers the NO2 probe of these parameter names has."""
    return 1 + max((int(n.split(".")[-2]) for n in names
                    if "no2_probe." in n), default=-1)


def _layout(rules: Tuple[Rule, ...], names, **fixed: str
            ) -> Dict[str, Leaf]:
    return {n: leaf_of(rules, n, **fixed) for n in names}


def vae_layout(names) -> Dict[str, Leaf]:
    """An AutoencoderKL's parameter names -> their leaves."""
    names = list(names)
    return _layout(vae_rules(probe_depth(names)), names)


def gpt_layout(names) -> Dict[str, Leaf]:
    """A tokenized GPT's parameter names -> their leaves."""
    return _layout(gpt_rules(), names)


def _names(model: nn.Module) -> list:
    return [n for n, _ in model.named_parameters()]


def _sfx(unet: nn.Module) -> str:
    return "3" if unet.conv_in.weight.ndim == 5 else ""


def model_rules(model: nn.Module) -> Tuple[Tuple[Rule, ...], dict]:
    """(the rules, the fixed placeholders) of a port model: an
    AutoencoderKL, a VAEWithL2Head, a GPT, a CUNet, CMLP, VDM or SFM."""
    from tempo_tpu_torch.models.diffusion import VDM
    from tempo_tpu_torch.models.flow import SFM
    from tempo_tpu_torch.models.vae import AutoencoderKL
    from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head
    from tempo_tpu_torch.nn.transformer import Transformer
    from tempo_tpu_torch.nn.unet import CMLP, CUNet

    if isinstance(model, VAEWithL2Head):
        return l2_rules(len(model.mlp_hidden), probe_depth(_names(model))), {}
    if isinstance(model, AutoencoderKL):
        return vae_rules(probe_depth(_names(model))), {}
    if isinstance(model, Transformer):
        return gpt_rules(), {}
    if isinstance(model, CUNet):
        return cunet_rules(), {"sfx": _sfx(model)}
    if isinstance(model, CMLP):
        return cmlp_rules(), {}
    if isinstance(model, SFM):
        return sfm_rules(), {"sfx": _sfx(model.velocity_model)}
    if isinstance(model, VDM):
        score, fixed = model_rules(model.score_model)
        return vdm_rules(score), fixed
    raise NotImplementedError(
        f"no JAX layout table for {type(model).__name__} (AutoencoderKL, "
        f"VAEWithL2Head, Transformer, CUNet, CMLP, VDM, SFM)")


def jax_layout(model: nn.Module) -> Dict[str, Leaf]:
    """{parameter name: Leaf} for every parameter of ``model`` (a GPT
    only tokenized, without int8 weights: the layouts the sharded format
    takes)."""
    from tempo_tpu_torch.nn.transformer import Transformer

    if isinstance(model, Transformer):
        cfg = model.config
        if (cfg.quantize != "none" or not cfg.tokenized
                or model.embedders is not None):
            raise NotImplementedError(
                "the JAX layout table covers the tokenized GPT without "
                "int8 weights")
    rules, fixed = model_rules(model)
    return _layout(rules, _names(model), **fixed)


@dataclasses.dataclass(frozen=True)
class OptaxPaths:
    """Where optax keeps AdamW's ``count``, ``mu`` and ``nu`` (each moment
    a tree laid out as the params) and, for a scheduled learning rate, the
    schedule's ``count``, under ``opt_state``."""

    adam: Path
    schedule_count: Optional[Path]


def optax_paths(model: nn.Module, clipped: bool,
                scheduled: bool) -> OptaxPaths:
    """The JAX CLIs' optimizers: GPT's masked ``adamw`` ({"0": adam,
    "1": {"inner_state"}, "2": lr}); the others' ``chain(clip, adamw)``
    ({"0": clip, "1": adamw}), or ``chain(adamw)`` without the clip; an
    adamw is {"0": adam, "1": decay, "2": lr}."""
    from tempo_tpu_torch.nn.transformer import Transformer

    if isinstance(model, Transformer):
        adamw: Path = ()
    else:
        adamw = ("1",) if clipped else ("0",)
    return OptaxPaths(adamw + ("0",),
                      adamw + ("2", "count") if scheduled else None)
