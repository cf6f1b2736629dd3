"""Torch GPT state dicts -> the port's GPT; counterpart of
tempo_tpu/interop/gpt_ckpt.py.

Two source layouts:

- the reference toolkit's GPT (``transformer.wte/wpe/h.{i}.{ln_1, attn,
  ln_2, mlp}/ln_f``, nn.Linear weights [out, in], an untokenized model's
  ``transformer.wte.lin.weight`` [embd, in]): the port's names and
  layouts, so its tensors are taken as they are;
- HuggingFace GPT2LMHeadModel: the same names, with Conv1D weights stored
  [in, out], transposed here.

Only the tensors the port's model holds are taken (HF's attention-mask
buffers and a tied ``lm_head.weight`` are not). ``from_hf_gpt2`` builds
(TransformerConfig, state_dict) from any object with GPT-2's ``.config``
fields (vocab_size, n_positions, n_layer, n_head, n_embd) and
``.state_dict()``: a GPT2LMHeadModel built locally needs no download, and
this module never imports ``transformers``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import torch

from tempo_tpu_torch.nn.transformer import TransformerConfig

# Conv1D ([in, out]) in HF's GPT-2; nn.Linear ([out, in]) in the reference
_MATMULS = ("attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")


def _tensor(t: Any) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32)


def state_dict_from_torch_transformer(state_dict: Mapping[str, Any],
                                      config: TransformerConfig,
                                      hf_layout: bool = False
                                      ) -> Dict[str, torch.Tensor]:
    """The port's state dict for ``config`` from a torch GPT state dict in
    the reference layout (``hf_layout=False``) or HuggingFace's (its
    Conv1D weights transposed); fp32 tensors on the host."""
    sd = dict(state_dict)
    out: Dict[str, torch.Tensor] = {}

    def take(key: str, transpose: bool = False) -> None:
        t = _tensor(sd[key])
        out[key] = t.t().contiguous() if transpose else t

    def optional(key: str) -> None:
        if sd.get(key) is not None:
            take(key)

    take("transformer.wte.weight" if config.tokenized
         else "transformer.wte.lin.weight")
    if config.pos_embed:
        take("transformer.wpe.weight")
    for i in range(config.n_layer):
        ref = f"transformer.h.{i}"
        norms = (("ln_1", "ln_2") if config.mlp else ("ln_1",)) \
            if config.ln else ()
        for ln in norms:
            take(f"{ref}.{ln}.weight")
            optional(f"{ref}.{ln}.bias")
        for mm in _MATMULS if config.mlp else _MATMULS[:2]:
            take(f"{ref}.{mm}.weight", transpose=hf_layout)
            optional(f"{ref}.{mm}.bias")
    if config.ln:
        take("transformer.ln_f.weight")
        optional("transformer.ln_f.bias")
    if config.tokenized and not config.tie_emb:
        take("lm_head.weight")
    return out


def from_hf_gpt2(model: Any) -> Tuple[TransformerConfig,
                                      Dict[str, torch.Tensor]]:
    """(TransformerConfig, state_dict) of a HuggingFace GPT2LMHeadModel, or
    of any object with its ``.config`` fields and ``.state_dict()``:
    tokenized, weight-tied, biased (the reference's ``from_pretrained``,
    networks.py:626-681)."""
    hf = model.config
    config = TransformerConfig(
        in_size=hf.vocab_size, block_size=hf.n_positions,
        n_layer=hf.n_layer, n_head=hf.n_head, n_embd=hf.n_embd, bias=True,
        tokenized=True, tie_emb=True)
    return config, state_dict_from_torch_transformer(model.state_dict(),
                                                     config, hf_layout=True)
