"""Ahead-of-time export of the trained codec for serving; counterpart of
tempo_tpu/infer/export_codec.py.

``export_codec`` traces the encode (to the posterior mean) and the decode
of an ``AutoencoderKL`` with ``torch.export`` and writes them as programs
with the weights inside, so a serving host runs them with no model code,
config or checkpoint loader: ``load_exported`` imports only the
registrations of the ``tempo::`` kernel ops (ops/cuda_gn.py,
ops/cuda_gn_conv.py). The batch is one symbolic dimension, so one artifact
serves any batch; H and W are static, as in the JAX package.

Artifacts (one directory):
  encode.pt2   [b, H, W, C_spectral] fp32 -> [b, H/4, W/4, embed] (mean)
  decode.pt2   [b, H/4, W/4, embed] fp32  -> [b, H, W, C_spectral]
  meta.json    the JAX package's keys; ``"format": "torch.export"`` and
               ``"devices"`` in place of ``"platforms"``

One artifact serves both devices, as JAX's cross-platform lowering does:
GroupNorm, K2's GroupNorm + conv and their statistics are the ops
``tempo::gn_stats``, ``tempo::gn_apply`` and ``tempo::gn_conv3x3`` in the
program, whose CPU kernels are the plain versions and whose CUDA kernels
are the hand-written ones, whichever device ran the export. Each 3x3
conv that a K2 call reads has its weight in the program twice: fp32 as
trained (the CPU kernel's), and in K2's packed layout in the compute type
(the CUDA kernel's), packed once at export (nn/blocks.py
``packed_for_export``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Tuple, Union

import torch
from torch import nn

# The op registrations a loaded program needs; no model code.
from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv  # noqa: F401

DEVICES = ("cpu", "cuda")


class _Encode(nn.Module):
    """x -> the posterior mean (AutoencoderKL.encode(x).mean), holding the
    encoder and the quant conv only."""

    def __init__(self, model):
        super().__init__()
        self.encoder, self.quant_conv = model.encoder, model.quant_conv

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        from tempo_tpu_torch.nn.distributions import DiagonalGaussian

        return DiagonalGaussian.from_params(
            self.quant_conv(self.encoder(x, True))).mean


class _Decode(nn.Module):
    """z -> AutoencoderKL.decode(z), holding the post-quant conv and the
    decoder only."""

    def __init__(self, model):
        super().__init__()
        self.post_quant_conv, self.decoder = (model.post_quant_conv,
                                              model.decoder)
        self.dtype = model.config.dtype

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.dtype)), True)


def export_codec(model, out_dir: Union[str, Path],
                 tile_hw: Tuple[int, int] = (64, 64)) -> Path:
    """Write the encode/decode programs of ``model`` (an AutoencoderKL,
    whose weights and config stand in for JAX's params and config), traced
    on the model's device, and meta.json."""
    from tempo_tpu_torch.nn.blocks import packed_for_export

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    config = model.config
    h, w = tile_hw
    c = config.in_channels
    f = config.spatial_factor
    zc = config.embed_dim
    dev = next(model.parameters()).device
    batch = torch.export.Dim("b", min=1)
    with torch.no_grad(), packed_for_export(model):
        for name, module, shape in (
                ("encode", _Encode(model), (2, h, w, c)),
                ("decode", _Decode(model), (2, h // f, w // f, zc))):
            program = torch.export.export(
                module.eval(), (torch.zeros(shape, device=dev),),
                dynamic_shapes=({0: batch},), strict=False)
            torch.export.save(program, out_dir / f"{name}.pt2")
    (out_dir / "meta.json").write_text(json.dumps({
        "spectral_channels": c,
        "tile_hw": [h, w],
        "latent_hw": [h // f, w // f],
        "embed_dim": zc,
        "downsample_factor": f,
        "compute_dtype": config.compute_dtype,
        "format": "torch.export",
        "devices": list(DEVICES),
    }, indent=2))
    return out_dir


def load_exported(out_dir: Union[str, Path],
                  device: Union[str, torch.device, None] = None):
    """Returns (encode_fn, decode_fn, meta) from the artifacts, on
    ``device`` (None: CUDA, raising without it): callable with any batch,
    no model code needed. The functions run under torch.inference_mode(),
    as GranuleCodec does."""
    from torch.export.passes import move_to_device_pass

    from tempo_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    out_dir = Path(out_dir)
    meta = json.loads((out_dir / "meta.json").read_text())

    def load(name: str):
        program = torch.export.load(out_dir / f"{name}.pt2")
        module = move_to_device_pass(program, dev).module()

        def run(x: torch.Tensor) -> torch.Tensor:
            with torch.inference_mode():
                return module(x)

        return run

    return load("encode"), load("decode"), meta
