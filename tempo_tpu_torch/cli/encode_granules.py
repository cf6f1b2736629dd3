#!/usr/bin/env python3
"""Full-granule latent encode/decode sweep; counterpart of
tempo_tpu/cli/encode_granules.py.

    python -m tempo_tpu_torch.cli.encode_granules config.yaml [--overwrite] [--debug]
    torchrun --nproc-per-node=N -m tempo_tpu_torch.cli.encode_granules config.yaml

For every granule of ``input_dir`` (or the ``nc_files`` list): normalize on
the card exactly as training, run one whole-granule encoder forward, and
write the posterior-mean latent [H/4, W/4, Z] to latents/<stem>.npz
(``latent``, ``shape``: the JAX CLI's keys and dtypes); with
``decode_roundtrip``, decode it back and record MSE / MAE / PSNR, reduced
on the card in float64. encode_summary.json as the JAX CLI writes it.
Config keys: output_dir, input_dir or nc_files, data.tiles_path (the
normalization stats; the granule's own without it),
model.{checkpoint_path, training_config_path}, decode_roundtrip,
max_files, seed, shape_bucket, spatial_sharding, distributed.
``encode_granule`` is the per-granule work on an array; ``run(config_dict)``
reads the files (h5py or netCDF4).
``model.checkpoint_path``: the port's ``.pt`` or the JAX package's
``.msgpack`` (train/checkpoint.py ``load_params``).

``spatial_sharding: true`` over more than one process (torchrun, or the
``distributed:`` section, parallel/mesh.py) splits every whole-granule
forward along the track axis over the ranks (parallel/spatial.py), as the
JAX CLI splits it over its chips; each rank holds its W share on its
device, and rank 0 alone writes the output directory, with the whole
latent of each granule. Over one process it runs unsharded, as JAX does
on one chip.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.granule import read_radiance
from tempo_tpu_torch.data.loader import load_normalization_stats
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.granule_codec import GranuleCodec
from tempo_tpu_torch.infer.sweep import compute_metrics
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.parallel.mesh import (barrier, is_primary,
                                           process_count, process_group)
from tempo_tpu_torch.train.checkpoint import load_params
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def encode_granule(codec: GranuleCodec, rad: np.ndarray,
                   decode_roundtrip: bool = False
                   ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """Raw radiance [mirror, track, spectral] -> (the whole posterior-mean
    latent as a host array, its summary entry: input and latent shapes,
    encode_seconds and, with ``decode_roundtrip``, decode_seconds and the
    reconstruction's mse, mae and psnr). A codec with a mesh holds each
    rank's W share on its device and gives every rank the whole latent and
    the same metrics."""
    gt = codec.normalize_tensor(rad)
    _sync(codec.device)
    t0 = time.perf_counter()
    latent = codec.encode(gt)
    latent_host = codec.to_host(latent)
    entry = {"input_shape": [gt.shape[0], codec.whole_width(gt),
                             gt.shape[2]],
             "latent_shape": list(latent_host.shape),
             "encode_seconds": time.perf_counter() - t0}
    if decode_roundtrip:
        t0 = time.perf_counter()
        recon = codec.decode_tensor(latent)
        _sync(codec.device)
        entry["decode_seconds"] = time.perf_counter() - t0
        with torch.inference_mode():
            entry.update(compute_metrics(gt, recon, ["mse", "mae", "psnr"],
                                         codec.sharding))
    return latent_host, entry


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Dict[str, Any]:
    """The sweep as the config dict says, on ``device`` (None: CUDA,
    raising without it; ``cuda:LOCAL_RANK`` under torchrun); returns the
    summary (on every rank)."""
    require_keys(config, ["output_dir", "model"])
    with process_group(config, device) as mesh:
        if not (config.get("spatial_sharding", False)
                and process_count() > 1):
            mesh = None
        return _run(config, overwrite, debug, device, config_path, mesh)


def _run(config, overwrite, debug, device, config_path, mesh):
    dev = resolve_device(device)
    primary = is_primary()
    if "nc_files" in config:
        nc_files = [Path(f) for f in config["nc_files"]]
    else:
        require_keys(config, ["input_dir"])
        nc_files = sorted(Path(config["input_dir"]).glob("**/*.nc"))
    if not nc_files:
        raise ValueError("FATAL: no granules to encode")
    max_files = 2 if debug else config.get("max_files")
    if max_files:
        nc_files = nc_files[:max_files]

    output_dir = Path(config["output_dir"])
    if primary:
        output_dir = init_directory(output_dir, overwrite=overwrite)
        if config_path is not None:
            copy_config(config_path, output_dir)
        else:
            save_json_yaml(config, output_dir / "config.yaml")
        (output_dir / "latents").mkdir(exist_ok=True)
    barrier()
    latents_dir = output_dir / "latents"

    mean_spectrum = std_spectrum = None
    if "tiles_path" in config.get("data", {}):
        mean_spectrum, std_spectrum = load_normalization_stats(
            Path(config["data"]["tiles_path"]))
    train_config = load_config(config["model"]["training_config_path"])
    model, model_cfg = build_vae(train_config.get("model", {}), device=dev)
    load_params(config["model"]["checkpoint_path"], model)
    if mesh is not None and primary:
        print(f"Spatially sharding granules over {process_count()} "
              f"processes")
    codec = GranuleCodec(model, mean_spectrum, std_spectrum,
                         multiple=model_cfg.input_size,
                         seed=config.get("seed", 42),
                         shape_bucket=int(config.get("shape_bucket", 1)),
                         device=dev, mesh=mesh)

    decode_roundtrip = bool(config.get("decode_roundtrip", False))
    results = []
    total_pixels = 0
    t_start = time.perf_counter()
    for nc_file in nc_files:
        latent, entry = encode_granule(codec, read_radiance(nc_file),
                                       decode_roundtrip)
        h, w, _ = entry["input_shape"]
        total_pixels += h * w
        results.append({"granule": nc_file.name, **entry})
        if primary:
            np.savez(latents_dir / f"{nc_file.stem}.npz", latent=latent,
                     shape=np.asarray(entry["input_shape"]))
            print(f"{nc_file.name}: latent {latent.shape} "
                  f"({entry['encode_seconds']:.2f}s)")

    elapsed = time.perf_counter() - t_start
    summary = {
        "n_granules": len(results),
        "total_pixels": int(total_pixels),
        "elapsed_seconds": elapsed,
        "pixels_per_second": total_pixels / max(elapsed, 1e-9),
        "granules": results,
    }
    if primary:
        (output_dir / "encode_summary.json").write_text(
            json.dumps(summary, indent=2))
        print(f"\nEncoded {len(results)} granules in {elapsed:.1f}s "
              f"({summary['pixels_per_second']:.0f} px/s)")
    return summary


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Encode granules to latents (full-granule inference sweep)")
