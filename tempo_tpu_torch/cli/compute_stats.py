#!/usr/bin/env python3
"""Compute global per-channel mean/std of log radiance for normalization;
counterpart of tempo_tpu/cli/compute_stats.py.

    python -m tempo_tpu_torch.cli.compute_stats config.yaml [--overwrite] [--debug]

Statistics accumulate as per-channel (count, sum, sumsq) in float64 on the
device, one granule at a time (one copy of each granule in), so memory
stays flat; population std (ddof=0), as the JAX CLI. ``log_radiance_sums``
is the per-granule work on a tensor; ``run(config_dict)`` reads the files
(h5py or netCDF4).

Outputs: tempo_mean_spectrum.npy/.txt, tempo_std_spectrum.npy/.txt,
manifest.yaml (+ mean_spectrum.npy/std_spectrum.npy aliases that the tile
prep and loaders accept). Config keys: output_dir, input_dir, max_files
(10; 3 at most with --debug), band, min_radiance (1.0).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.granule import DEFAULT_BAND, read_radiance
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml,
                                          save_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def log_radiance_sums(rad: torch.Tensor, min_radiance: float = 1.0
                      ) -> Tuple[int, torch.Tensor, torch.Tensor]:
    """rad [..., C] -> (pixels, per-channel sum, per-channel sum of
    squares) of log(clamp(rad, min_radiance)), the log in rad's type as the
    JAX CLI takes it, the sums in float64 on rad's device."""
    log_rad = torch.clamp(rad, min=min_radiance).log_().double()
    flat = log_rad.reshape(-1, log_rad.shape[-1])
    return flat.shape[0], flat.sum(0), flat.square().sum(0)


def spectra(count: int, total: np.ndarray, total_sq: np.ndarray
            ) -> Tuple[np.ndarray, np.ndarray]:
    """float32 (mean, population std) from float64 (count, sum, sumsq)."""
    mean_spectrum = (total / count).astype(np.float32)
    var = total_sq / count - (total / count) ** 2
    return mean_spectrum, np.sqrt(np.clip(var, 0, None)).astype(np.float32)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Path:
    """Compute the statistics as the config dict says, on ``device``
    (None: CUDA, raising without it); returns the output directory."""
    require_keys(config, ["output_dir", "input_dir"])
    dev = resolve_device(device)

    input_dir = Path(config["input_dir"])
    if not input_dir.exists():
        raise ValueError(f"FATAL: input_dir doesn't exist: {input_dir}")

    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    nc_files = sorted(input_dir.glob("**/*.nc"))
    if not nc_files:
        raise ValueError(f"No .nc files found in {input_dir}")

    max_files = config.get("max_files", 10)
    if debug:
        max_files = min(3, max_files)
    n_files = min(max_files, len(nc_files))
    print(f"Computing statistics from {n_files} files (of {len(nc_files)} "
          f"total)")

    band = config.get("band", DEFAULT_BAND)
    min_radiance = config.get("min_radiance", 1.0)

    count = 0
    total = total_sq = None
    for nc_path in nc_files[:n_files]:
        try:
            rad = read_radiance(nc_path, band)
        except (OSError, KeyError) as e:
            print(f"  Error with {nc_path.name}: {e}")
            continue
        n, s, sq = log_radiance_sums(torch.from_numpy(rad).to(dev),
                                     min_radiance)
        if total is None:
            total, total_sq = s, sq
        else:
            total += s
            total_sq += sq
        count += n

    if count == 0:
        raise ValueError("FATAL: No files could be loaded")

    mean_spectrum, std_spectrum = spectra(count, total.cpu().numpy(),
                                          total_sq.cpu().numpy())

    print(f"Total pixels: {count:,}")
    print(f"  Mean range: [{mean_spectrum.min():.3f}, "
          f"{mean_spectrum.max():.3f}]")
    print(f"  Std range: [{std_spectrum.min():.3f}, {std_spectrum.max():.3f}]")

    for name, arr in [("tempo_mean_spectrum", mean_spectrum),
                      ("tempo_std_spectrum", std_spectrum)]:
        np.save(output_dir / f"{name}.npy", arr)
        np.savetxt(output_dir / f"{name}.txt", arr)
    # aliases matching the tiles-directory naming the loaders accept
    np.save(output_dir / "mean_spectrum.npy", mean_spectrum)
    np.save(output_dir / "std_spectrum.npy", std_spectrum)

    save_yaml({
        "n_files_used": n_files,
        "total_pixels": int(count),
        "band": band,
        "min_radiance": min_radiance,
        "mean_range": [float(mean_spectrum.min()), float(mean_spectrum.max())],
        "std_range": [float(std_spectrum.min()), float(std_spectrum.max())],
    }, output_dir / "manifest.yaml")
    print("Done!")
    return output_dir


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Compute TEMPO normalization statistics")
