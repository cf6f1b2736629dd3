#!/usr/bin/env python3
"""Extract PCA components from normalized TEMPO spectra; counterpart of
tempo_tpu/cli/extract_pca.py.

    python -m tempo_tpu_torch.cli.extract_pca config.yaml [--overwrite] [--debug]

Sample ``sampling.pixels_per_file`` random normalized pixels from up to
``sampling.max_files`` granules (one ``np.random.default_rng(seed)`` drawn
as the JAX CLI draws it), fit ``pca.n_components`` components, and write
pca_components.npz, sample_projections.npy and summary.yaml (as JSON). Each
granule is normalized on ``device`` (None: CUDA); only the sampled pixels
come back. Reading granules needs h5py (or netCDF4). ``run(config_dict)``
is the same run from a dict.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.analysis.pca import PCAResult, fit_pca
from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.granule import DEFAULT_BAND, read_radiance
from tempo_tpu_torch.data.normalize import normalize_radiance
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def sample_pixels(z, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` distinct random pixels [n, C] of a normalized [..., C] granule
    (numpy or a tensor), drawn as the JAX CLI draws them."""
    flat = z.reshape(-1, z.shape[-1])
    idx = rng.choice(flat.shape[0], min(n, flat.shape[0]), replace=False)
    if isinstance(flat, torch.Tensor):
        return flat[torch.as_tensor(idx, device=flat.device)].cpu().numpy()
    return flat[idx]


def _load_spectrum(p: Path) -> np.ndarray:
    if p.suffix == ".pt":
        return torch.load(p, weights_only=True).numpy()
    return np.load(p)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> PCAResult:
    """The extraction as the config dict says; returns the fit."""
    require_keys(config, ["output_dir", "input_dir", "normalization",
                          "sampling", "pca"])
    dev = resolve_device(device)
    input_dir = Path(config["input_dir"])
    if not input_dir.exists():
        raise ValueError(f"FATAL: input_dir doesn't exist: {input_dir}")
    norm_cfg = config["normalization"]
    mean_path, std_path = Path(norm_cfg["mean_file"]), Path(norm_cfg["std_file"])
    for p in (mean_path, std_path):
        if not p.exists():
            raise ValueError(f"FATAL: stats file doesn't exist: {p}")

    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    mean_spectrum = _load_spectrum(mean_path).astype(np.float32)
    std_spectrum = _load_spectrum(std_path).astype(np.float32)
    params = config.get("processing", {})
    sampling = config["sampling"]
    rng = np.random.default_rng(sampling.get("seed", 42))

    nc_files = (sorted(input_dir.glob("*.nc"))
                or sorted(input_dir.glob("**/*.nc")))
    if not nc_files:
        raise ValueError(f"No .nc files found in {input_dir}")
    max_files = sampling["max_files"]
    if debug:
        max_files = min(3, max_files)
    nc_files = nc_files[:max_files]
    print(f"Processing {len(nc_files)} files, "
          f"{sampling['pixels_per_file']} pixels each")

    all_samples = []
    for nc_path in nc_files:
        try:
            rad = read_radiance(nc_path, params.get("band", DEFAULT_BAND))
        except (OSError, KeyError) as e:
            print(f"Error processing {nc_path}: {e}")
            continue
        with torch.inference_mode():
            z = normalize_radiance(
                torch.from_numpy(rad).to(dev), mean_spectrum, std_spectrum,
                min_radiance=params.get("min_radiance", 1.0),
                clip_min=params.get("clip_min", -10),
                clip_max=params.get("clip_max", 10))
            all_samples.append(sample_pixels(z, sampling["pixels_per_file"],
                                             rng))
    X = np.concatenate(all_samples, axis=0)
    print(f"Collected samples shape: {X.shape}")

    n_components = config["pca"]["n_components"]
    pca = fit_pca(X, n_components)
    print(f"Explained variance ratio: {pca.explained_variance_ratio}")
    print(f"Total variance explained: "
          f"{pca.explained_variance_ratio.sum():.4f}")
    pca.save(output_dir / "pca_components.npz")
    np.save(output_dir / "sample_projections.npy", pca.transform(X))
    save_json_yaml({
        "n_files_processed": len(nc_files),
        "pixels_per_file": sampling["pixels_per_file"],
        "total_samples": int(X.shape[0]),
        "n_spectral_channels": int(X.shape[1]),
        "n_components": n_components,
        "explained_variance_ratio": pca.explained_variance_ratio.tolist(),
        "total_variance_explained": float(pca.explained_variance_ratio.sum()),
    }, output_dir / "summary.yaml")
    print("Done!")
    return pca


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Extract PCA components from TEMPO spectra")
