#!/usr/bin/env python3
"""Prepare ML-ready tile shards from TEMPO radiance granules, optionally
with matched L2 product tiles; counterpart of
tempo_tpu/cli/prepare_tiles.py (the L2 path activates when the config has
an 'l2' section).

    python -m tempo_tpu_torch.cli.prepare_tiles config.yaml [--overwrite] [--debug]

- Each granule is copied to the device once, normalized there (log /
  z-score / clip with the global stats, data/normalize.py's tensor path),
  cut into ``tiles_per_file`` random overlapping tiles with random
  flips/rot90 there (data/tiles.py, the same draws from the numpy
  Generator as the host path), and the tiles are copied back once.
- file-level train/val split with the reference's exact RNG stream
  (np.random.seed(seed); np.random.choice) so seed 42 reproduces the same
  granule split; the tile draws come from an unseeded
  np.random.default_rng(), as in the JAX CLI.
- L2 mode (host numpy, as the JAX CLI): per-product global stats from the
  first 20 granules (asinh-MAD / zscore / logit / minmax), identical
  windows + augmentations, fill values -> NaN, and fail-immediately error
  handling; plain mode logs and continues per file.

Output: train|val/NNNNN.npy [tiles, H, W, C] in ``processing.shard_dtype``
(+ l2_<P>/NNNNN.npy), manifest.yaml, split_info.json, l2_stats.json,
mean/std spectra. ``tile_granule`` is the per-granule work on an array
(numpy: the host path) or a tensor (its device); ``process_granule`` reads
a granule's files (h5py or netCDF4) and runs it on a device;
``run(config_dict)`` is the whole CLI from a dict.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.granule import (DEFAULT_BAND, l2_filename_for,
                                          read_l2_field, read_radiance)
from tempo_tpu_torch.data.normalize import normalize_l2, normalize_radiance
from tempo_tpu_torch.data.tiles import (extract_l2_tiles,
                                        extract_tiles_with_positions,
                                        save_tile_shard)
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml,
                                          save_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def _load_spectrum(path: Path) -> np.ndarray:
    if str(path).endswith(".pt"):
        return torch.load(path, weights_only=False).numpy().astype(np.float32)
    return np.load(path).astype(np.float32)


def _l2_granule_path(l2_config: Dict, component: str, l1_name: str) -> Path:
    product_name = l2_config["products"][component]
    l2_filename = l2_filename_for(l1_name, product_name)
    return (Path(l2_config["base_path"]) / l2_config["subdirs"][component]
            / "raw" / l2_filename)


def _load_l2_component(l2_config: Dict, component: str, l1_name: str
                       ) -> Optional[np.ndarray]:
    path = _l2_granule_path(l2_config, component, l1_name)
    if not path.exists():
        return None
    field = l2_config["fields"][component]
    scale = float(l2_config.get("scales", {}).get(component, 1.0))
    return read_l2_field(path, field, scale)


def tile_granule(rad: Union[np.ndarray, torch.Tensor],
                 l2_fields: Dict[str, np.ndarray], config: Dict,
                 mean_spectrum, std_spectrum, l2_stats: Dict,
                 rng: np.random.Generator) -> Optional[Dict[str, np.ndarray]]:
    """One granule's tiles: radiance [mirror, track, spectral] (a numpy
    array, or a tensor, normalized and cut on its device) and the L2
    components' fields (read, fills NaN, scaled; host numpy) -> {"spectral":
    [N, th, tw, C] float32, "l2_<P>": [N, th, tw]} as host arrays, or None
    when the granule is smaller than a tile."""
    params = config["processing"]
    n_mirror, n_track = rad.shape[:2]

    z_rad = normalize_radiance(
        rad, mean_spectrum, std_spectrum,
        min_radiance=params.get("min_radiance", 1.0),
        clip_min=params.get("clip_min", -10),
        clip_max=params.get("clip_max", 10),
    )

    l2_data = {}
    for component, field in l2_fields.items():
        if field.shape[0] < n_mirror or field.shape[1] < n_track:
            raise ValueError(
                f"FATAL: {component} dimensions too small: "
                f"{field.shape} < L1 {n_mirror}x{n_track}")
        field = field[:n_mirror, :n_track]
        norm_type = config["l2"].get("norm_types", {}).get(component,
                                                           "zscore")
        normalized, _ = normalize_l2(field, norm_type,
                                     l2_stats.get(component))
        l2_data[component] = normalized

    tiles, positions = extract_tiles_with_positions(
        z_rad, params["tile_size"], params["tiles_per_file"], rng)
    if tiles is None:
        return None

    if isinstance(tiles, torch.Tensor):
        tiles = tiles.cpu().numpy()
    result = {"spectral": tiles}
    for component, field in l2_data.items():
        result[f"l2_{component}"] = extract_l2_tiles(field, positions,
                                                     params["tile_size"])
    return result


def process_granule(nc_path: Path, config: Dict, mean_spectrum, std_spectrum,
                    l2_stats: Dict, rng: np.random.Generator,
                    device: Union[str, torch.device, None] = None):
    """Read one granule's radiance and L2 fields, and tile it on ``device``
    (None: CUDA): one copy of the radiance in, one of the tiles out."""
    params = config["processing"]
    rad = read_radiance(nc_path, params.get("band", DEFAULT_BAND))
    l2_fields = {}
    if "l2" in config:
        l2_config = config["l2"]
        for component in l2_config["components"]:
            field = _load_l2_component(l2_config, component, nc_path.name)
            if field is None:
                raise ValueError(
                    f"FATAL: Failed to load L2 component {component} for "
                    f"{nc_path.name}\nExpected L2 file: "
                    f"{_l2_granule_path(l2_config, component, nc_path.name)}"
                    "\nNO SILENT FAILURES - FAIL IMMEDIATELY!")
            l2_fields[component] = field
    rad_dev = torch.from_numpy(rad).to(resolve_device(device))
    return tile_granule(rad_dev, l2_fields, config, mean_spectrum,
                        std_spectrum, l2_stats, rng)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Path:
    """Prepare the tiles as the config dict says, on ``device`` (None:
    CUDA, raising without it); returns the output directory."""
    require_keys(config, ["output_dir", "input_dir", "processing"])
    dev = resolve_device(device)

    input_dir = Path(config["input_dir"])
    if not input_dir.exists():
        raise ValueError(f"FATAL: input_dir doesn't exist: {input_dir}")

    with_l2 = "l2" in config
    l2_components = (config.get("l2", {}).get("components", [])
                     if with_l2 else [])

    # Global spectral normalization
    mean_spectrum = std_spectrum = None
    norm_config = config.get("normalization", {})
    if "mean_file" in norm_config and "std_file" in norm_config:
        mean_path = Path(norm_config["mean_file"])
        std_path = Path(norm_config["std_file"])
        if not with_l2:
            if not mean_path.exists():
                raise ValueError(f"FATAL: mean_file doesn't exist: {mean_path}")
            if not std_path.exists():
                raise ValueError(f"FATAL: std_file doesn't exist: {std_path}")
        if mean_path.exists() and std_path.exists():
            mean_spectrum = _load_spectrum(mean_path)
            std_spectrum = _load_spectrum(std_path)
            print("Loaded global normalization from files")
    elif "mean_spectrum" in norm_config and "std_spectrum" in norm_config:
        mean_spectrum = np.asarray(norm_config["mean_spectrum"], np.float32)
        std_spectrum = np.asarray(norm_config["std_spectrum"], np.float32)
        print("Using global normalization from config")

    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    nc_files = sorted(input_dir.glob("**/*.nc"))
    if not nc_files:
        raise ValueError(f"No .nc files found in {input_dir}")
    if debug:
        nc_files = nc_files[:3]
        print(f"DEBUG: Processing only {len(nc_files)} files")
    print(f"Processing {len(nc_files)} TEMPO files")

    # Train/val split — exact reference RNG stream for split parity.
    split_config = config.get("split", {})
    val_fraction = split_config.get("val_fraction", 0.2)
    seed = split_config.get("seed", 42)
    np.random.seed(seed)
    n_val = int(len(nc_files) * val_fraction)
    val_indices = set(np.random.choice(len(nc_files), n_val, replace=False))

    train_dir = output_dir / "train"
    val_dir = output_dir / "val"
    train_dir.mkdir(exist_ok=True)
    val_dir.mkdir(exist_ok=True)
    for component in l2_components:
        (train_dir / f"l2_{component}").mkdir(exist_ok=True)
        (val_dir / f"l2_{component}").mkdir(exist_ok=True)

    # Global L2 stats from the first 20 granules
    l2_stats: Dict[str, Dict] = {}
    if with_l2 and config["l2"].get("compute_global_stats", False):
        print("Computing global L2 statistics...")
        for component in l2_components:
            values = []
            for nc_path in nc_files[:20]:
                field = _load_l2_component(config["l2"], component,
                                           nc_path.name)
                if field is not None:
                    valid = field[~np.isnan(field)]
                    if valid.size:
                        values.append(valid)
            if values:
                all_values = np.concatenate(values)
                norm_type = config["l2"].get("norm_types", {}).get(
                    component, "zscore")
                _, stats = normalize_l2(all_values, norm_type)
                l2_stats[component] = stats
                print(f"  {component}: {stats}")

    tile_rng = np.random.default_rng()  # aug randomness (random each run,
    # like the reference's seed=None extract_tiles)

    train_count = val_count = 0
    failed = []
    train_sources: Dict[str, str] = {}
    val_sources: Dict[str, str] = {}
    l2_availability = {c: {"train": 0, "val": 0} for c in l2_components}

    for i, nc_path in enumerate(nc_files):
        try:
            result = process_granule(nc_path, config, mean_spectrum,
                                     std_spectrum, l2_stats, tile_rng, dev)
        except Exception as e:
            if with_l2:
                raise  # fail-immediately contract of the L2 path
            print(f"  Failed: {nc_path.name} - {e}")
            failed.append(str(nc_path))
            continue

        if result is None:
            if with_l2:
                raise ValueError(
                    f"FATAL: Failed to process {nc_path} - no spectral data")
            failed.append(str(nc_path))
            continue

        if i in val_indices:
            tile_filename = f"{val_count:05d}.npy"
            save_dir, sources, split_name = val_dir, val_sources, "val"
            val_count += 1
        else:
            tile_filename = f"{train_count:05d}.npy"
            save_dir, sources, split_name = train_dir, train_sources, "train"
            train_count += 1

        shard_dtype = np.dtype(config["processing"].get("shard_dtype",
                                                        "float32"))
        save_tile_shard(save_dir / tile_filename, result["spectral"],
                        dtype=shard_dtype)
        sources[tile_filename] = str(nc_path.relative_to(input_dir))
        for component in l2_components:
            save_tile_shard(save_dir / f"l2_{component}" / tile_filename,
                            result[f"l2_{component}"], dtype=shard_dtype)
            l2_availability[component][split_name] += 1
        print(f"[{i + 1}/{len(nc_files)}] {nc_path.name} -> "
              f"{split_name}/{tile_filename}")

    if mean_spectrum is not None:
        np.save(output_dir / "mean_spectrum.npy", mean_spectrum)
        np.save(output_dir / "std_spectrum.npy", std_spectrum)
        print("Saved normalization stats to output directory")
    if l2_stats:
        with open(output_dir / "l2_stats.json", "w") as f:
            json.dump(l2_stats, f, indent=2)
        print("Saved L2 normalization stats")

    n_spectral = config["processing"].get("n_spectral", 1028)
    manifest = {
        "input_files": len(nc_files),
        "train_files": train_count,
        "val_files": val_count,
        "failed": failed,
        "tile_shape": list(config["processing"]["tile_size"]) + [n_spectral],
        "tiles_per_file": config["processing"]["tiles_per_file"],
        "global_normalization": mean_spectrum is not None,
    }
    if with_l2:
        manifest["l2_components"] = l2_components
        manifest["l2_availability"] = l2_availability
    save_yaml(manifest, output_dir / "manifest.yaml")

    split_info = {
        "train_sources": train_sources,
        "val_sources": val_sources,
        "failed_files": failed,
        "split_config": {
            "val_fraction": val_fraction,
            "seed": seed,
            "n_train": train_count,
            "n_val": val_count,
            "n_failed": len(failed),
        },
    }
    if with_l2:
        split_info["l2_availability"] = l2_availability
    with open(output_dir / "split_info.json", "w") as f:
        json.dump(split_info, f, indent=2)

    print(f"\nDone:\n  Train: {train_count} files\n  Val: {val_count} files"
          f"\n  Failed: {len(failed)} files")

    if with_l2:
        total_l2 = sum(v["train"] + v["val"] for v in l2_availability.values())
        for comp, avail in l2_availability.items():
            print(f"  {comp}: train={avail['train']}, val={avail['val']}")
        if total_l2 == 0:
            raise ValueError(
                "FATAL: No L2 data was found for ANY component! Check L2 "
                "paths in config.")
    return output_dir


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Prepare TEMPO tile shards (optionally with L2 products)")
