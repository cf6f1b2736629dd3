#!/usr/bin/env python3
"""Full-granule reconstruction figures (PCA-RGB or one spectral channel) on
one GPU; counterpart of tempo_tpu/cli/analyze_reconstruction.py.

    python -m tempo_tpu_torch.cli.analyze_reconstruction config.yaml [--overwrite] [--debug]

For each validation source granule (the tile directory's split_info.json),
normalize on the card exactly as training, crop to /tile multiples, run one
whole-granule forward, and save <stem>_pca_rgb.png (3 PCA components, the
ground truth's 2%/98% quantiles scaling both panels) or <stem>_ch<c>.png.
The figures are drawn through utils/figures.py (train/png.py where
matplotlib is absent). ``reconstruction_figure`` draws one granule's
figure from arrays; ``run(config_dict)`` reads the files (h5py or
netCDF4). ``model.checkpoint_path``: the port's ``.pt`` or the JAX package's
``.msgpack`` (train/checkpoint.py ``load_params``).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.analysis.pca import PCAResult, pca_rgb
from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.granule import read_radiance
from tempo_tpu_torch.data.loader import load_normalization_stats
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.granule_codec import GranuleCodec
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.train.checkpoint import load_params
from tempo_tpu_torch.utils import figures as fig_kit
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def reconstruction_figure(output_dir: Path, stem: str, gt: np.ndarray,
                          recon: np.ndarray, mode: str = "single_channel",
                          pca: Optional[PCAResult] = None,
                          channel: int = 500) -> Path:
    """GT | reconstruction of one granule ([H, W, C] each), as PCA-RGB
    (``mode`` 'pca_rgb') or one spectral channel on the GT's range."""
    fig, axes = fig_kit.new_grid(1, 2, panel=(6, 5))
    if mode == "pca_rgb":
        fig_kit.image_panel(axes[0, 0], pca_rgb(gt, pca),
                            "Ground Truth (PCA RGB)")
        fig_kit.image_panel(axes[0, 1], pca_rgb(recon, pca, reference_hwc=gt),
                            "Reconstruction (PCA RGB)")
        title, suffix = f"{stem} - PCA Components as RGB", "_pca_rgb"
    else:
        ch = min(channel, gt.shape[-1] - 1)
        vmin, vmax = float(gt[..., ch].min()), float(gt[..., ch].max())
        for ax, img, name in ((axes[0, 0], gt, "Ground Truth"),
                              (axes[0, 1], recon, "Reconstruction")):
            fig_kit.image_panel(ax, img[..., ch], name, cmap="viridis",
                                vmin=vmin, vmax=vmax, colorbar=True)
        title, suffix = f"{stem} - Channel {ch}", f"_ch{ch}"
    return fig_kit.finish(fig, Path(output_dir) / f"{stem}{suffix}.png",
                          suptitle=title)


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> List[Path]:
    """The figures as the config dict says, on ``device`` (None: CUDA,
    raising without it); returns their paths."""
    require_keys(config, ["output_dir", "data", "model"])
    dev = resolve_device(device)
    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")

    tiles_path = Path(config["data"]["tiles_path"])
    split_info = json.loads((tiles_path / "split_info.json").read_text())
    val_nc_files = [Path(config["data"]["nc_path"]) / "raw" / f
                    for f in split_info["val_sources"].values()]
    if debug:
        val_nc_files = val_nc_files[:1]
    mean_spectrum, std_spectrum = load_normalization_stats(tiles_path)

    train_config = load_config(config["model"]["training_config_path"])
    model, model_cfg = build_vae(train_config.get("model", {}), device=dev)
    load_params(config["model"]["checkpoint_path"], model)
    codec = GranuleCodec(model, mean_spectrum, std_spectrum,
                         multiple=model_cfg.input_size,
                         seed=config.get("seed", 42), device=dev)

    viz = config.get("visualization", {})
    mode = viz.get("mode", "single_channel")
    pca = PCAResult.load(viz["pca_components_path"]) \
        if mode == "pca_rgb" else None
    paths = []
    for nc_file in val_nc_files:
        gt, recon = codec.reconstruct_raw(read_radiance(nc_file))
        paths.append(reconstruction_figure(
            output_dir, nc_file.stem, gt, recon, mode, pca,
            viz.get("single_channel", 500)))
        print(f"Saved {paths[-1]}")
    return paths


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Analyze VAE reconstructions on full granules")
