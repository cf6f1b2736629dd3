#!/usr/bin/env python3
"""Linear / MLP probe analysis, VAE latents -> L2 atmospheric products, on
one GPU; counterpart of tempo_tpu/cli/probe_analysis.py.

    python -m tempo_tpu_torch.cli.probe_analysis config.yaml [--overwrite] [--debug]

For each validation source granule: normalize and encode the whole granule
on the card and take the posterior-mean latent [H/4, W/4, Z]; normalize
each L2 product field (per-file stats), nanmean-pool it to the latent grid
and sample up to n_pixels_per_file valid pixels. Then, per product, an
80/20 train/test split, a linear or MLP probe (analysis/probes.py, on the
card), its R^2 and MSE; the same results/*.npz, JSON, models/*.npz and
figures as the JAX CLI (drawn by train/png.py where matplotlib is absent).
The model may be a base or an L2-supervised checkpoint (its ``vae.*``):
the port's ``.pt`` or the JAX package's ``.msgpack`` (train/checkpoint.py
``load_params``).
``probe_granule`` is the per-granule work on arrays; ``run(config_dict)``
reads the L1/L2 files (h5py or netCDF4).
"""

from __future__ import annotations

import json
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Union

import numpy as np
import torch

from tempo_tpu_torch.analysis.probes import r2_score, train_probe
from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.data.granule import (l2_filename_for, read_l2_field,
                                          read_radiance)
from tempo_tpu_torch.data.loader import load_normalization_stats
from tempo_tpu_torch.data.normalize import normalize_l2
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.infer.granule_codec import GranuleCodec
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.train.checkpoint import load_params
from tempo_tpu_torch.utils import figures as fig_kit
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_json_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def nanmean_pool(field: np.ndarray, factor: int) -> np.ndarray:
    """[H, W] -> [H/f, W/f] nanmean over f x f blocks (all-NaN block ->
    NaN)."""
    h, w = field.shape
    blocks = field.reshape(h // factor, factor, w // factor, factor)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", r"Mean of empty slice")
        warnings.filterwarnings("ignore", r"invalid value encountered")
        return np.nanmean(blocks, axis=(1, 3))


def probe_granule(codec: GranuleCodec, rad: np.ndarray,
                  fields: Mapping[str, Optional[np.ndarray]],
                  components: Mapping[str, Mapping[str, Any]], factor: int,
                  n_pixels: int, rng: np.random.Generator
                  ) -> Dict[str, Dict[str, Any]]:
    """One granule's probe data: for each component whose field (already
    read and scaled, [mirror, track]; None when missing) is present and has
    valid pooled pixels, {'latents' [n, Z], 'targets' [n], 'stats' (its
    normalize_l2 stats), 'raw' (the field's finite values in the crop)}.
    ``rng`` is drawn from in the JAX CLI's order."""
    gt = codec.normalize_tensor(rad)
    latent = codec.encode(gt).cpu().numpy()
    h_lat, w_lat, z_ch = latent.shape
    latent_flat = latent.reshape(-1, z_ch)
    out = {}
    for comp_name, comp_cfg in components.items():
        field = fields.get(comp_name)
        if field is None:
            continue
        if field.shape[0] < gt.shape[0] or field.shape[1] < gt.shape[1]:
            raise ValueError(f"{comp_name} field {field.shape} smaller than "
                             f"the L1 crop {tuple(gt.shape[:2])}")
        field = field[:gt.shape[0], :gt.shape[1]]
        normalized, stats = normalize_l2(field, comp_cfg["norm_type"])
        pooled = nanmean_pool(normalized, factor)
        if pooled.shape != (h_lat, w_lat):
            raise ValueError(f"pooled {comp_name} {pooled.shape} != the "
                             f"latent grid {(h_lat, w_lat)}")
        flat = pooled.flatten()
        valid = np.where(~np.isnan(flat))[0]
        if valid.size == 0:
            continue
        idx = rng.choice(valid, min(n_pixels, valid.size), replace=False)
        out[comp_name] = {"latents": latent_flat[idx], "targets": flat[idx],
                          "stats": stats, "raw": field[np.isfinite(field)]}
    return out


def save_data_stat_figures(stats_dir: Path, components, all_targets,
                           all_latents, raw_samples) -> None:
    """data_stats/: all_normalizations_comparison.png (raw over normalized,
    a column a component), input_latent_distributions.png and
    target_distributions.png."""
    comps = [c for c in components if all_targets.get(c)]
    if not comps:
        return
    fig, axes = fig_kit.new_grid(2, len(comps))
    for idx, comp in enumerate(comps):
        color = fig_kit.product_color(idx)
        cfg = components[comp]
        raw = raw_samples.get(comp)
        if raw is not None:
            fig_kit.hist_panel(axes[0, idx], raw, title=f"{comp} - Raw",
                               xlabel=f"Scale: {cfg.get('scale', 1.0)}",
                               color=color)
        else:
            axes[0, idx].axis("off")
        fig_kit.hist_panel(axes[1, idx], np.concatenate(all_targets[comp]),
                           title=f"{comp} - {cfg['norm_type']}",
                           xlabel="Normalized value", color=color,
                           stats_face="lightyellow")
    fig_kit.finish(fig, stats_dir / "all_normalizations_comparison.png",
                   suptitle="Component Fields: Raw vs Normalized "
                            "Distributions")

    latents = np.concatenate(all_latents[comps[0]], axis=0)
    z_ch = latents.shape[1]
    fig, axes = fig_kit.new_grid(1, 2, panel=(6, 5))
    show = sorted({0, z_ch // 4, z_ch // 2, 3 * z_ch // 4, z_ch - 1})
    fig_kit.overlay_hists(axes[0, 0], {f"Ch {ch}": latents[:, ch]
                                       for ch in show},
                          title="Input Latent Distributions (sample "
                                "channels)", xlabel="Latent Values")
    fig_kit.hist_panel(axes[0, 1], latents.ravel(),
                       title="All Input Latent Values",
                       xlabel="Latent Values (all channels)",
                       ylabel="Density", density=True, log_y=False,
                       show_stats=False)
    fig_kit.stats_box(axes[0, 1], latents.ravel(), face="wheat")
    fig_kit.finish(fig, stats_dir / "input_latent_distributions.png",
                   suptitle="Shared Input Latent Distributions "
                            "(for all regressions)")

    cols = 2 if len(comps) >= 3 else len(comps)
    rows = -(-len(comps) // cols)
    fig, axes = fig_kit.new_grid(rows, cols, panel=(6, 5))
    for idx, comp in enumerate(comps):
        ax = axes[idx // cols, idx % cols]
        y = np.concatenate(all_targets[comp])
        fig_kit.hist_panel(ax, y, bins=50, density=True, log_y=False,
                           title=f"{comp} Target Distribution",
                           xlabel="Normalized Values", ylabel="Density",
                           color=fig_kit.product_color(idx), show_stats=False)
        fig_kit.stats_box(ax, y, count=True)
    for idx in range(len(comps), rows * cols):
        axes[idx // cols, idx % cols].axis("off")
    fig_kit.finish(fig, stats_dir / "target_distributions.png",
                   suptitle="Normalized Target Distributions "
                            "(post-normalization)")


def save_probe_figure(figures_dir: Path, comp_name: str, probe, y_test,
                      y_pred, r2: float, n_show: int) -> None:
    """probe_<comp>.png: learning curves (log-log, best epoch marked) |
    truth against prediction | residual histogram."""
    epochs = np.arange(1, len(probe.train_losses) + 1)
    fig, axes = fig_kit.new_grid(1, 3, panel=(5, 5))
    fig_kit.curve_panel(axes[0, 0], epochs,
                        {"Train": probe.train_losses,
                         "Validation": probe.val_losses},
                        title=f"{comp_name} - Learning Curves",
                        xlabel="Epoch (log scale)", ylabel="MSE Loss",
                        log_x=True, log_y=True)
    fig_kit.vline(axes[0, 0], probe.best_epoch + 1,
                  f"Best @ {probe.best_epoch + 1}")
    fig_kit.scatter_panel(axes[0, 1], y_test[:n_show], y_pred[:n_show],
                          title=f"{comp_name} - R^2 = {r2:.4f}",
                          xlabel="Ground Truth", ylabel="Predicted")
    fig_kit.hist_panel(axes[0, 2], y_test - y_pred, bins=50, log_y=False,
                       title=f"{comp_name} - Residual Distribution",
                       xlabel="Residual (True - Predicted)",
                       show_stats=False)
    fig_kit.vline(axes[0, 2], 0)
    fig_kit.finish(fig, figures_dir / f"probe_{comp_name}.png")


def fit_probes(output_dir: Path, config: Dict[str, Any], all_latents,
               all_targets, seed: int, device: torch.device
               ) -> Dict[str, Dict[str, Any]]:
    """One probe a component with data: split, train, evaluate, and write
    models/probe_<c>.npz, results/{predictions,training_curves}_<c>.npz
    and figures/probe_<c>.png; returns the results by component."""
    results = {}
    test_split = config["probe"].get("test_split", 0.2)
    for comp_name in config["components"]:
        if not all_latents[comp_name]:
            print(f"Skipping {comp_name} - no valid data")
            continue
        print(f"\nTraining probe for {comp_name}...")
        X = np.concatenate(all_latents[comp_name], axis=0)
        y = np.concatenate(all_targets[comp_name])
        perm = np.random.default_rng(seed).permutation(len(X))
        n_test = int(len(X) * test_split)
        test_idx, train_idx = perm[:n_test], perm[n_test:]
        X_train, y_train = X[train_idx], y[train_idx]
        X_test, y_test = X[test_idx], y[test_idx]

        probe = train_probe(X_train, y_train, X_test, y_test,
                            config["probe"], seed=seed, verbose=True,
                            device=device)
        y_pred = probe.predict(X_test)
        r2 = r2_score(y_test, y_pred)
        mse = float(np.mean((y_test - y_pred) ** 2))
        results[comp_name] = {"r2_score": float(r2), "mse": mse,
                              "n_train": len(X_train), "n_test": len(X_test)}
        print(f"{comp_name}: R^2 = {r2:.4f}, MSE = {mse:.4f}")

        probe.save(output_dir / "models" / f"probe_{comp_name}.npz")
        np.savez(output_dir / "results" / f"predictions_{comp_name}.npz",
                 y_test=y_test, y_pred=y_pred, X_test=X_test)
        np.savez(output_dir / "results" / f"training_curves_{comp_name}.npz",
                 train_losses=np.asarray(probe.train_losses),
                 val_losses=np.asarray(probe.val_losses))
        n_show = min(config.get("visualization", {}).get("n_examples", 100),
                     len(y_test))
        save_probe_figure(output_dir / "figures", comp_name, probe, y_test,
                          y_pred, r2, n_show)
    return results


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Dict[str, Dict[str, Any]]:
    """The analysis as the config dict says, on ``device`` (None: CUDA,
    raising without it); returns the results by component."""
    require_keys(config, ["output_dir", "data", "model", "probe",
                          "components"])
    dev = resolve_device(device)
    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    if config_path is not None:
        copy_config(config_path, output_dir)
    else:
        save_json_yaml(config, output_dir / "config.yaml")
    for sub in ("figures", "results", "models", "data_stats"):
        (output_dir / sub).mkdir(parents=True, exist_ok=True)

    seed = config.get("seed", 42)
    rng = np.random.default_rng(seed)
    tiles_path = Path(config["data"]["tiles_path"])
    split_info = json.loads((tiles_path / "split_info.json").read_text())
    l1_nc_path = Path(config["data"]["l1_nc_path"]) / "raw"
    l2_base_path = Path(config["data"]["l2_base_path"])
    val_files = list(split_info["val_sources"].values())
    if debug:
        val_files = val_files[:3]
    mean_spectrum, std_spectrum = load_normalization_stats(tiles_path)

    train_config = load_config(config["model"]["training_config_path"])
    model, model_cfg = build_vae(train_config.get("model", {}), device=dev)
    load_params(config["model"]["checkpoint_path"], model)
    codec = GranuleCodec(model, mean_spectrum, std_spectrum,
                         multiple=model_cfg.input_size, seed=seed,
                         device=dev)

    components = config["components"]
    all_latents = {c: [] for c in components}
    all_targets = {c: [] for c in components}
    comp_norm_stats = {c: None for c in components}
    raw_samples = {c: None for c in components}
    print(f"Processing {len(val_files)} validation files...")
    for filename in val_files:
        l1_path = l1_nc_path / filename
        if not l1_path.exists():
            print(f"Warning: L1 file not found: {l1_path}")
            continue
        fields = {}
        for comp_name, comp_cfg in components.items():
            l2_path = (l2_base_path / config["data"]["l2_products"][comp_name]
                       / "raw" / l2_filename_for(l1_path.name, comp_name))
            if not l2_path.exists():
                print(f"Warning: L2 file not found: {l2_path}")
                continue
            fields[comp_name] = read_l2_field(
                l2_path, comp_cfg["field"], float(comp_cfg.get("scale", 1.0)))
        data = probe_granule(codec, read_radiance(l1_path), fields,
                             components, model_cfg.spatial_factor,
                             config["probe"]["n_pixels_per_file"], rng)
        for comp_name, d in data.items():
            all_latents[comp_name].append(d["latents"])
            all_targets[comp_name].append(d["targets"])
            if raw_samples[comp_name] is None:
                raw_samples[comp_name] = d["raw"]
            if comp_norm_stats[comp_name] is None and d["stats"] is not None:
                comp_norm_stats[comp_name] = {k: float(v)
                                              for k, v in d["stats"].items()}

    (output_dir / "results" / "component_norm_stats.json").write_text(
        json.dumps({k: v for k, v in comp_norm_stats.items() if v},
                   indent=2))
    save_data_stat_figures(output_dir / "data_stats", components,
                           all_targets, all_latents, raw_samples)

    results = fit_probes(output_dir, config, all_latents, all_targets, seed,
                         dev)
    (output_dir / "results" / "probe_results.json").write_text(
        json.dumps(results, indent=2))
    if results:
        fig, axes = fig_kit.new_grid(1, 1, panel=(10, 6))
        arch = config["probe"].get("architecture", "linear").title()
        fig_kit.annotated_bars(axes[0, 0], list(results),
                               [results[c]["r2_score"] for c in results],
                               title=f"{arch} Probe Performance",
                               ylabel="R^2 Score", ylim=(0, 1))
        fig_kit.finish(fig, output_dir / "figures" / "probe_summary.png")
    print(f"\nAnalysis complete! Results saved to {output_dir}")
    print(f"Component R^2 scores: {results}")
    return results


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Train probes from VAE latents to L2 products")
