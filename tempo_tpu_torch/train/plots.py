"""Live training curves and reconstruction figures; counterpart of
tempo_tpu/train/plots.py ``update_summary_plots``,
``plot_per_product_losses`` and ``save_reconstruction_figure``.

summary/{loss,recons_err,kl}.png, one per metric the history carries,
log-log from step 100 on, with the validation loss as markers on the loss
curve; summary/l2_losses.png, the L2 variant's per-product losses;
figures/reconstructions_step_NNNNNN.png, one row per shown sample, with an
L2 product's target and prediction where given. matplotlib is imported
inside the functions, so the package imports where it is absent; where it
is absent, the same files are drawn without text by train/png.py.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from tempo_tpu_torch.train import png
from tempo_tpu_torch.utils.figures import pyplot

LOG_SCALE_FROM = 100  # steps >= this switch the summary curves to log-log

# the three summary artifacts: filename -> (metric key, title, ylabel)
SUMMARY_SERIES = {
    "loss.png": ("loss", "Total Loss", "Loss"),
    "recons_err.png": ("pixel_mse", "Pixel MSE (Reconstruction Error)",
                       "Mean Squared Error"),
    "kl.png": ("kl_loss", "KL Divergence", "KL Loss"),
}


def _history_view(history: List[Dict], key: str, log_scale: bool):
    """(steps, values) of one metric, inside the log-scale window when on;
    entries without the metric are skipped."""
    pairs = [(m["step"], m[key]) for m in history if key in m
             and (not log_scale or m["step"] >= LOG_SCALE_FROM)]
    return [p[0] for p in pairs], [p[1] for p in pairs]


def update_summary_plots(summary_dir: Union[str, Path],
                         train_history: List[Dict],
                         val_history: List[Dict]) -> None:
    if len(train_history) < 2:
        return
    plt = pyplot()
    summary_dir = Path(summary_dir)
    summary_dir.mkdir(parents=True, exist_ok=True)
    log_scale = sum(m["step"] >= LOG_SCALE_FROM for m in train_history) >= 2
    suffix = " (log-log scale)" if log_scale else ""
    for filename, (key, title, ylabel) in SUMMARY_SERIES.items():
        steps, values = _history_view(train_history, key, log_scale)
        if not steps:
            continue
        vs, vv = (_history_view(val_history, "val_loss", log_scale)
                  if key == "loss" else ([], []))
        if plt is None:
            png.write_png(summary_dir / filename, png.curves(
                {"Train": (steps, values), "Val": (vs, vv)}, log_scale))
            continue
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.plot(steps, values, alpha=0.8, label="Train")
        if key == "loss":
            if vs:
                ax.plot(vs, vv, "^", color="tab:red", markersize=8,
                        label="Val")
                ax.legend()
        if log_scale:
            ax.set_xscale("log")
            ax.set_yscale("log")
            ax.set_xlim(left=LOG_SCALE_FROM)
        ax.set_title(title + suffix)
        ax.set_xlabel("Step")
        ax.set_ylabel(ylabel)
        ax.grid(True, alpha=0.3, which="both" if log_scale else "major")
        fig.tight_layout()
        fig.savefig(summary_dir / filename, dpi=100, bbox_inches="tight")
        plt.close(fig)


def plot_per_product_losses(summary_dir: Union[str, Path],
                            train_history: List[Dict],
                            products: Sequence[str]) -> None:
    """summary/l2_losses.png: each product's masked MSE against the step,
    log-log from step 100 on."""
    if len(train_history) < 2:
        return
    log_scale = sum(m["step"] >= LOG_SCALE_FROM for m in train_history) >= 2
    series = {p: _history_view(train_history, f"{p}_loss", log_scale)
              for p in products}
    if not any(steps for steps, _ in series.values()):
        return
    Path(summary_dir).mkdir(parents=True, exist_ok=True)
    plt = pyplot()
    if plt is None:
        png.write_png(Path(summary_dir) / "l2_losses.png",
                      png.curves(series, log_scale))
        return
    fig, ax = plt.subplots(figsize=(10, 6))
    for product, (steps, values) in series.items():
        ax.plot(steps, values, alpha=0.8, label=product)
    if log_scale:
        ax.set_xscale("log")
        ax.set_yscale("log")
    ax.set_title("L2 Product Losses" + (" (log-log)" if log_scale else ""))
    ax.set_xlabel("Step")
    ax.set_ylabel("Masked MSE")
    ax.legend()
    ax.grid(True, alpha=0.3, which="both" if log_scale else "major")
    fig.tight_layout()
    fig.savefig(Path(summary_dir) / "l2_losses.png", dpi=100,
                bbox_inches="tight")
    plt.close(fig)


def _finite_range(a: np.ndarray):
    """(min, max) over the finite values, (0, 1) when there are none."""
    finite = a[np.isfinite(a)]
    return ((float(finite.min()), float(finite.max())) if finite.size
            else (0.0, 1.0))


def _rgb_composite(patch_hwc: np.ndarray,
                   channels: Sequence[int]) -> np.ndarray:
    """[H, W, C] -> [H, W, 3] min-max normalized composite over the three
    display channels (clamped to the channel count for narrow models)."""
    chans = [c for c in channels if c < patch_hwc.shape[-1]]
    while len(chans) < 3:
        chans.append(chans[-1] if chans else 0)
    img = patch_hwc[..., chans[:3]].astype(np.float32)
    lo, hi = img.min(), img.max()
    return (img - lo) / (hi - lo + 1e-8)


def save_reconstruction_figure(figures_dir: Union[str, Path], step: int,
                               batch_hwc: np.ndarray, recon_hwc: np.ndarray,
                               rgb_channels: Sequence[int] = (100, 500, 900),
                               l2_targets: Optional[
                                   Dict[str, np.ndarray]] = None,
                               l2_preds: Optional[Dict[str, np.ndarray]] = None
                               ) -> Path:
    """batch/recon: [B, H, W, C] numpy. One row per shown sample (at most
    4): original RGB | recon RGB | |diff| heatmap (+MSE) | center-pixel
    spectrum [| L2 target | L2 prediction, of product i mod the number of
    products, on the target's finite range]."""
    products = list(l2_targets) if l2_targets else []
    n_rows, n_cols = 4, 4 + (2 if products else 0)
    n_show = min(n_rows, batch_hwc.shape[0])
    per_sample_mse = np.mean((batch_hwc - recon_hwc) ** 2, axis=(1, 2, 3))
    mid_y, mid_x = batch_hwc.shape[1] // 2, batch_hwc.shape[2] // 2
    path = Path(figures_dir) / f"reconstructions_step_{step:06d}.png"
    plt = pyplot()
    if plt is None:
        return png.write_png(path, png.grid([_png_row(
            batch_hwc[i], recon_hwc[i], rgb_channels, (mid_y, mid_x),
            l2_targets, l2_preds, products, i) for i in range(n_show)]))
    fig, axes = plt.subplots(n_rows, n_cols, figsize=(4.0 * n_cols,
                                                      4.0 * n_rows),
                             squeeze=False)
    for i in range(n_show):
        orig = _rgb_composite(batch_hwc[i], rgb_channels)
        rec = _rgb_composite(recon_hwc[i], rgb_channels)
        for ax, img, cmap, title in (
                (axes[i, 0], orig, None, f"Original {i}"),
                (axes[i, 1], rec, None, f"Recon {i}"),
                (axes[i, 2], np.abs(orig - rec), "hot",
                 f"|Diff| (MSE={per_sample_mse[i]:.4f})")):
            ax.imshow(img, cmap=cmap)
            ax.set_title(title)
            ax.axis("off")
        ax = axes[i, 3]
        channels = np.arange(batch_hwc.shape[-1])
        ax.plot(channels, batch_hwc[i, mid_y, mid_x, :], alpha=0.8,
                label="Original")
        ax.plot(channels, recon_hwc[i, mid_y, mid_x, :], alpha=0.8,
                label="Recon")
        ax.set_title(f"Spectrum at ({mid_y},{mid_x})")
        ax.set_xlabel("Spectral Channel")
        ax.legend()
        ax.grid(True, alpha=0.3)
        if products:
            prod = products[i % len(products)]
            vmin, vmax = _finite_range(l2_targets[prod][i])
            for ax, img, title in (
                    (axes[i, 4], l2_targets[prod][i], f"{prod} target"),
                    (axes[i, 5], l2_preds[prod][i], f"{prod} pred")):
                ax.imshow(img, cmap="viridis", vmin=vmin, vmax=vmax)
                ax.set_title(title)
                ax.axis("off")
    for i in range(n_show, n_rows):
        for j in range(n_cols):
            axes[i, j].axis("off")
    path.parent.mkdir(parents=True, exist_ok=True)
    fig.suptitle(f"Reconstructions at Step {step}")
    fig.tight_layout()
    fig.savefig(path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return path


def _png_row(orig_hwc, recon_hwc, rgb_channels, mid, l2_targets, l2_preds,
             products, i) -> list:
    """One sample's panels of the reconstruction figure, for png.grid."""
    orig = _rgb_composite(orig_hwc, rgb_channels)
    rec = _rgb_composite(recon_hwc, rgb_channels)
    channels = np.arange(orig_hwc.shape[-1])
    row = [png.colorize(orig), png.colorize(rec),
           png.colorize(np.abs(orig - rec)),
           png.curves({"Original": (channels, orig_hwc[mid]),
                       "Recon": (channels, recon_hwc[mid])},
                      size=(png.PANEL, png.PANEL))]
    if products:
        prod = products[i % len(products)]
        vmin, vmax = _finite_range(l2_targets[prod][i])
        row += [png.colorize(l2_targets[prod][i], "viridis", vmin, vmax),
                png.colorize(l2_preds[prod][i], "viridis", vmin, vmax)]
    return row
