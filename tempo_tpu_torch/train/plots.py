"""Live training curves; counterpart of tempo_tpu/train/plots.py
``update_summary_plots``.

summary/{loss,recons_err,kl}.png, one per metric the history carries,
log-log from step 100 on, with the validation loss as markers on the loss
curve. matplotlib is imported inside the function, so the package imports
where it is absent. The reconstruction figures wait for VAE training.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Union

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
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    summary_dir = Path(summary_dir)
    summary_dir.mkdir(parents=True, exist_ok=True)
    log_scale = sum(m["step"] >= LOG_SCALE_FROM for m in train_history) >= 2
    suffix = " (log-log scale)" if log_scale else ""
    for filename, (key, title, ylabel) in SUMMARY_SERIES.items():
        steps, values = _history_view(train_history, key, log_scale)
        if not steps:
            continue
        fig, ax = plt.subplots(figsize=(10, 6))
        ax.plot(steps, values, alpha=0.8, label="Train")
        if key == "loss":
            vs, vv = _history_view(val_history, "val_loss", log_scale)
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
