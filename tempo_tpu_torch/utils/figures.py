"""House figure toolkit; counterpart of tempo_tpu/utils/figures.py: one
grid constructor, one finisher and composable panel fillers, shared by the
sweep, the reconstruction analysis and the probe analysis, which write the
JAX package's files.

matplotlib is imported inside the functions. Where it is absent (the GPU
machine has none), ``new_grid`` hands out ``PngAxes`` panels instead, the
fillers draw each panel with train/png.py (curves, bars, images; no text),
and ``finish`` writes the grid of panels to the same path. The JAX
module's publication styling (``linear_colors``, ``apply_*``) has no
caller in the port and is not copied.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from tempo_tpu_torch.train import png

# one categorical color per L2 product, reused everywhere a product shows up
PRODUCT_COLORS = ("tab:red", "tab:blue", "tab:green", "tab:purple")

GRID_ALPHA = 0.3
PNG_SIDE = 2 * png.PANEL  # side of a panel drawn without matplotlib


def pyplot():
    """matplotlib.pyplot on the Agg backend; None where matplotlib is
    absent."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class PngAxes:
    """A panel drawn without matplotlib: the [h, w, 3] uint8 image its
    filler drew (None: blank)."""

    def __init__(self):
        self.image: Optional[np.ndarray] = None

    def axis(self, *_args) -> None:
        """Axes are never drawn on a PNG panel."""


class PngFigure:
    def __init__(self, axes: np.ndarray):
        self.axes = axes


def product_color(index: int) -> str:
    return PRODUCT_COLORS[index % len(PRODUCT_COLORS)]


def new_grid(rows: int, cols: int, panel: tuple = (4.0, 4.0)):
    """Always (fig, axes[rows, cols]): matplotlib's, or PngAxes panels
    where matplotlib is absent."""
    plt = pyplot()
    if plt is None:
        axes = np.empty((rows, cols), dtype=object)
        for idx in np.ndindex(rows, cols):
            axes[idx] = PngAxes()
        return PngFigure(axes), axes
    return plt.subplots(rows, cols, figsize=(panel[0] * cols,
                                             panel[1] * rows), squeeze=False)


def finish(fig, path: Path, suptitle: Optional[str] = None,
           dpi: int = 150) -> Path:
    """The suptitle/layout/save/close tail every figure shares."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if isinstance(fig, PngFigure):
        blank = np.full((1, 1, 3), 255, dtype=np.uint8)
        return png.write_png(path, png.grid(
            [[blank if ax.image is None else ax.image for ax in row]
             for row in fig.axes], side=PNG_SIDE))
    if suptitle:
        fig.suptitle(suptitle)
    fig.tight_layout()
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    pyplot().close(fig)
    return path


def stats_box(ax, values: np.ndarray, decimals: int = 3,
              count: bool = False, face: str = "white") -> None:
    """Corner annotation with mean/std/min/max (and N)."""
    values = np.asarray(values)
    if isinstance(ax, PngAxes) or values.size == 0 \
            or not np.isfinite(values).any():
        return
    finite = values[np.isfinite(values)]
    lines = [f"Mean: {finite.mean():.{decimals}f}",
             f"Std: {finite.std():.{decimals}f}",
             f"Min: {finite.min():.{decimals}f}",
             f"Max: {finite.max():.{decimals}f}"]
    if count:
        lines.append(f"N: {finite.size}")
    ax.text(0.02, 0.98, "\n".join(lines), transform=ax.transAxes,
            fontsize=8, va="top",
            bbox=dict(boxstyle="round", facecolor=face, alpha=0.8))


def _labels(ax, title: str, xlabel: str, ylabel: str,
            bold: bool = False) -> None:
    ax.set_title(title, fontweight="bold" if bold else None)
    if xlabel:
        ax.set_xlabel(xlabel)
    if ylabel:
        ax.set_ylabel(ylabel)


def hist_panel(ax, values: np.ndarray, title: str = "",
               xlabel: str = "", ylabel: str = "Count", bins: int = 100,
               color: Optional[str] = None, log_y: bool = True,
               density: bool = False, show_stats: bool = True,
               stats_face: str = "white") -> None:
    values = np.asarray(values).ravel()
    finite = values[np.isfinite(values)]
    if isinstance(ax, PngAxes):
        if finite.size:
            counts, _ = np.histogram(finite, bins=bins, density=density)
            ax.image = png.bars(np.log10(1 + counts) if log_y else counts)
        return
    if finite.size:
        ax.hist(finite, bins=bins, alpha=0.7, color=color, density=density)
        if log_y:
            ax.set_yscale("log")
        if show_stats:
            stats_box(ax, finite, face=stats_face,
                      count=density is False and ylabel == "Count")
    else:
        ax.text(0.5, 0.5, "no finite values", transform=ax.transAxes,
                ha="center", va="center")
    _labels(ax, title, xlabel, ylabel, bold=True)
    ax.grid(True, alpha=GRID_ALPHA)


def overlay_hists(ax, columns: Dict[str, np.ndarray], bins: int = 50,
                  title: str = "", xlabel: str = "",
                  ylabel: str = "Density") -> None:
    """Density histograms of several series on one panel, one per label."""
    if isinstance(ax, PngAxes):
        allv = np.concatenate([np.asarray(v).ravel()
                               for v in columns.values()])
        edges = np.histogram_bin_edges(allv[np.isfinite(allv)], bins=bins)
        mid = 0.5 * (edges[1:] + edges[:-1])
        ax.image = png.curves({k: (mid, np.histogram(v, bins=edges,
                                                     density=True)[0])
                               for k, v in columns.items()})
        return
    for label, v in columns.items():
        ax.hist(v, bins=bins, alpha=0.5, density=True, label=label)
    _labels(ax, title, xlabel, ylabel)
    ax.legend()
    ax.grid(True, alpha=GRID_ALPHA)


def image_panel(ax, img: np.ndarray, title: str = "", cmap=None,
                vmin=None, vmax=None, colorbar: bool = False) -> None:
    if isinstance(ax, PngAxes):
        ax.image = png.colorize(img, cmap, vmin, vmax)
        return
    im = ax.imshow(img, cmap=cmap, vmin=vmin, vmax=vmax, aspect="auto")
    if colorbar:
        pyplot().colorbar(im, ax=ax, fraction=0.046)
    ax.set_title(title)
    ax.axis("off")


def finite_range(values: np.ndarray, fallback=(0.0, 1.0)):
    """(vmin, vmax) over finite entries; ``fallback`` when there are
    none."""
    values = np.asarray(values)
    finite = values[np.isfinite(values)]
    if finite.size == 0:
        return fallback
    return float(finite.min()), float(finite.max())


def curve_panel(ax, x: Sequence, series: Dict[str, Sequence],
                title: str = "", xlabel: str = "Step", ylabel: str = "",
                log_x: bool = False, log_y: bool = False) -> None:
    if isinstance(ax, PngAxes):
        ax.image = png.curves({k: (x, ys) for k, ys in series.items()},
                              log_scale=log_x or log_y)
        return
    for label, ys in series.items():
        ax.plot(x, ys, alpha=0.8, label=label)
    if log_x:
        ax.set_xscale("log")
    if log_y:
        ax.set_yscale("log")
    _labels(ax, title, xlabel, ylabel)
    if len(series) > 1:
        ax.legend()
    ax.grid(True, alpha=GRID_ALPHA,
            which="both" if log_x or log_y else "major")


def mark_point(ax, x: float, y: float, label: str) -> None:
    """A red star at (x, y) with its legend entry (not drawn on a PNG
    panel)."""
    if isinstance(ax, PngAxes):
        return
    ax.scatter([x], [y], marker="*", s=180, color="tab:red", zorder=3,
               label=label)
    ax.legend()


def vline(ax, x: float, label: Optional[str] = None) -> None:
    """A dotted red vertical line (not drawn on a PNG panel)."""
    if isinstance(ax, PngAxes):
        return
    ax.axvline(x, color="tab:red", linestyle=":", alpha=0.6, label=label)
    if label:
        ax.legend()


def scatter_panel(ax, x: np.ndarray, y: np.ndarray, title: str = "",
                  xlabel: str = "", ylabel: str = "") -> None:
    """Points (x, y) and the diagonal y = x (on a PNG panel: their 2D
    histogram)."""
    x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
    if isinstance(ax, PngAxes):
        hist, _, _ = np.histogram2d(y, x, bins=64)
        ax.image = png.colorize(np.log1p(hist[::-1]), "viridis")
        return
    ax.scatter(x, y, alpha=0.5, s=12)
    lims = (float(x.min()), float(x.max()))
    ax.plot(lims, lims, color="tab:red", linestyle=":",
            label="Perfect prediction")
    _labels(ax, title, xlabel, ylabel)
    ax.legend()
    ax.grid(True, alpha=GRID_ALPHA)


def annotated_bars(ax, names: Sequence[str], values: Sequence[float],
                   labels: Optional[Sequence[str]] = None, title: str = "",
                   ylabel: str = "", ylim=None) -> None:
    """Bar chart with a text annotation above each bar."""
    if isinstance(ax, PngAxes):
        ax.image = png.bars(values)
        return
    bars = ax.bar(range(len(names)), values)
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names)
    if labels is None:
        labels = [f"{v:.3f}" for v in values]
    for bar, text in zip(bars, labels):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(), text,
                ha="center", va="bottom", fontsize=9)
    _labels(ax, title, "", ylabel)
    if ylim is not None:
        ax.set_ylim(ylim)
