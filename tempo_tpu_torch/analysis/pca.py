"""PCA over normalized spectra (SVD-based; no sklearn dependency); the
port's copy of tempo_tpu/analysis/pca.py (numpy only; the JAX package's
``analysis`` package is part of the JAX package, so the port keeps its own
copy).

Parity with the reference PCA extraction (reference:
src/scripts/extract_pca_components.py:92-163): fit k components over sampled
normalized pixels [N, n_spectral]; persist components [k, C], mean [C],
explained variance (ratio), and sample projections. Numerically equivalent
to sklearn.decomposition.PCA (same centering + SVD, deterministic sign
convention: largest-|value| loading positive per component).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Union

import numpy as np


@dataclass
class PCAResult:
    components: np.ndarray          # [k, C]
    mean: np.ndarray                # [C]
    explained_variance: np.ndarray  # [k]
    explained_variance_ratio: np.ndarray  # [k]
    n_samples: int

    def transform(self, x: np.ndarray) -> np.ndarray:
        """[N, C] -> [N, k]."""
        return (x - self.mean) @ self.components.T

    def save(self, path: Union[str, Path]) -> None:
        np.savez(
            path,
            components=self.components,
            mean=self.mean,
            explained_variance=self.explained_variance,
            explained_variance_ratio=self.explained_variance_ratio,
            n_samples=self.n_samples,
        )

    @classmethod
    def load(cls, path: Union[str, Path]) -> "PCAResult":
        path = str(path)
        if path.endswith(".pt"):  # reference-artifact interop
            import torch

            d = torch.load(path, weights_only=True)
            return cls(
                components=np.asarray(d["components"], dtype=np.float32),
                mean=np.asarray(d["mean"], dtype=np.float32),
                explained_variance=np.asarray(d["explained_variance"]),
                explained_variance_ratio=np.asarray(d["explained_variance_ratio"]),
                n_samples=int(d.get("n_samples", 0)),
            )
        d = np.load(path)
        return cls(
            components=d["components"],
            mean=d["mean"],
            explained_variance=d["explained_variance"],
            explained_variance_ratio=d["explained_variance_ratio"],
            n_samples=int(d["n_samples"]),
        )


def fit_pca(x: np.ndarray, n_components: int = 3) -> PCAResult:
    """x: [N, C] float. Full-batch exact PCA via SVD."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    mean = x.mean(axis=0)
    centered = x - mean
    _, s, vt = np.linalg.svd(centered, full_matrices=False)

    # sklearn's deterministic sign convention (svd_flip on V)
    max_idx = np.argmax(np.abs(vt), axis=1)
    signs = np.sign(vt[np.arange(vt.shape[0]), max_idx])
    signs[signs == 0] = 1.0
    vt = vt * signs[:, None]

    explained_variance = (s ** 2) / (n - 1)
    total_var = centered.var(axis=0, ddof=1).sum()
    ratio = explained_variance / total_var

    return PCAResult(
        components=vt[:n_components].astype(np.float32),
        mean=mean.astype(np.float32),
        explained_variance=explained_variance[:n_components].astype(np.float32),
        explained_variance_ratio=ratio[:n_components].astype(np.float32),
        n_samples=n,
    )


def pca_rgb(image_hwc: np.ndarray, pca: PCAResult,
            reference_hwc: np.ndarray | None = None) -> np.ndarray:
    """Project [H, W, C] onto the first 3 components and percentile-normalize
    each channel to [0, 1] for display. When `reference_hwc` is given, its
    2%/98% quantiles set the scaling for both images (the reference scales
    recon with GT quantiles: src/scripts/analyze_reconstruction.py:155-164)."""
    proj = (image_hwc - pca.mean) @ pca.components[:3].T
    ref = proj if reference_hwc is None else \
        (reference_hwc - pca.mean) @ pca.components[:3].T
    out = np.empty_like(proj)
    for i in range(3):
        vmin, vmax = np.quantile(ref[..., i], [0.02, 0.98])
        out[..., i] = np.clip((proj[..., i] - vmin) / (vmax - vmin + 1e-8), 0, 1)
    return out
