"""Spectral radiance normalization; the port's copy of
tempo_tpu/data/normalize.py ``normalize_radiance`` (numpy only; the JAX
package's ``data`` package imports JAX, so the port keeps its own copy).

  z = clip((log(clamp(rad, min_radiance)) - mean) / (std + 1e-8),
           clip_min, clip_max)

with per-channel global mean/std, or the array's own per-channel stats
when none are given.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def normalize_radiance(rad: np.ndarray,
                       mean_spectrum: Optional[np.ndarray] = None,
                       std_spectrum: Optional[np.ndarray] = None,
                       min_radiance: float = 1.0,
                       clip_min: float = -10.0,
                       clip_max: float = 10.0) -> np.ndarray:
    """rad: [..., spectral] -> z-scored log radiance, same shape, fp32."""
    log_rad = np.log(np.clip(rad, min_radiance, None))
    if mean_spectrum is not None and std_spectrum is not None:
        z = (log_rad - mean_spectrum) / (std_spectrum + 1e-8)
    else:
        axes = tuple(range(log_rad.ndim - 1))
        mean = log_rad.mean(axis=axes)
        std = log_rad.std(axis=axes)
        z = (log_rad - mean) / (std + 1e-8)
    return np.clip(z, clip_min, clip_max).astype(np.float32)
