"""Normalization of spectral radiance and L2 product fields; the port's copy
of tempo_tpu/data/normalize.py (the JAX package's ``data`` package imports
JAX, so the port keeps its own copy).

Spectral:
  z = clip((log(clamp(rad, min_radiance)) - mean) / (std + 1e-8),
           clip_min, clip_max)
  with per-channel global mean/std, or the array's own per-channel stats
  when none are given. ``normalize_radiance`` of a numpy array computes in
  numpy; of a torch tensor, the same math in fp32 on the tensor's device
  (the granule codec normalizes on the card that way).

L2 products (numpy):
  zscore : (x - mean) / (std + 1e-8)
  minmax : (x - min) / (max - min + 1e-8)
  asinh  : asinh(x / (1.4826 * MAD + 1e-8))   [no median subtraction]
  logit  : log(s / (1 - s)), s = eps + (1 - 2 eps) x, eps = 0.01
NaNs pass through every transform untouched.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


def normalize_radiance(rad: Union[np.ndarray, torch.Tensor],
                       mean_spectrum=None, std_spectrum=None,
                       min_radiance: float = 1.0,
                       clip_min: float = -10.0,
                       clip_max: float = 10.0):
    """rad: [..., spectral] -> z-scored log radiance, same shape, fp32: a
    numpy array for a numpy array, a tensor on rad's device for a
    tensor."""
    if isinstance(rad, torch.Tensor):
        return _normalize_radiance_tensor(rad, mean_spectrum, std_spectrum,
                                          min_radiance, clip_min, clip_max)
    log_rad = np.log(np.clip(rad, min_radiance, None))
    if mean_spectrum is not None and std_spectrum is not None:
        z = (log_rad - mean_spectrum) / (std_spectrum + 1e-8)
    else:
        axes = tuple(range(log_rad.ndim - 1))
        mean = log_rad.mean(axis=axes)
        std = log_rad.std(axis=axes)
        z = (log_rad - mean) / (std + 1e-8)
    return np.clip(z, clip_min, clip_max).astype(np.float32)


def _normalize_radiance_tensor(rad: torch.Tensor, mean_spectrum,
                               std_spectrum, min_radiance: float,
                               clip_min: float, clip_max: float
                               ) -> torch.Tensor:
    """The numpy function's math in fp32 on rad's device: one new tensor
    (the clamped log), updated in place from there."""
    z = torch.clamp(rad.float(), min=min_radiance).log_()
    if mean_spectrum is not None and std_spectrum is not None:
        mean = torch.as_tensor(mean_spectrum, dtype=torch.float32,
                               device=z.device)
        std = torch.as_tensor(std_spectrum, dtype=torch.float32,
                              device=z.device)
    else:
        std, mean = torch.std_mean(z, dim=tuple(range(z.ndim - 1)),
                                   correction=0)
    return z.sub_(mean).div_(std + 1e-8).clamp_(clip_min, clip_max)


def compute_l2_stats(values: np.ndarray, norm_type: str
                     ) -> Optional[Dict[str, float]]:
    """Stats from the valid (non-NaN) values: the MAD scale for asinh, a
    fixed eps for logit."""
    valid = values[~np.isnan(values)]
    if valid.size == 0:
        return None
    if norm_type == "zscore":
        return {"mean": float(np.mean(valid)), "std": float(np.std(valid))}
    if norm_type == "minmax":
        return {"min": float(np.min(valid)), "max": float(np.max(valid))}
    if norm_type == "asinh":
        median = float(np.median(valid))
        mad = float(np.median(np.abs(valid - median)))
        return {"scale": 1.4826 * mad, "median": median}
    if norm_type == "logit":
        return {"eps": 0.01}
    raise ValueError(f"Unknown normalization type: {norm_type}")


def normalize_l2(data: np.ndarray, norm_type: str,
                 stats: Optional[Dict[str, float]] = None
                 ) -> Tuple[np.ndarray, Optional[Dict[str, float]]]:
    """Returns (normalized, stats); stats computed from ``data`` when
    None."""
    if stats is None:
        stats = compute_l2_stats(data, norm_type)
        if stats is None:
            return data, None

    if norm_type == "zscore":
        out = (data - stats["mean"]) / (stats["std"] + 1e-8)
    elif norm_type == "minmax":
        out = (data - stats["min"]) / (stats["max"] - stats["min"] + 1e-8)
    elif norm_type == "asinh":
        out = np.arcsinh(data / (stats["scale"] + 1e-8))
    elif norm_type == "logit":
        eps = stats["eps"]
        squeezed = eps + (1 - 2 * eps) * data
        squeezed = np.where(np.isnan(data), np.nan, squeezed)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = np.log(squeezed / (1 - squeezed))
    else:
        raise ValueError(f"Unknown normalization type: {norm_type}")
    return out.astype(np.float32), stats
