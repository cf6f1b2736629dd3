"""Synthetic TEMPO-shaped data for tests and for the card; the port's copy
of tempo_tpu/data/synthetic.py.

The HDF5 granule writers lay files out as real TEMPO netCDF-4 granules
(<band>/radiance [mirror, track, spectral]; product/<field> for L2), so the
analysis CLIs run end to end without NASA Earthdata access. They import
h5py inside the functions (the GPU machine has none); the array
generators (``synthetic_radiance``, ``structured_granule``) need numpy only.
Every generator is numpy's, drawn in the JAX module's order, so a seed
gives the JAX package's arrays and files bit for bit.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from tempo_tpu_torch.data.granule import DEFAULT_BAND

L2_FIELDS = {
    "NO2": "vertical_column_troposphere",
    "O3TOT": "column_amount_o3",
    "HCHO": "vertical_column",
    "CLDO4": "cloud_fraction",
}


def synthetic_radiance(rng: np.random.Generator, n_mirror: int, n_track: int,
                       n_spectral: int) -> np.ndarray:
    """Positive, spatially-smooth, spectrally-correlated radiance field."""
    base = rng.gamma(shape=2.0, scale=5e10, size=(n_mirror, n_track, 1))
    spectrum = 0.5 + rng.random((1, 1, n_spectral))
    noise = 1.0 + 0.1 * rng.standard_normal((n_mirror, n_track, n_spectral))
    rad = base * spectrum * np.abs(noise)
    return rad.astype(np.float32)


def _write_h5(path: Path, group: str, name: str, data: np.ndarray) -> None:
    import h5py

    with h5py.File(path, "w") as f:
        f.create_group(group).create_dataset(name, data=data)


def write_granule(path: Path, rng: np.random.Generator, n_mirror: int = 72,
                  n_track: int = 80, n_spectral: int = 16,
                  band: str = DEFAULT_BAND) -> np.ndarray:
    rad = synthetic_radiance(rng, n_mirror, n_track, n_spectral)
    _write_h5(path, band, "radiance", rad)
    return rad


def write_l2_granule(path: Path, rng: np.random.Generator, product: str,
                     n_mirror: int = 72, n_track: int = 80,
                     nan_fraction: float = 0.1) -> np.ndarray:
    if product == "CLDO4":
        data = rng.random((n_mirror, n_track)).astype(np.float32)
    elif product == "O3TOT":
        data = (300 + 30 * rng.standard_normal((n_mirror, n_track))
                ).astype(np.float32)
    else:  # NO2 / HCHO: heavy-tailed with negatives, raw units pre-scale
        data = (rng.standard_normal((n_mirror, n_track)) * 3e15
                ).astype(np.float32)
    # fill values the reader must convert to NaN
    mask = rng.random((n_mirror, n_track)) < nan_fraction
    data = np.where(mask, np.float32(-1e30), data)
    _write_h5(path, "product", L2_FIELDS[product], data)
    return data


def _stem(g: int) -> str:
    return f"TEMPO_RAD_L1_V03_2025010{g % 10}T{g:02d}0000Z_S001G0{g}.nc"


def make_granule_corpus(root: Path, n_granules: int = 4, n_mirror: int = 72,
                        n_track: int = 80, n_spectral: int = 16,
                        l2_products: Optional[Sequence[str]] = None,
                        seed: int = 0) -> Dict[str, Path]:
    """An L1 raw/ directory and per-product L2 trees in the reference's
    layout and filename convention. Returns {'l1': <dir>, '<PRODUCT>':
    <dir>, ...}."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    l1_raw = root / "l1" / "raw"
    l1_raw.mkdir(parents=True, exist_ok=True)
    paths = {"l1": root / "l1"}
    for g in range(n_granules):
        stem = _stem(g)
        write_granule(l1_raw / stem, rng, n_mirror, n_track, n_spectral)
        for product in (l2_products or []):
            l2_dir = root / f"l2_{product}" / "raw"
            l2_dir.mkdir(parents=True, exist_ok=True)
            write_l2_granule(l2_dir / stem.replace("_RAD_L1_",
                                                   f"_{product}_L2_"),
                             rng, product, n_mirror, n_track)
            paths[product] = root / f"l2_{product}"
    return paths


def make_tile_shards(root: Path, n_files: int = 3, tiles_per_file: int = 8,
                     tile: int = 16, n_spectral: int = 8,
                     l2_products: Optional[Sequence[str]] = None,
                     seed: int = 0, dtype=np.float32) -> Path:
    """Normalized (standard normal) tile shards ``NNNNN.npy`` of
    [tiles_per_file, tile, tile, n_spectral] in ``dtype`` (float32 gives the
    JAX package's files bit for bit; float16 halves them), and L2 fields
    with 5% NaN under ``l2_<PRODUCT>/``. Returns the shard directory."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        tiles = rng.standard_normal(
            (tiles_per_file, tile, tile, n_spectral)).astype(np.float32)
        np.save(root / f"{i:05d}.npy", tiles.astype(dtype))
        for product in (l2_products or []):
            l2_dir = root / f"l2_{product}"
            l2_dir.mkdir(exist_ok=True)
            fields = rng.standard_normal(
                (tiles_per_file, tile, tile)).astype(np.float32)
            fields[rng.random(fields.shape) < 0.05] = np.nan
            np.save(l2_dir / f"{i:05d}.npy", fields)
    return root


# --------------------------------------------------------------------------
# Structured corpus: the positive-control science dataset. K smooth latent
# fields phi_k drive both the log-radiance (as spectral mixing weights) and
# the four L2 products (as monotone per-product functions), so an encoder
# that reconstructs the spectra carries phi in its latents, and probes from
# latents to L2 succeed if and only if training worked.


def _smooth_field(rng: np.random.Generator, n_mirror: int, n_track: int,
                  corr: float = 10.0) -> np.ndarray:
    """Zero-mean, unit-std random field with ~corr-pixel correlation length
    (FFT-space Gaussian low-pass)."""
    noise = rng.standard_normal((n_mirror, n_track))
    fy = np.fft.fftfreq(n_mirror)[:, None]
    fx = np.fft.fftfreq(n_track)[None, :]
    filt = np.exp(-2.0 * (np.pi * corr) ** 2 * (fy ** 2 + fx ** 2))
    field = np.fft.ifft2(np.fft.fft2(noise) * filt).real
    field -= field.mean()
    std = field.std()
    return (field / std if std > 0 else field).astype(np.float32)


def structured_granule(rng: np.random.Generator, n_mirror: int, n_track: int,
                       n_spectral: int, n_factors: int = 4,
                       signal: float = 0.5, noise: float = 0.02):
    """Radiance and L2 fields driven by shared smooth latent factors:
    log(radiance) = a0(lambda) + signal * sum_k phi_k(x,y) s_k(lambda) + eps,
    and each product a monotone function of one phi_k in its natural range.
    Returns (radiance [M,T,S] float32, {product: field [M,T] float32})."""
    phis = [_smooth_field(rng, n_mirror, n_track) for _ in range(n_factors)]
    lam = np.linspace(0.0, 1.0, n_spectral)
    a0 = np.log(5e10) + 0.2 * np.sin(2 * np.pi * lam)
    sigs = [np.cos(np.pi * (k + 1) * lam + rng.uniform(0, np.pi))
            for k in range(n_factors)]
    log_rad = a0[None, None, :] + noise * rng.standard_normal(
        (n_mirror, n_track, n_spectral))
    for phi, sig in zip(phis, sigs):
        log_rad += signal * phi[:, :, None] * sig[None, None, :]
    rad = np.exp(log_rad).astype(np.float32)

    fields = {
        "NO2": (2e15 * phis[0 % n_factors]).astype(np.float32),
        "O3TOT": (300.0 + 30.0 * phis[1 % n_factors]).astype(np.float32),
        "HCHO": (8e15 * phis[2 % n_factors]).astype(np.float32),
        "CLDO4": np.clip(0.5 + 0.3 * phis[3 % n_factors],
                         0.02, 0.98).astype(np.float32),
    }
    return rad, fields


def with_fill_values(rng: np.random.Generator, data: np.ndarray,
                     nan_fraction: float) -> np.ndarray:
    """``data`` with a random ``nan_fraction`` of it set to the L2 fill
    value -1e30 (what ``read_l2_field`` turns into NaN)."""
    mask = rng.random(data.shape) < nan_fraction
    return np.where(mask, np.float32(-1e30), data)


def make_structured_corpus(root: Path, n_granules: int = 8,
                           n_mirror: int = 72, n_track: int = 80,
                           n_spectral: int = 16,
                           l2_products: Optional[Sequence[str]] = None,
                           nan_fraction: float = 0.05,
                           signal: float = 0.5,
                           seed: int = 0) -> Dict[str, Path]:
    """make_granule_corpus's layout over ``structured_granule``s: radiance
    and L2 fields share latent structure (the positive-control corpus for
    the probes)."""
    rng = np.random.default_rng(seed)
    root = Path(root)
    l1_raw = root / "l1" / "raw"
    l1_raw.mkdir(parents=True, exist_ok=True)
    paths = {"l1": root / "l1"}
    for g in range(n_granules):
        stem = _stem(g)
        rad, fields = structured_granule(rng, n_mirror, n_track, n_spectral,
                                         signal=signal)
        _write_h5(l1_raw / stem, DEFAULT_BAND, "radiance", rad)
        for product in (l2_products or []):
            l2_dir = root / f"l2_{product}" / "raw"
            l2_dir.mkdir(parents=True, exist_ok=True)
            data = with_fill_values(rng, fields[product], nan_fraction)
            _write_h5(l2_dir / stem.replace("_RAD_L1_", f"_{product}_L2_"),
                      "product", L2_FIELDS[product], data)
            paths[product] = root / f"l2_{product}"
    return paths
