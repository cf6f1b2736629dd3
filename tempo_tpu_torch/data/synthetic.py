"""Synthetic tile shards for tests and for the card; the port's copy of
tempo_tpu/data/synthetic.py ``make_tile_shards``.

The HDF5 granule writers of the JAX module (``write_granule``,
``make_granule_corpus``, ``make_structured_corpus``) need h5py and the
granule reader (``data/granule.py``), which are not ported yet; they come
with it.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np


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
