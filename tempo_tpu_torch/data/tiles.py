"""Tile extraction with matched augmentations, and the shard format; the
port's copy of tempo_tpu/data/tiles.py (numpy, and torch for .pt shards;
the JAX package's ``data`` package imports JAX, so the port keeps its own
copy).

Per granule, ``n_tiles`` random (overlapping) tile positions; each tile
gets an independent random horizontal flip, vertical flip and k*90-degree
rotation; L2 product windows are cut at the SAME positions and pushed
through the SAME augmentation. ``extract_tiles_with_positions`` also takes
a tensor: it draws from the numpy Generator exactly as for an array and
cuts, flips and rotates on the tensor's device (``prepare_tiles`` does so
on the card); L2 windows stay host numpy.

Shard format: .npy files (float32 or float16 [N, H, W, C], already NHWC,
so the loader never permutes). The loader also accepts .pt shards for
interop with reference-produced tiles.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch


@dataclass
class TilePosition:
    i: int
    j: int
    flip_h: bool
    flip_v: bool
    rotation: int  # number of 90-degree rotations

    def to_dict(self) -> Dict:
        return {"i": self.i, "j": self.j, "flip_h": self.flip_h,
                "flip_v": self.flip_v, "rotation": self.rotation}


def apply_augmentation(tile: Union[np.ndarray, torch.Tensor], flip_h: bool,
                       flip_v: bool, rotation: int):
    """tile: [H, W, ...]; flips/rotations act on the two leading (spatial)
    axes, matching torch.flip(dims=[0]/[1]) and torch.rot90(dims=[0,1]),
    which a tensor takes."""
    if isinstance(tile, torch.Tensor):
        if flip_h:
            tile = torch.flip(tile, dims=(0,))
        if flip_v:
            tile = torch.flip(tile, dims=(1,))
        if rotation > 0:
            tile = torch.rot90(tile, rotation, dims=(0, 1))
        return tile
    if flip_h:
        tile = np.flip(tile, axis=0)
    if flip_v:
        tile = np.flip(tile, axis=1)
    if rotation > 0:
        tile = np.rot90(tile, rotation, axes=(0, 1))
    return tile


def extract_tiles_with_positions(
    z_rad: Union[np.ndarray, torch.Tensor],
    tile_size: Sequence[int],
    n_tiles: int,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[Optional[Union[np.ndarray, torch.Tensor]],
           Optional[List[TilePosition]]]:
    """z_rad: [mirror, track, spectral]. Returns ([N, th, tw, C], positions)
    or (None, None) when the granule is smaller than a tile; the tiles are
    a tensor on z_rad's device for a tensor."""
    rng = rng or np.random.default_rng()
    n_mirror, n_track = z_rad.shape[:2]
    tile_mirror, tile_track = tile_size
    if n_mirror < tile_mirror or n_track < tile_track:
        return None, None

    tiles = []
    positions = []
    for _ in range(n_tiles):
        i = int(rng.integers(0, n_mirror - tile_mirror + 1))
        j = int(rng.integers(0, n_track - tile_track + 1))
        flip_h = bool(rng.random() > 0.5)
        flip_v = bool(rng.random() > 0.5)
        rotation = int(rng.integers(0, 4))

        tile = apply_augmentation(
            z_rad[i:i + tile_mirror, j:j + tile_track], flip_h, flip_v,
            rotation)
        tiles.append(tile)
        positions.append(TilePosition(i, j, flip_h, flip_v, rotation))

    if isinstance(z_rad, torch.Tensor):
        return torch.stack(tiles), positions
    return np.stack(tiles), positions


def extract_l2_tiles(l2_field: np.ndarray, positions: List[TilePosition],
                     tile_size: Sequence[int]) -> np.ndarray:
    """Cut the same windows + augmentations from a [mirror, track] L2 field."""
    tile_mirror, tile_track = tile_size
    out = []
    for pos in positions:
        window = l2_field[pos.i:pos.i + tile_mirror,
                          pos.j:pos.j + tile_track].copy()
        out.append(np.ascontiguousarray(
            apply_augmentation(window, pos.flip_h, pos.flip_v, pos.rotation)))
    return np.stack(out)


# ----------------------------------------------------------------- shards

def find_l2_shard(l2_dir, spectral_name: str) -> Path:
    """Resolve the L2 shard matching a spectral shard filename inside an
    l2_<PRODUCT>/ directory, tolerating the .npy<->.pt format mismatch when
    mixing native and reference-produced tiles. Raises FileNotFoundError
    (fail-loud, as the L2 pipeline's contract asks)."""
    l2_dir = Path(l2_dir)
    path = l2_dir / spectral_name
    if path.exists():
        return path
    alt = (l2_dir / Path(spectral_name).stem).with_suffix(
        ".pt" if spectral_name.endswith(".npy") else ".npy")
    if alt.exists():
        return alt
    raise FileNotFoundError(f"FATAL: L2 shard not found: {path}")


def save_tile_shard(path, tiles: np.ndarray, dtype=np.float32) -> None:
    """tiles: [N, H, W, C] (or [N, H, W] for L2) -> .npy. dtype float16
    halves shard size; the loader widens to float32 on gather."""
    np.save(path, np.asarray(tiles, dtype=dtype))


def load_tile_shard(path, mmap: bool = False) -> np.ndarray:
    """Load a shard: .npy (native; optionally memory-mapped so tiles stay
    page-cache views until the batch gather copies them) or .pt
    (reference interop)."""
    path = str(path)
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r" if mmap else None)
    if path.endswith(".pt"):
        data = torch.load(path, weights_only=True, map_location="cpu")
        return data.numpy()
    raise ValueError(f"Unknown shard format: {path}")
