"""TEMPO granule ingest; the port's copy of tempo_tpu/data/granule.py.

TEMPO L1b/L2 ".nc" granules are netCDF-4 files, i.e. HDF5 containers, read
with h5py, with the netCDF4 package as the fallback for any file h5py cannot
open. Both are imported inside the functions: the package imports where
neither is installed (the GPU machine has neither), and a read there raises
OSError.

- L1b radiance lives at <band>/radiance ([mirror, track, spectral]); fill
  values stay in place, and the log clamp at min_radiance=1.0 neutralizes
  them.
- L2 product fields live at product/<field>; fill values < -1e29 become
  NaN and the field is divided by a per-product scale.
- scale_factor/add_offset attributes are honored when present (netCDF4's
  auto-scaling).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import numpy as np

DEFAULT_BAND = "band_290_490_nm"
FILL_THRESHOLD = -1e29


def _apply_attrs(data: np.ndarray, attrs) -> np.ndarray:
    scale = attrs.get("scale_factor")
    offset = attrs.get("add_offset")
    if scale is not None or offset is not None:
        data = data.astype(np.float64)
        if scale is not None:
            data = data * np.asarray(scale).item()
        if offset is not None:
            data = data + np.asarray(offset).item()
    return data


def _read_h5(path: Path, dataset_path: str) -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as f:
        if dataset_path not in f:
            raise KeyError(f"{dataset_path} not found in {path}")
        ds = f[dataset_path]
        return _apply_attrs(np.asarray(ds[...]), ds.attrs)


def _read_netcdf4(path: Path, group: Optional[str], var: str) -> np.ndarray:
    import netCDF4 as nc  # type: ignore

    with nc.Dataset(path) as f:
        node = f[group] if group else f
        return np.array(node[var][...])


def read_dataset(path: Union[str, Path], group: Optional[str], var: str
                 ) -> np.ndarray:
    path = Path(path)
    dataset_path = f"{group}/{var}" if group else var
    try:
        return _read_h5(path, dataset_path)
    except (ImportError, OSError, KeyError):
        pass
    try:
        return _read_netcdf4(path, group, var)
    except ImportError:
        raise OSError(
            f"Could not read {dataset_path} from {path} with h5py and netCDF4 "
            "is not installed")


def read_radiance(path: Union[str, Path], band: str = DEFAULT_BAND
                  ) -> np.ndarray:
    """[mirror, track, spectral] float32 radiance."""
    return np.asarray(read_dataset(path, band, "radiance"), dtype=np.float32)


def read_l2_field(path: Union[str, Path], field: str, scale: float = 1.0
                  ) -> Optional[np.ndarray]:
    """[mirror, track] float32 product field; fills < -1e29 -> NaN; divided
    by ``scale``. None if the group or field is missing."""
    try:
        data = read_dataset(path, "product", field)
    except (OSError, KeyError):
        return None
    data = np.asarray(data, dtype=np.float32)
    data = np.where(data < FILL_THRESHOLD, np.nan, data)
    return data / np.float32(scale)


def l2_filename_for(l1_filename: str, product_name: str) -> str:
    """The L2 granule's filename from the paired L1 filename, by the
    _RAD_L1_ -> _<PRODUCT>_L2_ substitution."""
    return l1_filename.replace("_RAD_L1_", f"_{product_name}_L2_")
