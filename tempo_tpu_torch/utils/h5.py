"""HDF5 maintenance helpers; counterpart of tempo_tpu/utils/h5.py.

``repack`` rewrites a file to reclaim the space of deleted datasets (HDF5
never shrinks in place); ``tree`` renders the group/dataset hierarchy with
shapes, dtypes and attrs. Host-only: h5py is imported inside the
functions, so the package loads where h5py is missing.
"""

from __future__ import annotations

import os
from typing import List


def repack(h5_file_path: str) -> None:
    """Copy every top-level object and the root attrs into a fresh file,
    then atomically replace the original."""
    import h5py

    tmp = h5_file_path + "_temp"
    with h5py.File(h5_file_path, "r") as src, h5py.File(tmp, "w") as dst:
        for key in src:
            src.copy(key, dst)
        for key, val in src.attrs.items():
            dst.attrs[key] = val
    os.replace(tmp, h5_file_path)


def _render(obj, prefix: str, lines: List[str], dataset_type) -> None:
    if obj.attrs:
        attrs = "; ".join(f"{k}: {v}" for k, v in obj.attrs.items())
        lines.append(f"{prefix}attrs: {attrs}")
    for key in obj:
        item = obj[key]
        if isinstance(item, dataset_type):
            lines.append(f"{prefix}{key}: shape={item.shape} "
                         f"dtype={item.dtype}")
        else:
            lines.append(f"{prefix}{key}/")
            _render(item, prefix + "  ", lines, dataset_type)


def tree(h5_file_path: str) -> str:
    """The recursive listing of groups, datasets and attrs, as a string."""
    import h5py

    lines: List[str] = []
    with h5py.File(h5_file_path, "r") as f:
        _render(f, "", lines, h5py.Dataset)
    return "\n".join(lines)
