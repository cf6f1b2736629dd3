"""ctypes bindings for the native tile-IO runtime (native/tileio.cpp); the
port's counterpart of tempo_tpu/data/native.py.

The shared library is compiled from the same source with g++ at first use
into ``build/native/`` at the repository root (git-ignored), named by a
hash of the source and flags, written through a temporary file and an
atomic rename. ``native/libtileio.so`` belongs to the JAX package and is
never written here. Where g++ or the build is absent, ``gather_batch``
copies with numpy and ``native_available()`` is False; numpy also takes
mixed dtypes and non-contiguous tiles, as in the JAX package. ctypes
releases the GIL around calls, so the threaded gather overlaps the
training thread.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent.parent
SRC = _ROOT / "native" / "tileio.cpp"
BUILD_DIR = _ROOT / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_checked = False


def library_path() -> Path:
    """Where the port's build of the source lands."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libtileio_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> bool:
    target.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        so = Path(tmp) / target.name
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(so), str(SRC),
                            "-lpthread"], check=True, capture_output=True,
                           timeout=120)
        except (subprocess.SubprocessError, OSError):
            return False
        os.replace(so, target)  # atomic: a reader never sees half a library
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The tile-IO library, built on first use; None where it cannot be."""
    global _lib, _lib_checked
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        if not SRC.exists():
            return None
        target = library_path()
        if not target.exists() and not _build(target):
            return None
        try:
            lib = ctypes.CDLL(str(target))
        except OSError:
            return None
        lib.gather_tiles.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.gather_tiles.restype = None
        lib.gather_tiles_f16_to_f32.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
        lib.gather_tiles_f16_to_f32.restype = None
        lib.tileio_version.argtypes = []
        lib.tileio_version.restype = ctypes.c_int
        if lib.tileio_version() == 1:
            _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def gather_batch(tiles: List[np.ndarray], out: Optional[np.ndarray] = None,
                 n_threads: int = 4) -> np.ndarray:
    """Gather tiles (each [H, W, C] or [H, W], all the same shape, float32
    or float16 sources) into one contiguous float32 batch [N, ...]."""
    n = len(tiles)
    first = tiles[0]
    shape = (n,) + first.shape
    if out is None:
        out = np.empty(shape, dtype=np.float32)
    if out.shape != shape or out.dtype != np.float32 or \
            not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"out must be a contiguous float32 {shape} array")
    if any(t.shape != first.shape for t in tiles):
        raise ValueError("tiles must all have the same shape")

    lib = get_lib()
    contiguous = all(t.flags["C_CONTIGUOUS"] for t in tiles)
    same_dtype = all(t.dtype == first.dtype for t in tiles)
    if lib is None or not contiguous or not same_dtype or \
            first.dtype not in (np.float32, np.float16):
        for i, t in enumerate(tiles):
            out[i] = t
        return out

    srcs = (ctypes.c_void_p * n)(*[t.ctypes.data for t in tiles])
    if first.dtype == np.float32:
        lib.gather_tiles(srcs, out.ctypes.data, first.nbytes, n, n_threads)
    else:  # float16 -> float32 widening gather
        lib.gather_tiles_f16_to_f32(
            srcs, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            first.size, n, n_threads)
    return out
