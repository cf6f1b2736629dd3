"""Build and load the port's CUDA kernels.

The sources under ``tempo_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` (H100) into one shared library with a plain C interface, at first
use, and loaded with ``ctypes``. Each source compiles on its own ``nvcc``
process, all started together, then one link. The library lands in
``build/kernels/`` at the repository root (git-ignored), named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is loaded as it is. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FLASH_TAIL = [_P, _I, _I, _I, _I, _I, _F, _I, _P]  # strides .. stream
# C entry point -> argtypes; every entry point returns cudaGetLastError(),
# but tempo_flash_smem_bytes and tempo_gn_conv_smem_bytes, which return a
# size.
SIGNATURES = {
    "tempo_flash_smem_bytes": [_I, _I],
    "tempo_gn_conv_smem_bytes": [_I],
    "tempo_flash_fwd": [_P] * 5 + _FLASH_TAIL,
    "tempo_flash_bwd_dkv": [_P] * 8 + _FLASH_TAIL,
    "tempo_flash_bwd_dq": [_P] * 7 + _FLASH_TAIL,
    "tempo_gn_stats": [_P] * 4 + [_I] * 8 + [_F, _P],
    "tempo_gn_sums": [_P] * 4 + [_I] * 8 + [_P],
    "tempo_gn_apply": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "tempo_gn_conv3x3": [_P] * 8 + [_I] * 9 + [_P],
    "tempo_decode_split_len": [],
    "tempo_decode_attention": [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I,
                               _I, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""  # nvcc's output of the last build in this process


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda/bin/nvcc)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _compile(target: Path) -> str:
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=target.parent) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate()[0] for p in procs]
        failed = [src.name for src, p in zip(_sources(), procs) if p.returncode]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(so, target)  # atomic: a reader never sees half a library
    return "\n".join(logs) + link.stdout


def library() -> ctypes.CDLL:
    """The kernel library, built on first use in this checkout."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            target = BUILD_DIR / f"libtempo_kernels_{_digest()}.so"
            if not target.exists():
                build_log = _compile(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
