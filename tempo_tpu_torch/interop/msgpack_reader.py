"""A pure-Python reader of the msgpack files that the JAX package's
checkpoints are (``flax.serialization.msgpack_serialize``); the counterpart
of ``flax.serialization.msgpack_restore``, needing neither msgpack nor
flax.

Reads every msgpack type: nil, bool, positive and negative fixint,
(u)int 8/16/32/64, float 32/64, fixstr and str 8/16/32 (UTF-8, as str),
bin 8/16/32 (as bytes), fixarray and array 16/32 (as lists), fixmap and
map 16/32 (as dicts), fixext 1/2/4/8/16 and ext 8/16/32. flax's ext codes:

- 1, an ndarray: a nested msgpack array (shape, dtype name, the C-order
  bytes), returned as a read-only numpy array over the file's buffer (no
  copy);
- 2, a complex number: a nested array (real, imag);
- 3, a numpy scalar: an ndarray of shape (), returned as its scalar.

Any other ext code comes back as ``ExtType(code, data)``. flax writes an
array of more than ``2**30`` bytes as a ``__msgpack_chunked_array__`` dict
of flat chunks; those are joined back into the array, as flax does.

numpy has no bfloat16 without ml_dtypes, which the GPU machine lacks: a
bfloat16 array or scalar is widened exactly to float32 (its 16 bits are the
float32's upper half: ``uint16 << 16``), the one place where this reader
differs from flax, which returns ``jnp.bfloat16``.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, NamedTuple, Union

import numpy as np

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class ExtType(NamedTuple):
    """An ext value of a code flax does not use."""

    code: int
    data: bytes


_FIXED = {  # type byte -> (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


class _Reader:
    """Decodes msgpack objects from a memoryview, advancing ``pos``; a bin
    payload is a slice of the view (``bin_views``) or a bytes copy."""

    def __init__(self, view: memoryview, bin_views: bool = False):
        self.view = view
        self.pos = 0
        self.bin_views = bin_views

    def _take(self, n: int) -> memoryview:
        start, self.pos = self.pos, self.pos + n
        if self.pos > len(self.view):
            raise ValueError("msgpack data ends inside an object")
        return self.view[start:self.pos]

    def _length(self, size: int) -> int:
        return struct.unpack(_LENGTH[size], self._take(size))[0]

    def read(self) -> Any:
        b = self._take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self._take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, size = _FIXED[b]
            return struct.unpack(fmt, self._take(size))[0]
        if b in _STR:
            return str(self._take(self._length(_STR[b])), "utf-8")
        if b in _BIN:
            data = self._take(self._length(_BIN[b]))
            return data if self.bin_views else bytes(data)
        if b in _ARRAY:
            return [self.read() for _ in range(self._length(_ARRAY[b]))]
        if b in _MAP:
            return self._map(self._length(_MAP[b]))
        if b in _FIXEXT:
            code = struct.unpack(">b", self._take(1))[0]
            return _ext(code, self._take(_FIXEXT[b]))
        if b in _EXT:
            n = self._length(_EXT[b])
            code = struct.unpack(">b", self._take(1))[0]
            return _ext(code, self._take(n))
        raise ValueError(f"0x{b:02x} is not a msgpack type byte")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out


def _whole(view: memoryview, bin_views: bool = False) -> Any:
    reader = _Reader(view, bin_views)
    obj = reader.read()
    if reader.pos != len(view):
        raise ValueError(f"{len(view) - reader.pos} bytes after the msgpack "
                         f"object")
    return obj


def _ndarray(data: memoryview) -> np.ndarray:
    """flax's (shape, dtype name, C-order bytes) as an array over ``data``
    (bfloat16 widened to float32)."""
    shape, name, buf = _whole(data, bin_views=True)
    name = name.decode() if isinstance(name, (bytes, memoryview)) else name
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.uint16).astype(np.uint32) << 16
        arr = bits.view(np.float32)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(name))
    return arr.reshape(tuple(shape), order="C")


def _ext(code: int, data: memoryview) -> Any:
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_COMPLEX:
        real, imag = _whole(data)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray(data)[()]
    return ExtType(code, bytes(data))


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    return np.concatenate(chunks).reshape(shape)


def _unchunk_leaves(d: Any) -> Any:
    """Join chunked arrays wherever flax does: the top level and dict
    values, at any depth of dicts."""
    if isinstance(d, dict):
        if CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk_leaves(v)
    return d


def restore(data: Union[bytes, bytearray, memoryview]) -> Any:
    """The tree that ``flax.serialization.msgpack_restore(data)`` gives
    (bfloat16 widened to float32); arrays are views of ``data``."""
    return _unchunk_leaves(_whole(memoryview(data)))


def read(path: Union[str, Path]) -> Any:
    """``restore`` of a file's bytes."""
    return restore(Path(path).read_bytes())
