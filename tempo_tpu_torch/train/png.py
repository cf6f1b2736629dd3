"""Plain PNG figures from numpy, for where matplotlib is absent (the
GPU machine has none): curves drawn as polylines on a white canvas, bars,
and grids of image panels. No labels or text; train/plots.py and
utils/figures.py use them only when ``import matplotlib`` fails, so that a
training or analysis run writes every artifact on such a host."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

# series colors (matplotlib's first eight)
COLORS = np.array([[31, 119, 180], [255, 127, 14], [44, 160, 44],
                   [214, 39, 40], [148, 103, 189], [140, 86, 75],
                   [227, 119, 194], [127, 127, 127]], dtype=np.uint8)
# viridis at five stops, interpolated linearly between them
VIRIDIS = np.array([[68, 1, 84], [59, 82, 139], [33, 145, 140],
                    [94, 201, 98], [253, 231, 37]], dtype=np.float64)
CURVE_SIZE = (360, 600)   # (height, width) of a curve panel
PANEL = 128               # side of an image panel
GUTTER = 4
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_png(path: Union[str, Path], rgb: np.ndarray) -> Path:
    """[H, W, 3] uint8 -> an 8-bit RGB PNG file."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(PNG_SIGNATURE
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0,
                                                  0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, 6))
                     + chunk(b"IEND", b""))
    return path


def curves(series: Dict[str, Tuple[Sequence[float], Sequence[float]]],
           log_scale: bool = False,
           size: Tuple[int, int] = CURVE_SIZE) -> np.ndarray:
    """[H, W, 3] uint8: each (x, y) series as a polyline in its color over
    the common finite range (log10 of both axes when ``log_scale``)."""
    h, w = size
    img = np.full((h, w, 3), 255, dtype=np.uint8)
    img[[0, -1], :] = 0  # frame
    img[:, [0, -1]] = 0
    pts = []
    for x, y in series.values():
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if log_scale:
            with np.errstate(divide="ignore", invalid="ignore"):
                x, y = np.log10(x), np.log10(y)
        keep = np.isfinite(x) & np.isfinite(y)
        pts.append((x[keep], y[keep]))
    xs = np.concatenate([p[0] for p in pts] + [np.zeros(0)])
    ys = np.concatenate([p[1] for p in pts] + [np.zeros(0)])
    if xs.size == 0:
        return img
    x0, x1 = xs.min(), max(xs.max(), xs.min() + 1e-12)
    y0, y1 = ys.min(), max(ys.max(), ys.min() + 1e-12)
    for k, (x, y) in enumerate(pts):
        if x.size == 0:
            continue
        # sample the polyline densely, one point a pixel of its length
        px = 4 + (x - x0) / (x1 - x0) * (w - 9)
        py = h - 5 - (y - y0) / (y1 - y0) * (h - 9)
        n = max(2, int(np.abs(np.diff(px)).sum() + np.abs(np.diff(py)).sum())
                + 1)
        t = np.linspace(0, len(px) - 1, n)
        cx = np.interp(t, np.arange(len(px)), px).round().astype(int)
        cy = np.interp(t, np.arange(len(py)), py).round().astype(int)
        for dy in (0, 1):
            img[np.clip(cy + dy, 0, h - 1), np.clip(cx, 0, w - 1)] = \
                COLORS[k % len(COLORS)]
    return img


def bars(values: Sequence[float],
         size: Tuple[int, int] = CURVE_SIZE) -> np.ndarray:
    """[H, W, 3] uint8: one column a value, from the lower of 0 and the
    least value up to each value (non-finite values draw nothing)."""
    h, w = size
    img = np.full((h, w, 3), 255, dtype=np.uint8)
    img[[0, -1], :] = 0  # frame
    img[:, [0, -1]] = 0
    v = np.asarray(values, np.float64)
    finite = v[np.isfinite(v)]
    if finite.size == 0:
        return img
    lo, hi = min(finite.min(), 0.0), max(finite.max(), 0.0)
    span = max(hi - lo, 1e-12)
    step = (w - 8) / len(v)
    y0 = h - 5 - int(round((0.0 - lo) / span * (h - 9)))
    for i, x in enumerate(v):
        if not np.isfinite(x):
            continue
        y1 = h - 5 - int(round((x - lo) / span * (h - 9)))
        a, b = sorted((y0, y1))
        left = 4 + int(i * step + 0.1 * step)
        right = max(left + 1, 4 + int((i + 1) * step - 0.1 * step))
        img[a:b + 1, left:right] = COLORS[0]
    return img


def colorize(a: np.ndarray, cmap: Optional[str] = None,
             vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> np.ndarray:
    """[H, W] (or [H, W, 3] in [0, 1]) -> [H, W, 3] uint8: grayscale,
    ``hot`` (black-red-yellow-white) or ``viridis``, scaled to [vmin, vmax]
    (the finite range by default); NaN is white."""
    a = np.asarray(a, np.float64)
    if a.ndim == 3:
        return (np.clip(a, 0, 1) * 255).round().astype(np.uint8)
    finite = a[np.isfinite(a)]
    lo = vmin if vmin is not None else (finite.min() if finite.size else 0.0)
    hi = vmax if vmax is not None else (finite.max() if finite.size else 1.0)
    t = np.nan_to_num(np.clip((a - lo) / max(hi - lo, 1e-12), 0, 1))
    if cmap == "viridis":
        pos = t * (len(VIRIDIS) - 1)
        i = np.minimum(pos.astype(int), len(VIRIDIS) - 2)
        f = (pos - i)[..., None]
        rgb = VIRIDIS[i] * (1 - f) + VIRIDIS[i + 1] * f
    elif cmap == "hot":
        rgb = 255 * np.stack([np.clip(3 * t, 0, 1), np.clip(3 * t - 1, 0, 1),
                              np.clip(3 * t - 2, 0, 1)], axis=-1)
    else:
        rgb = 255 * np.repeat(t[..., None], 3, axis=-1)
    rgb = np.where(np.isnan(a)[..., None], 255, rgb)
    return rgb.round().astype(np.uint8)


def grid(rows: List[List[np.ndarray]], side: int = PANEL) -> np.ndarray:
    """Panels ([h, w, 3] uint8) resized to side x side by nearest neighbour
    and tiled row by row on a white canvas."""
    n_cols = max(len(r) for r in rows)
    step = side + GUTTER
    img = np.full((len(rows) * step + GUTTER, n_cols * step + GUTTER, 3),
                  255, dtype=np.uint8)
    for i, row in enumerate(rows):
        for j, panel in enumerate(row):
            ph, pw = panel.shape[:2]
            yi = np.arange(side) * ph // side
            xi = np.arange(side) * pw // side
            y, x = GUTTER + i * step, GUTTER + j * step
            img[y:y + side, x:x + side] = panel[yi][:, xi]
    return img
