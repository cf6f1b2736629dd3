"""Grayscale morphology and watershed on integer images, in torch;
counterpart of tempo_tpu/ops/morphology.py with bitwise the same results.

Every primitive is a data-parallel 3x3 stencil, iterated to a fixpoint
where the JAX package iterates under ``lax.while_loop``:

- erosion / dilation: the minimum (maximum) of the nine shifted views of
  the image padded with INT_MAX (INT_MIN): exact on int32, where a float
  window op would round values past 2^24 and ``-max_pool(-x)`` overflows
  at INT_MIN;
- reconstruction by erosion, ``hmin``, ``regional_minima``;
- ``label_components``: min-label propagation (8-connected), labels the
  minimum linear index of each component plus 1;
- ``watershed``: regional minima, their labels, plateau lower completion
  (``f * 65536 + geodesic distance``), steepest-descent pointers with ties
  broken toward the smallest linear index, pointer doubling, and optional
  watershed lines (the larger label of two adjacent basins gives way).

The fixpoint loop runs on the tensors' device and reads one flag back
every ``CHECK_EVERY`` steps (a reached fixpoint stays put, so the extra
steps change nothing): O(diameter / CHECK_EVERY) host round trips instead
of one a step. ``STEPS["fixpoint"]`` counts the steps run. Inputs are
treated as integer-valued (cast to int32); the lower-completion encoding
needs values < 32768 and plateau diameters < 65536 (checked by
analysis/connectomics.py).
"""

from __future__ import annotations

from typing import Callable

import torch

C = 65536  # lower-completion stride: one slot per geodesic-distance step
INT_MAX = 2 ** 31 - 1
INT_MIN = -2 ** 31
CHECK_EVERY = 16
STEPS = {"fixpoint": 0}


def _int32(im) -> torch.Tensor:
    return torch.as_tensor(im).to(torch.int32)


def _padded(arr: torch.Tensor, fill: int) -> torch.Tensor:
    h, w = arr.shape
    p = torch.full((h + 2, w + 2), fill, dtype=arr.dtype, device=arr.device)
    p[1:-1, 1:-1] = arr
    return p


def _shift_stack(arr: torch.Tensor, fill: int) -> torch.Tensor:
    """[9, H, W]: the 8-neighborhood and the center (index 4), row-major
    over the 3x3 window, out-of-image entries ``fill``."""
    h, w = arr.shape
    p = _padded(arr, fill)
    return torch.stack([p[di:di + h, dj:dj + w]
                        for di in range(3) for dj in range(3)])


def _window(im: torch.Tensor, fill: int, op) -> torch.Tensor:
    h, w = im.shape
    p = _padded(im, fill)
    out = p[0:h, 0:w]
    for di in range(3):
        for dj in range(3):
            if di or dj:
                out = op(out, p[di:di + h, dj:dj + w])
    return out


def erode3x3(im) -> torch.Tensor:
    """8-connected grayscale erosion; out-of-image treated as +inf."""
    return _window(_int32(im), INT_MAX, torch.minimum)


def dilate3x3(im) -> torch.Tensor:
    """8-connected grayscale dilation; out-of-image treated as -inf."""
    return _window(_int32(im), INT_MIN, torch.maximum)


def _fixpoint(step_fn: Callable[[torch.Tensor], torch.Tensor],
              x: torch.Tensor) -> torch.Tensor:
    """Iterate ``x = step_fn(x)`` until nothing changes, checking every
    CHECK_EVERY steps."""
    while True:
        for _ in range(CHECK_EVERY - 1):
            x = step_fn(x)
        new = step_fn(x)
        STEPS["fixpoint"] += CHECK_EVERY
        if torch.equal(new, x):
            return new
        x = new


def reconstruct_by_erosion(marker, mask) -> torch.Tensor:
    """Grayscale reconstruction by erosion of ``marker`` above ``mask``
    (marker >= mask): the smallest image >= mask reachable from marker by
    repeated conditional erosion."""
    mask = _int32(mask)
    return _fixpoint(lambda m: torch.maximum(erode3x3(m), mask),
                     _int32(marker).to(mask.device))


def hmin(im, h: int) -> torch.Tensor:
    """H-minima transform: regional minima of depth < h suppressed."""
    im = _int32(im)
    return reconstruct_by_erosion(im + int(h), im)


def regional_minima(im) -> torch.Tensor:
    """Boolean mask of regional-minimum plateaus (8-connectivity)."""
    im = _int32(im)
    return reconstruct_by_erosion(im + 1, im) > im


def label_components(mask) -> torch.Tensor:
    """8-connected component labels of a boolean mask: each masked pixel
    gets the minimum linear index of its component plus 1, the rest 0
    (deterministic, not consecutive)."""
    mask = torch.as_tensor(mask).bool()
    h, w = mask.shape
    idx = torch.arange(h * w, dtype=torch.int32,
                       device=mask.device).reshape(h, w)
    big = torch.full((), INT_MAX, dtype=torch.int32, device=mask.device)
    lab = torch.where(mask, idx, big)

    def step(lab):
        nb = _shift_stack(lab, INT_MAX).amin(dim=0)
        return torch.where(mask, torch.minimum(lab, nb), big)

    lab = _fixpoint(step, lab)
    return torch.where(mask, lab + 1, torch.zeros_like(lab))


def _lower_complete(im: torch.Tensor, minima: torch.Tensor) -> torch.Tensor:
    """Lower completion: every non-minimum pixel gets a strictly lower
    neighbor, the geodesic plateau distance stacked under the value."""
    half = INT_MAX // 2
    nb_min = _shift_stack(im, INT_MAX)
    nb_min[4] = INT_MAX  # exclude the center
    lower = nb_min.amin(dim=0) < im
    fixed = lower | minima
    zero = torch.zeros((), dtype=torch.int32, device=im.device)
    far = torch.full((), half, dtype=torch.int32, device=im.device)
    dist = torch.where(fixed, zero, far)
    same = _shift_stack(im, -1) == im[None]

    def step(dist):
        cand = torch.where(same, _shift_stack(dist, half), far).amin(
            dim=0) + 1
        return torch.where(fixed, zero, torch.minimum(dist, cand))

    dist = _fixpoint(step, dist)
    dist = torch.where(minima, zero, torch.clamp(dist + 1, max=C - 1))
    return im * C + dist


def watershed(im, lines: bool = True) -> torch.Tensor:
    """Watershed segmentation of an integer-valued [H, W] image: each
    regional minimum seeds a basin; each pixel joins the basin its
    steepest-descent path on the lower-completed image ends in. With
    ``lines``, of two 8-adjacent pixels of different basins the one with
    the larger label becomes 0. Returns int32 labels (0 = line, > 0 the
    minima's component labels)."""
    im = _int32(im)
    h, w = im.shape
    minima = regional_minima(im)
    seeds = label_components(minima)
    flc = _lower_complete(im, minima)

    idx = torch.arange(h * w, dtype=torch.int32,
                       device=im.device).reshape(h, w)
    nb_v = _shift_stack(flc, INT_MAX)
    nb_i = _shift_stack(idx, 0)
    best = nb_v.amin(dim=0)
    big = torch.full((), INT_MAX, dtype=torch.int32, device=im.device)
    ptr2d = torch.where(nb_v == best[None], nb_i, big).amin(dim=0)
    ptr = torch.where(minima, idx, ptr2d).reshape(-1).long()
    for _ in range(max(1, (h * w - 1).bit_length())):
        ptr = ptr[ptr]
    labels = seeds.reshape(-1)[ptr].reshape(h, w)

    if lines:
        nb_l = _shift_stack(labels, 0)
        smaller = torch.where((nb_l > 0) & (nb_l != labels[None]), nb_l,
                              big).amin(dim=0)
        labels = torch.where(smaller < labels, torch.zeros_like(labels),
                             labels)
    return labels
