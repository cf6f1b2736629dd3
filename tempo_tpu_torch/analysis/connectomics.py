"""Connectomics-style segmentation analysis: watershed cells, VI metrics,
error maps, smart-rescan planning and EM patch sampling; counterpart of
tempo_tpu/analysis/connectomics.py with the same results.

- The morphology (h-minima, watershed, dilations) runs on the device
  through ops/morphology.py: labels bitwise the JAX package's.
- ``membrane_prob`` pads to the UNet's stride multiple and runs one
  forward of the port's ``CUNet`` (nn/unet.py: its GroupNorms and 3x3
  convs through K1a/K1b/K2 on the card) and a sigmoid.
- The variation-of-information analysis (``vi``, ``vi_from_seg``'s
  scoring, ``error_map``'s bookkeeping) is host numpy, as in JAX.

Functions that compute on a device take ``device`` (None means CUDA,
raising without it; "cpu" asks for the CPU) and return numpy arrays.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.ops.morphology import dilate3x3, hmin, watershed

Device = Union[str, torch.device, None]

# ---------------------------------------------------------------------------
# segmentation


def get_seg(mb_prob: np.ndarray, mb_thres: int = 155, minsupp: int = 77,
            device: Device = None) -> np.ndarray:
    """Cell segmentation from a uint8-scale membrane-probability image:
    minima shallower than ``minsupp`` suppressed, watershed with lines,
    then 0 wherever the suppressed probability exceeds ``mb_thres``."""
    mb = np.asarray(mb_prob)
    if mb.ndim != 2:
        raise ValueError(f"mb_prob must be [H, W], got {mb.shape}")
    if mb.min() < 0 or int(mb.max()) + int(minsupp) >= 32768:
        raise ValueError("mb_prob + minsupp must stay below 32768 (the "
                         "watershed's integer headroom); pass uint8-scale "
                         "membrane probabilities")
    labels, _ = _seg_device(_on(mb, device), int(mb_thres), int(minsupp))
    return labels.cpu().numpy()


def _on(im: np.ndarray, device: Device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(im).astype(np.int32)).to(
        resolve_device(device))


def _seg_device(mb: torch.Tensor, mb_thres: int, minsupp: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    mb_hmin = hmin(mb, minsupp)
    labels = watershed(mb_hmin, lines=True)
    return torch.where(mb_hmin > mb_thres, torch.zeros_like(labels),
                       labels), mb_hmin


def relabel_consecutive(labels: np.ndarray) -> np.ndarray:
    """Map arbitrary nonneg label ids to consecutive 0..K (0 stays 0)."""
    labels = np.asarray(labels)
    ids = np.unique(labels)
    lut = np.zeros(ids.max() + 1, dtype=np.int32)
    lut[ids] = np.arange(len(ids), dtype=np.int32)
    out = lut[labels]
    if ids[0] != 0:  # no background present: shift to 1-based
        out += 1
    return out


# ---------------------------------------------------------------------------
# variation of information


def vi(labels: np.ndarray, labels_gt: np.ndarray):
    """Variation of information between two flat label arrays: (vi,
    vi_split = H(labels | labels_gt), vi_merge = H(labels_gt | labels),
    splitters [contribution, gt_label] and mergers [contribution,
    pred_label], each sorted descending)."""
    labels = np.asarray(labels).ravel()
    labels_gt = np.asarray(labels_gt).ravel()
    if labels.shape != labels_gt.shape:
        raise ValueError("label arrays must have equal size")
    n = labels.size
    a_ids, a_inv, a_cnt = np.unique(labels, return_inverse=True,
                                    return_counts=True)
    b_ids, b_inv, b_cnt = np.unique(labels_gt, return_inverse=True,
                                    return_counts=True)
    pair = a_inv.astype(np.int64) * len(b_ids) + b_inv
    pair_ids, pair_cnt = np.unique(pair, return_counts=True)
    i = (pair_ids // len(b_ids)).astype(np.int64)
    j = (pair_ids % len(b_ids)).astype(np.int64)

    p_ij = pair_cnt / n
    p_a = a_cnt / n
    p_b = b_cnt / n
    joint_ent = -p_ij * np.log(p_ij)  # per contingency cell

    split_each = np.zeros(len(b_ids))
    np.add.at(split_each, j, joint_ent)
    split_each += p_b * np.log(p_b)
    merge_each = np.zeros(len(a_ids))
    np.add.at(merge_each, i, joint_ent)
    merge_each += p_a * np.log(p_a)

    vi_split = float(split_each.sum())
    vi_merge = float(merge_each.sum())
    order_b = np.argsort(split_each)[::-1]
    order_a = np.argsort(merge_each)[::-1]
    splitters = np.stack([split_each[order_b],
                          b_ids[order_b].astype(np.float64)], axis=1)
    mergers = np.stack([merge_each[order_a],
                        a_ids[order_a].astype(np.float64)], axis=1)
    return vi_split + vi_merge, vi_split, vi_merge, splitters, mergers


def vi_from_seg(seg: np.ndarray, seg_gt: np.ndarray, gt_dilation: int = 5,
                device: Device = None):
    """VI over the pixels away from the ground-truth membrane (label 0
    dilated by a ``gt_dilation``-square: k 3x3 dilations make a
    (2k+1)-square)."""
    seg_gt = np.asarray(seg_gt)
    membrane = _on(seg_gt == 0, device)
    for _ in range(int(gt_dilation) // 2):
        membrane = dilate3x3(membrane)
    support = ~membrane.bool().cpu().numpy()
    return vi(np.asarray(seg)[support], seg_gt[support])


def error_map(fm_prob: np.ndarray, sm_prob: np.ndarray,
              mb_thres: int = 155, minsupp: int = 77,
              vi_thres: float = 1e-5, max_size: int = 200_000,
              rm_bounds: int = 5, mb_thres_low: int = 50,
              device: Device = None):
    """Disagreement map between a fast-scan and a slow-scan segmentation:
    both segmented on the device, VI over their joint interior support,
    then the pixels of every segment in a split, merge, miss or extra
    marked (dilated once). Returns (error_map uint8 0/255, vi, vi_split,
    vi_merge)."""
    fm_seg, fm_hmin = _seg_device(_on(fm_prob, device), mb_thres, minsupp)
    sm_seg, sm_hmin = _seg_device(_on(sm_prob, device), mb_thres, minsupp)
    fm_seg, sm_seg = fm_seg.cpu().numpy(), sm_seg.cpu().numpy()
    fm_hmin, sm_hmin = fm_hmin.cpu().numpy(), sm_hmin.cpu().numpy()

    miss_cand = np.unique(sm_seg[(sm_seg > 0) & (fm_seg == 0)])
    misses = miss_cand[~np.isin(miss_cand, sm_seg[fm_seg > 0])]
    extra_cand = np.unique(fm_seg[(fm_seg > 0) & (sm_seg == 0)])
    extras = extra_cand[~np.isin(extra_cand, fm_seg[sm_seg > 0])]

    def _toobig(seg):
        ids, cnt = np.unique(seg, return_counts=True)
        big = ids[(cnt > max_size) & (ids != 0)]
        return np.isin(seg, big)

    support = (fm_seg > 0) & (sm_seg > 0) & ~_toobig(fm_seg) & ~_toobig(sm_seg)
    if rm_bounds > 0:
        interior = _on(fm_seg > 0, device)
        for _ in range(rm_bounds // 2):
            interior = -dilate3x3(-interior)  # binary erosion
        support &= (interior.bool().cpu().numpy()
                    & (np.asarray(sm_prob) < mb_thres_low))

    total, vi_split, vi_merge, splitters, mergers = vi(
        fm_seg[support], sm_seg[support])

    i_splits = splitters[splitters[:, 0] > vi_thres, 1].astype(np.int64)
    i_merges = mergers[mergers[:, 0] > vi_thres, 1].astype(np.int64)
    err = np.zeros(fm_seg.shape, bool)
    err |= np.isin(sm_seg, i_splits) & (sm_hmin < mb_thres) & (fm_hmin > mb_thres)
    err |= np.isin(fm_seg, i_merges) & (sm_hmin > mb_thres) & (fm_hmin < mb_thres)
    err |= np.isin(sm_seg, misses) | np.isin(fm_seg, extras)
    err = dilate3x3(_on(err, device)).bool().cpu().numpy()
    return (err.astype(np.uint8) * 255), total, vi_split, vi_merge


# ---------------------------------------------------------------------------
# membrane inference + smart rescan


def membrane_prob(model: torch.nn.Module, em: np.ndarray, levels: int = 2,
                  return_dtype=np.uint8) -> np.ndarray:
    """Membrane probability of an [H, W] EM image from a one-logit net
    (the port's CUNet, on its device): integer images scaled to [0, 1],
    reflect-padded to a multiple of 2**levels, one forward, a sigmoid,
    cropped back; uint8 (x 255, clipped) or ``return_dtype``."""
    em = np.asarray(em)
    if np.issubdtype(em.dtype, np.integer):
        em = em.astype(np.float32) / np.iinfo(em.dtype).max
    h, w = em.shape
    s = 1 << levels
    ph, pw = (-h) % s, (-w) % s
    x = np.pad(em, ((0, ph), (0, pw)), mode="reflect")[None, ..., None]
    dev = next(model.parameters()).device
    with torch.no_grad():
        logits = model(torch.from_numpy(np.ascontiguousarray(
            x, np.float32)).to(dev))
        prob = torch.sigmoid(logits)[0, :h, :w, 0].cpu().numpy()
    if return_dtype == np.uint8:
        return np.clip(prob * 255.0, 0, 255).astype(np.uint8)
    return prob.astype(return_dtype)


def rescan_map(error_prob: np.ndarray, rescan_frac: float) -> np.ndarray:
    """Boolean mask of the ``rescan_frac`` most error-prone pixels (a
    direct quantile of the error probabilities)."""
    error_prob = np.asarray(error_prob, np.float32)
    if not 0.0 <= rescan_frac <= 1.0:
        raise ValueError(f"rescan_frac must be in [0, 1]: {rescan_frac}")
    if rescan_frac == 0.0:
        return np.zeros(error_prob.shape, bool)
    thr = np.quantile(error_prob, 1.0 - rescan_frac)
    return error_prob >= thr


def smart_rescan(fast_em: np.ndarray, slow_em: np.ndarray,
                 mask: np.ndarray) -> np.ndarray:
    """A mock acquisition: slow (high-quality) pixels where ``mask``, fast
    pixels elsewhere."""
    fast_em, slow_em = np.asarray(fast_em), np.asarray(slow_em)
    if fast_em.shape != slow_em.shape or fast_em.shape != np.shape(mask):
        raise ValueError("fast_em, slow_em and mask must share a shape")
    return np.where(np.asarray(mask, bool), slow_em, fast_em)


# ---------------------------------------------------------------------------
# data: EM patch sampling


def sample_patches(image: np.ndarray, mask: np.ndarray, n_samples: int,
                   patch_size: int = 256, seed: int = 0,
                   clahe_prob: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Random augmented (image, mask) patches from one EM section: uniform
    crops with flip-h / flip-v / rot90 applied to both, optional CLAHE on
    the image (cv2, imported when asked for); float32 [N, P, P] images in
    [0, 1] and uint8 masks. The draws are the JAX package's (numpy's
    default_rng(seed))."""
    image, mask = np.asarray(image), np.asarray(mask)
    if image.shape != mask.shape:
        raise ValueError("image and mask must share a shape")
    if min(image.shape) < patch_size:
        raise ValueError(f"patch_size {patch_size} exceeds image "
                         f"{image.shape}")
    rng = np.random.default_rng(seed)
    clahe = None
    if clahe_prob > 0.0:
        import cv2

        clahe = cv2.createCLAHE(clipLimit=3).apply

    ims = np.empty((n_samples, patch_size, patch_size), np.float32)
    mks = np.empty((n_samples, patch_size, patch_size), np.uint8)
    for k in range(n_samples):
        i = int(rng.integers(0, image.shape[0] - patch_size + 1))
        j = int(rng.integers(0, image.shape[1] - patch_size + 1))
        im = image[i:i + patch_size, j:j + patch_size]
        mk = mask[i:i + patch_size, j:j + patch_size]
        if clahe is not None and rng.random() < clahe_prob:
            im8 = (np.clip(im.astype(np.float32) /
                           (im.max() if im.max() > 0 else 1), 0, 1)
                   * 255).astype(np.uint8)
            im = clahe(im8)
        if rng.random() < 0.5:
            im, mk = im[::-1], mk[::-1]
        if rng.random() < 0.5:
            im, mk = im[:, ::-1], mk[:, ::-1]
        rot = int(rng.integers(0, 4))
        im, mk = np.rot90(im, rot), np.rot90(mk, rot)
        imf = im.astype(np.float32)
        if np.issubdtype(np.asarray(im).dtype, np.integer):
            imf /= np.iinfo(np.asarray(im).dtype).max
        ims[k], mks[k] = imf, mk.astype(np.uint8)
    return ims, mks


def color_mask(mask: np.ndarray,
               rgba: Tuple[float, float, float, float] = (1.0, 0.0, 1.0, 0.5)
               ) -> np.ndarray:
    """uint8 [H, W] mask -> float RGBA overlay."""
    return (np.asarray(mask, np.float32) / 255.0)[..., None] * \
        np.asarray(rgba, np.float32)
