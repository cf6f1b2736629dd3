"""Checkpoint-sweep reconstruction evaluation; counterpart of
tempo_tpu/infer/sweep.py.

For each ckpt_step=* checkpoint of a run (the port's ``.pt`` and the JAX
package's ``.msgpack`` alike, through train/checkpoint.py ``load_params``),
the validation tiles go through
the model's reconstruct (the posterior sampled) in fixed batches, the tail
padded, and the per-sample MSE / MAE / PSNR (PSNR with max_val 20, the
[-10, 10] clipped z-score range), and optionally ``pk_err``, are reduced
on the model's device and averaged over the samples. The posterior draws
come from one torch.Generator seeded with ``seed`` per checkpoint (the JAX
package splits a key per batch; the two streams differ).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from tempo_tpu_torch.analysis.spectrum import PkOp, get_pk, pk_op
from tempo_tpu_torch.train.checkpoint import (checkpoint_step,
                                              list_checkpoints, load_params)

PSNR_MAX_VAL = 20.0  # data range [-10, 10] after clipping


def compute_metrics(gt, recon, metrics_list: Sequence[str],
                    sharding=None) -> Dict[str, float]:
    """Whole-array metrics in float64: numpy arrays on the host, tensors on
    their device (the same reductions, in another summation order). With
    a ``sharding`` (parallel/spatial.py) over several ranks, ``gt`` and
    ``recon`` are this rank's shares and the sums run over the ranks."""
    if sharding is not None and sharding.world > 1:
        return _sharded_metrics(gt, recon, metrics_list, sharding)
    if isinstance(gt, torch.Tensor):
        diff = gt.double() - recon.to(gt.device).double()
    else:
        diff = (np.asarray(gt, dtype=np.float64).ravel()
                - np.asarray(recon, dtype=np.float64).ravel())
    out: Dict[str, float] = {}
    for metric in metrics_list:
        if metric == "mse":
            out["mse"] = float((diff ** 2).mean())
        elif metric == "mae":
            out["mae"] = float(abs(diff).mean())
        elif metric == "psnr":
            mse = float((diff ** 2).mean())
            out["psnr"] = float(10 * np.log10(PSNR_MAX_VAL ** 2
                                              / (mse + 1e-10)))
    return out


def _sharded_metrics(gt: torch.Tensor, recon: torch.Tensor,
                     metrics_list: Sequence[str], sharding
                     ) -> Dict[str, float]:
    """``compute_metrics`` over W shares: float64 sums of squares and
    absolute values and the count, summed over the ranks."""
    from tempo_tpu_torch.parallel.spatial import all_reduce_sum

    diff = gt.double() - recon.to(gt.device).double()
    sums = torch.stack([diff.square().sum(), diff.abs().sum(),
                        torch.tensor(float(diff.numel()), dtype=torch.float64,
                                     device=diff.device)])
    sq, ab, n = all_reduce_sum(sums, sharding).tolist()
    mse = sq / n
    values = {"mse": mse, "mae": ab / n,
              "psnr": float(10 * np.log10(PSNR_MAX_VAL ** 2 / (mse + 1e-10)))}
    return {m: values[m] for m in metrics_list if m in values}


def batch_metrics(model, batch: torch.Tensor, generator: torch.Generator,
                  pk: Optional[PkOp] = None) -> Dict[str, torch.Tensor]:
    """Per-sample metrics [B] of one reconstructed batch, on its device;
    ``pk_err`` (mean |log10| ratio of the radial power spectra: blur that
    pixel MSE misses) when ``pk`` is given."""
    recon = model.reconstruct(batch, generator=generator,
                              sample_posterior=True)
    x, r = batch.float(), recon.float()
    dims = tuple(range(1, batch.ndim))
    diff = x - r
    mse = diff.square().mean(dim=dims)
    out = {"mse": mse, "mae": diff.abs().mean(dim=dims),
           "psnr": 10.0 * torch.log10(PSNR_MAX_VAL ** 2 / (mse + 1e-10))}
    if pk is not None:
        ratio = torch.log10((get_pk(r, pk) + 1e-12) / (get_pk(x, pk) + 1e-12))
        out["pk_err"] = ratio.abs().mean(dim=(1, 2))
    return out


@torch.inference_mode()
def evaluate_checkpoint(model, val_tiles, batch_size: int = 8,
                        metrics_list: Sequence[str] = ("mse", "mae", "psnr"),
                        seed: int = 42) -> Dict[str, float]:
    """val_tiles: [N, H, W, C] (numpy or a tensor). The sample-averaged
    metrics of ``model`` as it stands, on its device."""
    device = next(model.parameters()).device
    generator = torch.Generator(device=device).manual_seed(seed)
    pk = (pk_op(model.config.input_size, 2, device)
          if "pk_err" in metrics_list else None)
    tiles = torch.as_tensor(val_tiles)
    acc: Dict[str, List[torch.Tensor]] = {m: [] for m in metrics_list}
    for start in range(0, tiles.shape[0], batch_size):
        chunk = tiles[start:start + batch_size].to(device, torch.float32,
                                                   non_blocking=True)
        valid = chunk.shape[0]
        if valid < batch_size:  # one batch shape: the tail padded
            chunk = torch.cat([chunk, chunk[-1:].expand(
                batch_size - valid, *chunk.shape[1:])])
        out = batch_metrics(model, chunk, generator, pk)
        for m in metrics_list:
            acc[m].append(out[m][:valid])
    return {m: float(np.mean(torch.cat(v).double().cpu().numpy()))
            for m, v in acc.items()}


def evaluate_checkpoints(model, ckpt_dir: Union[str, Path], val_tiles,
                         batch_size: int = 8,
                         metrics_list: Sequence[str] = ("mse", "mae", "psnr"),
                         max_checkpoints: Optional[int] = None,
                         pattern: Optional[str] = None,
                         verbose: bool = True, seed: int = 42) -> List[Dict]:
    """Load every ckpt_step=* checkpoint of ``ckpt_dir`` (or those a glob
    ``pattern`` relative to it names) into ``model`` in turn and evaluate
    it; returns [{'checkpoint', 'step', <metrics>...}] sorted by step. The
    tiles are pinned in host memory once when the model is on CUDA."""
    if pattern is not None:
        paths = sorted(Path(ckpt_dir).glob(pattern), key=checkpoint_step)
    else:
        paths = list_checkpoints(ckpt_dir)
    if max_checkpoints is not None:
        paths = paths[:max_checkpoints]
    if not paths:
        raise ValueError(f"FATAL: no checkpoints found in {ckpt_dir}")
    tiles = torch.from_numpy(np.ascontiguousarray(val_tiles,
                                                  dtype=np.float32))
    if next(model.parameters()).device.type == "cuda":
        tiles = tiles.pin_memory()
    results = []
    for path in paths:
        load_params(path, model)
        metrics = evaluate_checkpoint(model, tiles, batch_size, metrics_list,
                                      seed)
        results.append({"checkpoint": path.name,
                        "step": checkpoint_step(path), **metrics})
        if verbose:
            print(f"{path.name}: {metrics}")
    return results
