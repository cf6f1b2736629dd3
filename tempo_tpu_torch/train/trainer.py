"""Step-based trainer: the host loop around the train step; counterpart of
tempo_tpu/train/trainer.py (``Trainer``, single process).

The same loop and cadence: an infinite loader; EMA(0.99) metrics appended
to the history every log_every steps (the loop's only periodic host sync);
validation over n_val_batches every val_every steps, its sample-weighted
sums kept on the device until one fetch at the end; summary plots every
plot_every steps; a checkpoint every save_every steps (or at the steps of
``save_steps``) and always at the last step, each with a reconstruction
figure of the last batch's first 8 samples in figures/ when a ``recon_fn``
is given; metrics.json at the end; and samples/s over the loop's host wall
time. Multi-process runs, profiling windows, metric sinks and the L2
figures are not ported; the checkpoints are the single-file format
(train/checkpoint.py).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.train import checkpoint as ckpt_lib
from tempo_tpu_torch.train.metrics import save_metrics
from tempo_tpu_torch.train.plots import (save_reconstruction_figure,
                                          update_summary_plots)
from tempo_tpu_torch.train.state import Optimizer, TrainState
from tempo_tpu_torch.train.step import LossFn, make_eval_step, make_train_step


def to_device(batch, device: torch.device) -> torch.Tensor:
    """A host batch (numpy or tensor) on ``device``."""
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    return batch.to(device, non_blocking=True)


class Trainer:
    n_val_batches = 10  # validation batches per validation

    def __init__(
        self,
        loss_fn: LossFn,
        tx: Optimizer,
        state: TrainState,
        output_dir: Union[str, Path],
        save_every: int = 1000,
        val_every: int = 100,
        log_every: int = 10,
        plot_every: int = 50,
        verbose: bool = True,
        save_steps: Optional[Sequence[int]] = None,
        grad_accum: int = 1,
        device: Union[str, torch.device, None] = None,
        recon_fn: Optional[Callable[[nn.Module, torch.Tensor,
                                     torch.Generator], torch.Tensor]] = None,
    ):
        """``device`` (None: CUDA, raising without it) is where batches
        go; the state's model must be there. ``recon_fn(model, x,
        generator)`` reconstructs a batch for the figures (None: no
        figures)."""
        self.device = resolve_device(device)
        self.tx = tx
        self.state = state
        self.output_dir = Path(output_dir)
        self.save_every = save_every
        self.val_every = val_every
        self.log_every = log_every
        self.plot_every = plot_every
        self.verbose = verbose
        self.save_steps = set(save_steps) if save_steps is not None else None
        self.recon_fn = recon_fn
        self.ckpt_dir = self.output_dir / "checkpoints"
        self.summary_dir = self.output_dir / "summary"
        self.figures_dir = self.output_dir / "figures"
        for d in (self.ckpt_dir, self.summary_dir, self.figures_dir):
            d.mkdir(parents=True, exist_ok=True)
        self.loss_fn = loss_fn
        self.train_step = make_train_step(loss_fn, tx, grad_accum=grad_accum)
        self.eval_step = make_eval_step(loss_fn)
        self.eval_generator = torch.Generator(
            device=self.device).manual_seed(0)
        self.train_metrics: List[Dict] = []
        self.val_metrics: List[Dict] = []
        self.step = state.step

    # ------------------------------------------------------------------ io

    def save_checkpoint(self) -> Path:
        path = ckpt_lib.save_checkpoint(self.ckpt_dir, self.state,
                                        self.train_metrics, self.val_metrics)
        if self.verbose:
            print(f"Saved checkpoint: {path}")
        return path

    def load_checkpoint(self, path: Union[str, Path]) -> None:
        self.state, self.train_metrics, self.val_metrics = (
            ckpt_lib.load_checkpoint(path, self.state))
        self.step = self.state.step
        if self.verbose:
            print(f"Loaded checkpoint from step {self.step}")

    # ------------------------------------------------------------ validate

    def validate(self, val_iter: Iterator) -> Dict[str, float]:
        totals, n_samples = None, 0
        for i, batch in enumerate(val_iter):
            if i >= self.n_val_batches:
                break
            bsz = batch.shape[0]
            metrics = self.eval_step(self.state.model,
                                     to_device(batch, self.device),
                                     self.eval_generator)
            weighted = {k: v * float(bsz) for k, v in metrics.items()}
            totals = weighted if totals is None else {
                k: totals[k] + weighted[k] for k in totals}
            n_samples += bsz
        if n_samples == 0:
            return {}
        return {f"val_{k}": float(v) / n_samples for k, v in totals.items()}

    # -------------------------------------------------------------- figures

    def _save_recon_figure(self, batch) -> None:
        """The reconstruction figure of the batch's first 8 samples, the
        posterior sampled from a generator seeded with the step."""
        if self.recon_fn is None:
            return
        x = batch[:8]
        x = (x.float().cpu().numpy() if isinstance(x, torch.Tensor)
             else np.asarray(x, dtype=np.float32))
        generator = torch.Generator(device=self.device).manual_seed(
            self.step)
        with torch.no_grad():
            recon = self.recon_fn(self.state.model,
                                  to_device(x, self.device), generator)
        save_reconstruction_figure(self.figures_dir, self.step, x,
                                   recon.float().cpu().numpy())

    # ----------------------------------------------------------------- loop

    def train(self, train_iter: Iterator, val_iter_factory=None,
              n_steps: int = 10000) -> Dict[str, float]:
        """val_iter_factory: zero-argument callable returning a fresh
        validation iterator (or None). Returns the throughput stats."""
        t_start = time.perf_counter()
        samples_done = 0
        if self.state.ema is None:
            self.state.ema = {}  # the first step seeds every metric
        while self.step < n_steps:
            batch = next(train_iter)
            bsz = batch.shape[0]
            # no host sync per step: the device queue throttles the loop
            self.state, _ = self.train_step(self.state,
                                            to_device(batch, self.device))
            self.step += 1
            samples_done += bsz

            if self.step % self.log_every == 0:
                self._log_ema()
            if self.step % self.plot_every == 0:
                update_summary_plots(self.summary_dir, self.train_metrics,
                                     self.val_metrics)
            if val_iter_factory is not None and self.step % self.val_every == 0:
                vm = self.validate(val_iter_factory())
                if vm:
                    self.val_metrics.append({"step": self.step, **vm})
                    if self.verbose:
                        msg = ", ".join(f"{k}={v:.4f}" for k, v in vm.items())
                        print(f"Step {self.step}: {msg}")
            should_save = (self.step in self.save_steps
                           if self.save_steps is not None
                           else self.step % self.save_every == 0)
            if should_save or self.step == n_steps:
                self.save_checkpoint()
                self._save_recon_figure(batch)

        elapsed = time.perf_counter() - t_start
        save_metrics(self.output_dir, self.train_metrics, self.val_metrics)
        stats = {"elapsed_s": elapsed, "steps": self.step,
                 "samples": samples_done,
                 "samples_per_sec": samples_done / max(elapsed, 1e-9)}
        if self.verbose:
            print(f"Training complete: {stats}")
        return stats

    def _log_ema(self) -> None:
        keys = list(self.state.ema)
        values = torch.stack([self.state.ema[k] for k in keys]).tolist()
        self.train_metrics.append({"step": self.step,
                                   **dict(zip(keys, values))})
