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
time. Batches are tensors or the L2 variant's dicts; with ``l2_products``
the per-product loss curves go to summary/l2_losses.png at every plot, and
the figures show each product's pooled target beside the head's
prediction. Options as the JAX trainer's: ``profile_steps`` (start, end)
traces the steps after ``start`` through ``end`` with torch.profiler (CPU
and, on the card, CUDA activities) into a Chrome trace under
output_dir/profile/; ``checkpoint_format`` 'msgpack' (the single-file
format, train/checkpoint.py: its name in the JAX package, a .pt here),
'async' (the same files, written by checkpoint.AsyncCheckpointer while
training goes on) or 'sharded' (``ckpt_step=NNNNNN.shards/`` directories
in the JAX package's format, each rank writing its own bytes:
train/sharded_checkpoint.py); ``metric_sinks`` are called as sink(step,
metrics, kind) with every EMA history entry ('train') and every
validation ('val').

Over a process group (parallel/mesh.py) every rank runs the loop on its
local batches: it steps, validates (the validation sums are added over
the ranks, so every rank holds the global means), reconstructs the
figures' batch and joins each save (train/checkpoint.py: rank 0 writes).
Only rank 0 prints and writes the logs, figures, plots, metric sinks,
profiles and metrics.json; samples/s counts the global batch.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn

from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.parallel.mesh import (all_reduce_sum_, barrier,
                                           is_primary, process_count)
from tempo_tpu_torch.train import checkpoint as ckpt_lib
from tempo_tpu_torch.train.metrics import save_metrics
from tempo_tpu_torch.train.plots import (plot_per_product_losses,
                                          save_reconstruction_figure,
                                          update_summary_plots)
from tempo_tpu_torch.train.state import Optimizer, TrainState
from tempo_tpu_torch.train.step import (LossFn, batch_size, make_eval_step,
                                        make_train_step)


def to_device(batch, device: torch.device):
    """A batch (numpy or tensor, or a dict of them) on ``device``; a
    tensor already there is used as it is, not copied."""
    if isinstance(batch, dict):
        return {k: to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    return batch.to(device, non_blocking=True)


def _host_f32(t) -> np.ndarray:
    """A tensor or array as fp32 numpy on the host."""
    if isinstance(t, torch.Tensor):
        return t.float().cpu().numpy()
    return np.asarray(t, dtype=np.float32)


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
                                     torch.Generator], Any]] = None,
        l2_products: Optional[Sequence[str]] = None,
        profile_steps: Optional[Tuple[int, int]] = None,
        checkpoint_format: str = "msgpack",
        metric_sinks: Optional[Sequence[Callable]] = None,
    ):
        """``device`` (None: CUDA, raising without it) is where batches
        go; the state's model must be there. ``recon_fn(model, x,
        generator)`` reconstructs a batch for the figures (None: no
        figures): a tensor, or a dict with ``reconstruction`` and
        ``l2_predictions`` ({product: [B, Hl, Wl]}). ``l2_products``: the
        products whose losses and targets the L2 plots and figures show.
        ``profile_steps``, ``checkpoint_format``, ``metric_sinks``: as the
        module says."""
        ckpt_lib.check_format(checkpoint_format)
        self.device = resolve_device(device)
        self.tx = tx
        self.state = state
        self.output_dir = Path(output_dir)
        self.save_every = save_every
        self.val_every = val_every
        self.log_every = log_every
        self.plot_every = plot_every
        self.primary = is_primary()
        self.verbose = verbose and self.primary
        self.save_steps = set(save_steps) if save_steps is not None else None
        self.recon_fn = recon_fn
        self.l2_products = list(l2_products) if l2_products else None
        self.profile_steps = (tuple(profile_steps) if profile_steps
                              else None)
        self._profiler = None
        self._async_ckpt = (ckpt_lib.AsyncCheckpointer()
                            if checkpoint_format == "async" else None)
        self.sharded_ckpt = checkpoint_format == "sharded"
        self.metric_sinks = list(metric_sinks or []) if self.primary else []
        self.ckpt_dir = self.output_dir / "checkpoints"
        self.summary_dir = self.output_dir / "summary"
        self.figures_dir = self.output_dir / "figures"
        if self.primary:
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
        from tempo_tpu_torch.train.sharded_checkpoint import (
            save_checkpoint_sharded)

        save = (self._async_ckpt.save if self._async_ckpt is not None
                else save_checkpoint_sharded if self.sharded_ckpt
                else ckpt_lib.save_checkpoint)
        path = save(self.ckpt_dir, self.state, self.train_metrics,
                    self.val_metrics)
        if self.verbose:
            print(f"Saved checkpoint: {path}")
        return path

    def load_checkpoint(self, path: Union[str, Path]) -> None:
        if self._async_ckpt is not None:
            self._async_ckpt.wait()  # never read a half-written file
        barrier()  # nor one that rank 0 is still writing
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
            bsz = batch_size(batch)
            metrics = self.eval_step(self.state.model,
                                     to_device(batch, self.device),
                                     self.eval_generator)
            weighted = {k: v * float(bsz) for k, v in metrics.items()}
            totals = weighted if totals is None else {
                k: totals[k] + weighted[k] for k in totals}
            n_samples += bsz
        if process_count() > 1:  # the global sums (every rank validates)
            keys = list(totals or {})
            summed = all_reduce_sum_(torch.stack(
                [totals[k] for k in keys]
                + [torch.tensor(float(n_samples), device=self.device)]))
            totals = dict(zip(keys, summed[:-1].unbind()))
            n_samples = float(summed[-1])
        if n_samples == 0:
            return {}
        return {f"val_{k}": float(v) / n_samples for k, v in totals.items()}

    # -------------------------------------------------------------- figures

    def _save_recon_figure(self, batch) -> None:
        """The reconstruction figure of the batch's first 8 samples, the
        posterior sampled from a generator seeded with the step; for a dict
        batch and a dict output, each product's 4x pooled target beside the
        head's prediction."""
        if self.recon_fn is None:
            return
        from tempo_tpu_torch.models.vae_l2 import avg_pool_4x_nan

        x = _host_f32((batch["spectral"] if isinstance(batch, dict)
                       else batch)[:8])
        generator = torch.Generator(device=self.device).manual_seed(
            self.step)
        with torch.no_grad():  # on every rank: a sharded model gathers
            out = self.recon_fn(self.state.model,
                                to_device(x, self.device), generator)
        if not self.primary:
            return
        if not isinstance(out, dict):
            save_reconstruction_figure(self.figures_dir, self.step, x,
                                       _host_f32(out))
            return
        preds = {p: _host_f32(v)
                 for p, v in out.get("l2_predictions", {}).items()}
        targets = None
        if isinstance(batch, dict) and self.l2_products:
            targets = {p: avg_pool_4x_nan(torch.from_numpy(
                _host_f32(batch[p][:8]))).numpy()
                for p in self.l2_products if p in batch}
        save_reconstruction_figure(self.figures_dir, self.step, x,
                                   _host_f32(out["reconstruction"]),
                                   l2_targets=targets, l2_preds=preds)

    # -------------------------------------------------------------- profile

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)  # the window's kernels end
        self._profiler.stop()
        out = self.output_dir / "profile"
        out.mkdir(parents=True, exist_ok=True)
        start, end = self.profile_steps
        self._profiler.export_chrome_trace(
            str(out / f"trace_steps_{start}-{end}.json"))
        self._profiler = None
        if self.verbose:
            print(f"Saved profiler trace to {out}")

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
            bsz = batch_size(batch)
            if (self.profile_steps and self.primary
                    and self.step == self.profile_steps[0]):
                self._start_profile()
            # no host sync per step: the device queue throttles the loop
            self.state, _ = self.train_step(self.state,
                                            to_device(batch, self.device))
            self.step += 1
            samples_done += bsz * process_count()
            if (self._profiler is not None
                    and self.step == self.profile_steps[1]):
                self._stop_profile()

            if self.step % self.log_every == 0:
                self._log_ema()
            if self.primary and self.step % self.plot_every == 0:
                update_summary_plots(self.summary_dir, self.train_metrics,
                                     self.val_metrics)
                if self.l2_products:
                    plot_per_product_losses(self.summary_dir,
                                            self.train_metrics,
                                            self.l2_products)
            if val_iter_factory is not None and self.step % self.val_every == 0:
                vm = self.validate(val_iter_factory())
                if vm:
                    self.val_metrics.append({"step": self.step, **vm})
                    self._emit(self.step, vm, "val")
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
        if self._profiler is not None:  # the run ended inside the window
            self._stop_profile()
        if self._async_ckpt is not None:
            # join the last write (and surface its error) before the run
            # reports completion: a resume or a sweep may read it at once
            self._async_ckpt.wait()
        barrier()  # every rank returns once rank 0's files are there
        if self.primary:
            save_metrics(self.output_dir, self.train_metrics,
                         self.val_metrics)
        stats = {"elapsed_s": elapsed, "steps": self.step,
                 "samples": samples_done,
                 "samples_per_sec": samples_done / max(elapsed, 1e-9)}
        if self.verbose:
            print(f"Training complete: {stats}")
        return stats

    def _log_ema(self) -> None:
        keys = list(self.state.ema)
        values = torch.stack([self.state.ema[k] for k in keys]).tolist()
        ema = dict(zip(keys, values))
        self.train_metrics.append({"step": self.step, **ema})
        self._emit(self.step, ema, "train")

    def _emit(self, step: int, metrics: Dict[str, float], kind: str) -> None:
        """Every sink gets the metrics in key order, as the JAX trainer's
        (its pytrees sort dict keys)."""
        metrics = dict(sorted(metrics.items()))
        for sink in self.metric_sinks:
            sink(step, metrics, kind)
