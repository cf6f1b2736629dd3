"""Async host-side shuffle-buffer tile loader; the port's copy of
tempo_tpu/data/loader.py (numpy and threads; the JAX package's ``data``
package imports JAX, so the port keeps its own copy).

An infinite stream backed by a RandomBuffer: the buffer is pre-filled to
min_buffer_size from randomly chosen shard files, each sample pops a
uniformly random buffer element, and the buffer refills from random files
whenever it drops below the minimum. Shard reads run on background threads
(numpy .npy loads release the GIL during disk IO), batches are gathered
into contiguous float32 NHWC arrays (data/native.py), and a small prefetch
queue keeps batch assembly overlapped with the device's step. The same
seed gives the same draws as the JAX package's loader.
"""

from __future__ import annotations

import glob
import queue
import threading
import time
from pathlib import Path
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np
import torch

from tempo_tpu_torch.data.native import gather_batch
from tempo_tpu_torch.data.tiles import find_l2_shard, load_tile_shard


def _find_shards(data_dir: Union[str, Path]) -> List[str]:
    data_dir = Path(data_dir)
    files = sorted(glob.glob(str(data_dir / "*.npy")))
    if not files:
        files = sorted(glob.glob(str(data_dir / "*.pt")))
    if not files:
        raise ValueError(f"No .npy or .pt shard files found in {data_dir}")
    return files


class RandomBuffer:
    """List-backed random-pop buffer. Pop is O(1) via swap-with-last (order
    never matters)."""

    def __init__(self, rng: np.random.Generator):
        self._items: list = []
        self._rng = rng

    def put(self, item) -> None:
        self._items.append(item)

    def get(self):
        if not self._items:
            raise IndexError("Buffer is empty")
        idx = int(self._rng.integers(0, len(self._items)))
        self._items[idx], self._items[-1] = self._items[-1], self._items[idx]
        return self._items.pop()

    def __len__(self) -> int:
        return len(self._items)


class TileLoader:
    """Infinite batched stream of TEMPO tiles (optionally with L2 products).

    Yields [B, H, W, C] float32 arrays, or dicts
    {'spectral': [B,H,W,C], '<PRODUCT>': [B,H,W]} when l2_products is given
    (L2 shards live in l2_<PRODUCT>/ subdirectories next to the spectral
    shards, mirroring the reference layout).
    """

    def __init__(
        self,
        data_dir: Union[str, Path],
        batch_size: int = 32,
        min_buffer_size: int = 200,
        l2_products: Optional[Sequence[str]] = None,
        seed: Optional[int] = None,
        prefetch: int = 2,
        num_threads: int = 2,
        verbose: bool = False,
    ):
        self.data_dir = Path(data_dir)
        self.batch_size = batch_size
        self.min_buffer_size = min_buffer_size
        self.l2_products = list(l2_products) if l2_products else None
        self.prefetch = prefetch
        self.num_threads = num_threads
        self.verbose = verbose

        self.files = _find_shards(self.data_dir)
        if self.l2_products:
            self.l2_dirs = {}
            for product in self.l2_products:
                l2_dir = self.data_dir / f"l2_{product}"
                if not l2_dir.exists():
                    raise FileNotFoundError(
                        f"FATAL: L2 directory not found: {l2_dir}")
                self.l2_dirs[product] = l2_dir

        self._rng = np.random.default_rng(seed)
        self._last_error: Optional[str] = None
        self._buffer = RandomBuffer(self._rng)
        self._lock = threading.Lock()
        self._fill_sem = threading.Semaphore(0)
        self._stop = threading.Event()
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._threads: List[threading.Thread] = []

        self._initial_fill()
        self._start_workers()

    # ------------------------------------------------------------- loading

    def _load_file_items(self, file_idx: int) -> list:
        # Memory-mapped shards: buffer items are page-cache VIEWS; the copy
        # happens once, at batch-gather time, in the native multi-threaded
        # gather (data/native.py).
        spectral_path = self.files[file_idx]
        spectral = load_tile_shard(spectral_path, mmap=True)
        if spectral.ndim == 3:
            spectral = spectral[None]
        if self.l2_products is None:
            return list(spectral)

        name = Path(spectral_path).name
        l2_batches = {}
        for product in self.l2_products:
            l2_path = find_l2_shard(self.l2_dirs[product], name)
            l2_batches[product] = load_tile_shard(l2_path, mmap=True)

        items = []
        for t in range(spectral.shape[0]):
            item = {"spectral": spectral[t]}
            for product in self.l2_products:
                item[product] = l2_batches[product][t]
            items.append(item)
        return items

    def _initial_fill(self) -> None:
        while len(self._buffer) < self.min_buffer_size:
            idx = int(self._rng.integers(0, len(self.files)))
            for item in self._load_file_items(idx):
                self._buffer.put(item)
        if self.verbose:
            print(f"Loaded initial buffer ({len(self._buffer)} tiles) from "
                  f"{len(self.files)} shard files in {self.data_dir}")

    def _refill_loop(self) -> None:
        while not self._stop.is_set():
            self._fill_sem.acquire()
            if self._stop.is_set():
                return
            try:
                idx = int(self._rng.integers(0, len(self.files)))
                items = self._load_file_items(idx)  # disk IO off main thread
            except Exception as exc:  # record and keep serving
                self._last_error = f"refill: {type(exc).__name__}: {exc}"
                continue
            with self._lock:
                for item in items:
                    self._buffer.put(item)

    def _sample_batch(self):
        samples = []
        with self._lock:
            try:
                for _ in range(self.batch_size):
                    samples.append(self._buffer.get())
            except IndexError:
                # transiently short: put the partial pop back, retry later
                for item in samples:
                    self._buffer.put(item)
                raise
            deficit = self.min_buffer_size - len(self._buffer)
        if deficit > 0:
            # one refill request per (roughly) shard-sized deficit
            tiles_per_file = max(1, len(samples))
            for _ in range(max(1, deficit // tiles_per_file)):
                self._fill_sem.release()

        if self.l2_products is None:
            return gather_batch(samples, n_threads=self.num_threads + 2)
        batch = {"spectral": gather_batch([s["spectral"] for s in samples],
                                          n_threads=self.num_threads + 2)}
        for product in self.l2_products:
            batch[product] = gather_batch([s[product] for s in samples],
                                          n_threads=self.num_threads + 2)
        return batch

    def _batch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                batch = self._sample_batch()
            except IndexError:
                # buffer transiently exhausted; force refills, yield the
                # core to them, and retry
                self._fill_sem.release()
                time.sleep(0.05)
                continue
            except Exception as exc:
                self._last_error = f"batch: {type(exc).__name__}: {exc}"
                time.sleep(0.5)
                continue
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def _start_workers(self) -> None:
        for i in range(self.num_threads):
            t = threading.Thread(target=self._refill_loop, daemon=True,
                                 name=f"tile-refill-{i}")
            t.start()
            self._threads.append(t)
        t = threading.Thread(target=self._batch_loop, daemon=True,
                             name="tile-batch")
        t.start()
        self._threads.append(t)

    # ------------------------------------------------------------ interface

    def __iter__(self) -> Iterator:
        return self

    def __next__(self, _deadline_s: float = 300.0):
        # Patient stall detection: a saturated host can legitimately starve
        # the batch thread for tens of seconds; only give up after the full
        # deadline or if the workers died.
        waited = 0.0
        while True:
            try:
                return self._queue.get(timeout=10.0)
            except queue.Empty:
                if self._stop.is_set():
                    raise StopIteration
                waited += 10.0
                workers_alive = any(t.is_alive() for t in self._threads)
                if waited >= _deadline_s or not workers_alive:
                    with self._lock:
                        buffered = len(self._buffer)
                    raise RuntimeError(
                        f"TileLoader stalled: no batch for {waited:.0f}s "
                        f"(workers alive: {workers_alive}, buffered tiles: "
                        f"{buffered}, last error: {self._last_error})")

    def close(self) -> None:
        self._stop.set()
        for _ in self._threads:
            self._fill_sem.release()

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def load_normalization_stats(stats_dir: Union[str, Path]):
    """Load (mean_spectrum, std_spectrum) from a stats/tiles directory.
    Accepts native .npy and reference .pt files."""
    stats_dir = Path(stats_dir)
    out = []
    for stem in ("mean_spectrum", "std_spectrum"):
        candidates = [stats_dir / f"{stem}.npy", stats_dir / f"{stem}.pt",
                      stats_dir / f"tempo_{stem}.npy", stats_dir / f"tempo_{stem}.pt"]
        path = next((p for p in candidates if p.exists()), None)
        if path is None:
            raise FileNotFoundError(
                f"Normalization stats not found for '{stem}' in {stats_dir}")
        if path.suffix == ".npy":
            out.append(np.load(path))
        else:
            out.append(torch.load(path, weights_only=True).numpy())
    return tuple(np.asarray(a, dtype=np.float32) for a in out)
