"""Device-resident shuffle buffer of tile shards; counterpart of
tempo_tpu/data/device_buffer.py ``DeviceTileBuffer`` (one device).

Whole shards live on the device as a [slots, tiles, H, W, C] pool in the
buffer's type (float16 halves it), and each batch is one device gather of
random (slot, tile) pairs (``index_select`` over the flattened pool). With
``l2_products`` the pool also holds ``<PRODUCT>``: [slots, tiles, H, W] in
fp32 and each gather yields the dict batches the L2-supervised trainer
consumes, every value gathered at the same pairs. The JAX module stores the
L2 fields in the buffer's type too; the port keeps them fp32, the type
the loss reads them in (so with a float16 pool its L2 values are JAX's
rounded to float16 only on JAX's side).

Every ``swap_every`` batches the least recently refreshed slot is replaced
by a shard drawn at random: a background thread reads it into pinned host
memory and copies it to a one-shard staging tensor on a side CUDA stream;
the main stream waits on that copy's event, then copies the staging tensor
into the slot in place, after every gather queued before it. The side
stream's next copy waits for that replace. So the pool is never held
twice, and a gather never reads a slot while it changes.

Draws: the gather indices come from ``np.random.default_rng(seed)`` and the
shards (the first fill and each swap) from ``default_rng(seed + 7919)``,
as in the JAX module. With a seed, the swap started at one interval's end
is joined and applied at the next, so the batch stream is a function of
the seed alone and equals the JAX module's for it. Without one, a finished
swap is applied at the next batch and none waits.

``device=None`` is CUDA (raising without it); ``device='cpu'`` runs the
same schedule synchronously, with no thread or stream, for tests.

Data parallelism (a ``mesh`` of W > 1 processes, parallel/mesh.py; a
``BatchShard`` names one rank of W directly) follows the JAX module's
multi-process semantics with one process per device:
``partition='replicate'`` (default): every rank holds the whole pool,
draws the same global indices from the shared seed (``batch_size`` is the
global batch) and gathers its contiguous slice of them, rows
[rank B/W, (rank+1) B/W); the slices side by side are the JAX module's
batch. ``partition='process'``: rank r owns ``files[r::W]``, draws its
indices from ``default_rng(seed + 1_000_003 r)`` and its shards from
``default_rng(seed + 7919 + 1_000_003 r)``, and gathers its local batch,
``batch_size // W``, from its own pool. One process (or no mesh) is the
one-device buffer under either partition, as JAX's single process. Under
a ('data', 'model') mesh (tensor parallelism, parallel/tensor.py) W and
r are the data axis's: the model-axis peers of a data row hold the same
pool and gather the same rows.
"""

from __future__ import annotations

import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from tempo_tpu_torch.data.loader import _find_shards
from tempo_tpu_torch.data.tiles import find_l2_shard, load_tile_shard
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.parallel.mesh import batch_sharding

DTYPES = {"float32": (np.float32, torch.float32),
          "float16": (np.float16, torch.float16)}
SWAP_SEED_OFFSET = 7919
RANK_SEED_STRIDE = 1_000_003


class DeviceTileBuffer:
    """Infinite batched stream of tiles gathered on the device: [B, H, W, C]
    tensors, or {'spectral': [B,H,W,C], '<PRODUCT>': [B,H,W]} dicts when
    ``l2_products`` is given."""

    def __init__(
        self,
        data_dir: Union[str, Path],
        batch_size: int = 64,
        slots: int = 4,
        swap_every: int = 16,
        seed: Optional[int] = None,
        dtype: str = "float32",
        device: Union[str, torch.device, None] = None,
        mesh=None,
        l2_products: Optional[Sequence[str]] = None,
        partition: str = "replicate",
    ):
        if partition not in ("replicate", "process"):
            raise ValueError(
                f"FATAL: partition must be 'replicate' or 'process', "
                f"got {partition!r}")
        if dtype not in DTYPES:
            raise ValueError(f"FATAL: buffer dtype must be one of "
                             f"{sorted(DTYPES)}, got {dtype!r}")
        self.device = resolve_device(device)
        self.data_dir = Path(data_dir)
        self.files = _find_shards(data_dir)
        self.batch_size = batch_size
        self.slots = slots
        self.swap_every = swap_every
        self.dtype = dtype
        self.l2_products = list(l2_products) if l2_products else None
        self.l2_dirs = {}
        for product in self.l2_products or []:
            l2_dir = self.data_dir / f"l2_{product}"
            if not l2_dir.exists():
                raise FileNotFoundError(
                    f"FATAL: L2 directory not found: {l2_dir}")
            self.l2_dirs[product] = l2_dir
        shard = batch_sharding(mesh)
        self._rows = None  # this rank's rows of the global draw
        rank_seed = seed
        if shard.world > 1:
            if seed is None:
                raise ValueError(
                    "FATAL: DeviceTileBuffer over several processes needs a "
                    "seed: the ranks' draws must be coordinated")
            if partition == "process":
                if len(self.files) < shard.world:
                    raise ValueError(
                        f"FATAL: {len(self.files)} shard files cannot be "
                        f"partitioned over {shard.world} processes")
                self.files = self.files[shard.rank::shard.world]
                rank_seed = seed + RANK_SEED_STRIDE * shard.rank
                self.batch_size = shard.local_size(batch_size)
            else:
                self._rows = shard.rows(batch_size)
        self._rng = np.random.default_rng(rank_seed)
        self._swap_rng = np.random.default_rng(
            None if seed is None else rank_seed + SWAP_SEED_OFFSET)
        self._deterministic = seed is not None
        self._cuda = self.device.type == "cuda"
        self._batches_since_swap = 0
        self._next_slot = 0
        self._pending: Optional[tuple] = None  # (slot, thread, holder)

        shards = [self._load(self._draw_file()) for _ in range(slots)]
        self.tiles_per_shard = shards[0]["spectral"].shape[0]
        self._pool = {k: torch.empty(
            (slots,) + a.shape, device=self.device,
            dtype=DTYPES[self.dtype][1] if k == "spectral" else torch.float32)
            for k, a in shards[0].items()}
        for slot, shard in enumerate(shards):
            self._check(shard)
            for k, a in shard.items():
                self._pool[k][slot].copy_(torch.from_numpy(np.array(a)))
        del shards
        if self._cuda:
            # one shard's pinned host copy and device staging, reused by
            # every swap
            self._pinned = {k: torch.empty(p.shape[1:], dtype=p.dtype,
                                           pin_memory=True)
                            for k, p in self._pool.items()}
            self._staging = {k: torch.empty_like(p[0])
                             for k, p in self._pool.items()}
            self._side = torch.cuda.Stream(device=self.device)
            self._replaced = torch.cuda.Event()
            self._replaced.record(torch.cuda.current_stream(self.device))

    # ------------------------------------------------------------ internals

    def _draw_file(self) -> int:
        return int(self._swap_rng.integers(0, len(self.files)))

    def _load(self, file_idx: int) -> Dict[str, np.ndarray]:
        """One shard (with its L2 shards) as host arrays: spectral in the
        buffer's type, L2 fields in fp32."""
        np_dtype = DTYPES[self.dtype][0]
        spectral_path = self.files[file_idx]
        shard = load_tile_shard(spectral_path, mmap=True)
        if shard.ndim == 3:
            shard = shard[None]
        item = {"spectral": np.asarray(shard, dtype=np_dtype)}
        name = Path(spectral_path).name
        for product in self.l2_products or []:
            l2 = load_tile_shard(find_l2_shard(self.l2_dirs[product], name),
                                 mmap=True)
            if l2.ndim == 2:
                l2 = l2[None]
            item[product] = np.asarray(l2, dtype=np.float32)
        return item

    def _check(self, shard: Dict[str, np.ndarray]) -> None:
        for k, a in shard.items():
            if a.shape != self._pool[k].shape[1:]:
                raise ValueError(
                    f"FATAL: shard {k} of shape {a.shape} does not fit the "
                    f"pool's {tuple(self._pool[k].shape[1:])}")

    def _swap_work(self, file_idx: int, holder: dict) -> None:
        """Read the shard and, on CUDA, copy it to the staging tensor on the
        side stream; runs on the swap thread (on the caller for the CPU)."""
        try:
            shard = self._load(file_idx)
            self._check(shard)
            if not self._cuda:
                holder["shard"] = {k: torch.from_numpy(np.array(a))
                                   for k, a in shard.items()}
                return
            for k, a in shard.items():
                self._pinned[k].numpy()[...] = a
            with torch.cuda.stream(self._side):
                self._side.wait_event(self._replaced)  # staging is free
                for k, t in self._pinned.items():
                    self._staging[k].copy_(t, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._side)
            # the pinned copy may be refilled by the next swap only after
            # this copy has read it
            copied.synchronize()
            holder["copied"] = copied
        except Exception as exc:  # raised on the main thread at the join
            holder["error"] = exc

    def _start_swap(self) -> None:
        slot = self._next_slot
        self._next_slot = (self._next_slot + 1) % self.slots
        # drawn on the main thread: the swap thread only does IO
        file_idx = self._draw_file()
        holder: dict = {}
        thread = None
        if self._cuda:
            thread = threading.Thread(target=self._swap_work,
                                      args=(file_idx, holder), daemon=True,
                                      name="tile-swap")
            thread.start()
        else:
            self._swap_work(file_idx, holder)
        self._pending = (slot, thread, holder)

    def _finish_swap_if_ready(self, block: bool = False) -> None:
        if self._pending is None:
            return
        slot, thread, holder = self._pending
        if thread is not None and thread.is_alive():
            if not block:
                return  # still in flight: never stall the step loop
            thread.join()
        self._pending = None
        if "error" in holder:
            raise RuntimeError(f"DeviceTileBuffer: loading the shard for "
                               f"slot {slot} failed") from holder["error"]
        if not self._cuda:
            for k, t in holder["shard"].items():
                self._pool[k][slot].copy_(t)
            return
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(holder["copied"])
        for k, t in self._staging.items():
            self._pool[k][slot].copy_(t)
        self._replaced.record(stream)

    # ------------------------------------------------------------ interface

    def __iter__(self):
        return self

    def __next__(self):
        self._batches_since_swap += 1
        if self._batches_since_swap >= self.swap_every:
            self._batches_since_swap = 0
            # with a seed, the swap started one interval ago is applied
            # exactly here, so the pool at every batch is the seed's
            self._finish_swap_if_ready(block=self._deterministic)
            if self._pending is None:
                self._start_swap()
        elif not self._deterministic:
            self._finish_swap_if_ready()

        n = self.batch_size
        slot_idx = self._rng.integers(0, self.slots, size=n)
        tile_idx = self._rng.integers(0, self.tiles_per_shard, size=n)
        flat = slot_idx * self.tiles_per_shard + tile_idx
        if self._rows is not None:
            flat = flat[self._rows]
        flat = torch.from_numpy(flat)
        if self._cuda:
            flat = flat.pin_memory().to(self.device, non_blocking=True)
        batch = {k: p.flatten(0, 1).index_select(0, flat)
                 for k, p in self._pool.items()}
        return batch if self.l2_products else batch["spectral"]

    def close(self) -> None:
        if self._pending is not None:
            thread = self._pending[1]
            if thread is not None:
                thread.join(timeout=60)
            self._pending = None
