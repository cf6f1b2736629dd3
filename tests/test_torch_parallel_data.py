"""The port's input path over processes on the CPU: the DeviceTileBuffer
with a mesh (tempo_tpu_torch/data/device_buffer.py; each rank named by a
``BatchShard``, parallel/mesh.py) and the host loaders' local batches.

``partition: replicate``: the ranks' slices of each batch, side by side,
are bit for bit the JAX package's buffer on its 8-device mesh (the same
files and seed; L2 fields compared through the pool's type, as
tests/test_torch_device_buffer.py does). ``partition: process``: each
rank's batches are a numpy replay of tempo_tpu/data/device_buffer.py's
per-process draws (files[r::W], the index and swap generators at seed +
1_000_003 r, the local batch B / W). The host loader: each of a host's
LOCAL_WORLD_SIZE ranks loads batch_size / LOCAL_WORLD_SIZE from seed +
1000 * rank (its TileLoader's arguments: a threaded loader's order is not
fixed)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.data.device_buffer import DeviceTileBuffer as JaxBuffer
from tempo_tpu.parallel.mesh import create_mesh
from tempo_tpu_torch.cli import train_vae
from tempo_tpu_torch.data.device_buffer import DeviceTileBuffer
from tempo_tpu_torch.data.loader import local_batch_size
from tempo_tpu_torch.data.synthetic import make_tile_shards
from tempo_tpu_torch.parallel.mesh import (BatchShard, batch_sharding,
                                           make_place_fn)

torch.set_num_threads(1)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("dtype, l2", [("float32", False), ("float16", True)],
                         ids=["plain_f32", "l2_f16"])
def test_replicated_rank_slices_are_the_jax_mesh_batches(tmp_path, world,
                                                         dtype, l2):
    """12 global batches of 8 over four swap intervals of 3."""
    products = ["NO2", "HCHO"] if l2 else None
    make_tile_shards(tmp_path, n_files=5, tiles_per_file=8, tile=8,
                     n_spectral=4, l2_products=products, seed=1)
    kwargs = dict(batch_size=8, slots=2, swap_every=3, seed=7, dtype=dtype,
                  l2_products=products)
    ref = JaxBuffer(tmp_path, mesh=create_mesh(), **kwargs)
    ranks = [DeviceTileBuffer(tmp_path, device="cpu",
                              mesh=BatchShard(r, world), **kwargs)
             for r in range(world)]
    try:
        for _ in range(12):
            want = next(ref)
            got = [next(r) for r in ranks]
            if not l2:
                want, got = {"spectral": want}, [{"spectral": g} for g in got]
            assert all(g["spectral"].shape[0] == 8 // world for g in got)
            for k in want:
                whole = torch.cat([g[k] for g in got])
                np.testing.assert_array_equal(
                    whole.to(getattr(torch, dtype)).numpy(),
                    np.asarray(want[k]))
    finally:
        ref.close()
        for r in ranks:
            r.close()


@pytest.mark.parametrize("rank", [0, 1])
def test_process_partition_replays_the_jax_draws(tmp_path, rank):
    """Each shard is filled with its file's index, so a batch names the
    files its tiles came from: rank r's pool holds only files[r::2], in the
    order its swap generator draws them, and its gathers follow its index
    generator."""
    world, slots, swap_every, seed, batch = 2, 2, 3, 11, 8
    for i in range(5):
        np.save(tmp_path / f"{i:05d}.npy",
                np.full((4, 4, 4, 2), float(i), np.float32))
    buf = DeviceTileBuffer(tmp_path, batch_size=batch, slots=slots,
                           swap_every=swap_every, seed=seed, device="cpu",
                           mesh=BatchShard(rank, world), partition="process")
    files = list(range(5))[rank::world]
    rng = np.random.default_rng(seed + 1_000_003 * rank)
    swap = np.random.default_rng(seed + 7919 + 1_000_003 * rank)
    pool = [files[int(swap.integers(0, len(files)))] for _ in range(slots)]
    pending, next_slot, since = None, 0, 0
    for _ in range(10):
        since += 1
        if since >= swap_every:  # the JAX module's schedule, seeded
            since = 0
            if pending is not None:
                pool[pending[0]] = pending[1]
            pending = (next_slot, files[int(swap.integers(0, len(files)))])
            next_slot = (next_slot + 1) % slots
        slot_idx = rng.integers(0, slots, size=batch // world)
        rng.integers(0, 4, size=batch // world)  # the tile draws
        want = [float(pool[s]) for s in slot_idx]
        got = next(buf)
        assert got.shape[0] == batch // world
        assert got[:, 0, 0, 0].tolist() == want
    assert set(buf.files) == {str(tmp_path / f"{i:05d}.npy") for i in files}


def test_mesh_buffer_refusals(tmp_path):
    make_tile_shards(tmp_path, n_files=1, tiles_per_file=2, tile=4,
                     n_spectral=2)
    with pytest.raises(ValueError, match="seed"):
        DeviceTileBuffer(tmp_path, batch_size=2, device="cpu",
                         mesh=BatchShard(0, 2))
    with pytest.raises(ValueError, match="partitioned"):
        DeviceTileBuffer(tmp_path, batch_size=2, device="cpu", seed=0,
                         mesh=BatchShard(1, 2), partition="process")
    with pytest.raises(ValueError, match="divide"):
        DeviceTileBuffer(tmp_path, batch_size=3, device="cpu", seed=0,
                         mesh=BatchShard(0, 2))
    # one process is the one-device buffer under either partition
    one = DeviceTileBuffer(tmp_path, batch_size=2, slots=1, device="cpu",
                           seed=0, mesh=BatchShard(0, 1), partition="process")
    assert next(one).shape[0] == 2


def test_batch_shard_rows_and_take():
    shard = batch_sharding(BatchShard(1, 4))
    assert shard.rows(8) == slice(2, 4)
    batch = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    got = shard.take(batch)
    assert got["a"].tolist() == [2, 3] and got["b"].shape == (2, 2)
    assert batch_sharding(None) == BatchShard(0, 1)
    placed = make_place_fn("cpu")(got)
    assert isinstance(placed["a"], torch.Tensor) and placed["a"].device.type \
        == "cpu"
    with pytest.raises(ValueError, match="divide"):
        shard.rows(6)


def test_host_loader_local_batch_and_rank_seed(tmp_path, monkeypatch):
    """A host of 2 ranks splits its batch_size of 4: rank 1's TileLoader
    loads 2 tiles a batch from seed + 1000 (JAX's per-process seed); one
    process without a mesh loads the whole batch from the seed."""
    assert local_batch_size(4, 2) == 2
    with pytest.raises(ValueError, match="divide"):
        local_batch_size(5, 2)
    monkeypatch.setattr(train_vae, "TileLoader", lambda **kw: kw)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    lone = train_vae.make_train_loader({}, tmp_path, 4, 42, "cpu")
    assert (lone["batch_size"], lone["seed"]) == (4, 42)
    monkeypatch.setattr(train_vae, "process_index", lambda: 1)
    got = train_vae.make_train_loader({}, tmp_path, 4, 42, "cpu",
                                      mesh=BatchShard(1, 2))
    assert (got["batch_size"], got["seed"]) == (2, 42 + 1000)
    with pytest.raises(ValueError, match="divide"):
        train_vae.make_train_loader({}, tmp_path, 5, 42, "cpu",
                                    mesh=BatchShard(1, 2))


def test_resolve_device_takes_the_local_rank(monkeypatch):
    """None is CUDA: torchrun's LOCAL_RANK picks the process's GPU; without
    it the current device; without CUDA it raises, and the CPU only when
    named."""
    from tempo_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device(None) == torch.device("cuda", 3)
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device(None) == torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
