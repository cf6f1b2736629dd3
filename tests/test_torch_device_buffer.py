"""The port's DeviceTileBuffer (tempo_tpu_torch/data/device_buffer.py) on
the CPU (``device='cpu'``: the same schedule, synchronously), mirroring the
JAX package's buffer tests (tests/test_data.py) but the mesh case, and
held to the JAX package's DeviceTileBuffer bit for bit: for a seed, the
same (slot, tile) draws and the same swap schedule give the same batches,
plain and L2, in fp32 and fp16 pools, over several swap intervals. The
port keeps L2 fields in fp32 where JAX keeps them in the pool's type: with
an fp16 pool they equal JAX's after the same rounding to fp16."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tempo_tpu.data.device_buffer import DeviceTileBuffer as JaxBuffer
from tempo_tpu_torch.data.device_buffer import DeviceTileBuffer
from tempo_tpu_torch.data.synthetic import make_tile_shards

torch.set_num_threads(1)


def _buffer(path, **kwargs):
    kwargs.setdefault("device", "cpu")
    return DeviceTileBuffer(path, **kwargs)


def test_device_tile_buffer(tmp_path):
    make_tile_shards(tmp_path, n_files=4, tiles_per_file=8, tile=8,
                     n_spectral=4, seed=1)
    buf = _buffer(tmp_path, batch_size=4, slots=2, swap_every=2, seed=0)
    try:
        seen = []
        for _ in range(8):  # crosses several swap boundaries
            batch = next(buf)
            assert batch.shape == (4, 8, 8, 4)
            assert batch.dtype == torch.float32
            seen.append(batch.numpy().copy())
        assert np.isfinite(np.stack(seen)).all()
        assert not np.array_equal(seen[0], seen[1])
    finally:
        buf.close()


def test_device_tile_buffer_distribution(tmp_path):
    """Every resident tile is reachable: over many draws from one static
    pool, all (slot, tile) pairs appear."""
    make_tile_shards(tmp_path, n_files=1, tiles_per_file=8, tile=4,
                     n_spectral=2, seed=2)
    buf = _buffer(tmp_path, batch_size=16, slots=2, swap_every=10_000,
                  seed=0)
    signatures = set()
    for _ in range(40):
        for row in next(buf).numpy().reshape(16, -1):
            signatures.add(row.tobytes())
    assert len(signatures) == 8  # all 8 resident tiles sampled


def test_device_tile_buffer_reproducible(tmp_path):
    """The same seed gives the same batch stream; another seed another."""
    make_tile_shards(tmp_path, n_files=6, tiles_per_file=8, tile=8,
                     n_spectral=4, seed=5)

    def stream(seed, n):
        buf = _buffer(tmp_path, batch_size=4, slots=2, swap_every=2,
                      seed=seed)
        return [next(buf).numpy().copy() for _ in range(n)]

    a, b, c = stream(7, 12), stream(7, 12), stream(8, 12)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


def test_device_tile_buffer_l2_dict_batches(tmp_path):
    """L2 mode: every value of the dict is gathered at the same (slot,
    tile) pairs, shown by writing the tile's id into both the spectral and
    the L2 shards."""
    products = ["NO2", "CLDO4"]
    for i in range(3):
        ids = 100.0 * i + np.arange(8, dtype=np.float32)
        np.save(tmp_path / f"{i:05d}.npy",
                np.broadcast_to(ids[:, None, None, None], (8, 8, 8, 4)).copy())
        for p in products:
            (tmp_path / f"l2_{p}").mkdir(exist_ok=True)
            np.save(tmp_path / f"l2_{p}" / f"{i:05d}.npy",
                    np.broadcast_to(ids[:, None, None], (8, 8, 8)).copy())
    buf = _buffer(tmp_path, batch_size=4, slots=2, swap_every=3, seed=0,
                  dtype="float16", l2_products=products)
    for _ in range(8):
        batch = next(buf)
        assert set(batch) == {"spectral", "NO2", "CLDO4"}
        assert batch["spectral"].shape == (4, 8, 8, 4)
        assert batch["spectral"].dtype == torch.float16
        spec_ids = batch["spectral"][:, 0, 0, 0].float().numpy()
        for p in products:
            assert batch[p].shape == (4, 8, 8)
            assert batch[p].dtype == torch.float32
            np.testing.assert_array_equal(batch[p][:, 0, 0].numpy(),
                                          spec_ids)


def test_device_tile_buffer_l2_nan_passthrough(tmp_path):
    """NaNs of the L2 shards survive the gather (the masked loss needs
    them); the spectral tiles stay finite."""
    make_tile_shards(tmp_path, n_files=2, tiles_per_file=8, tile=8,
                     n_spectral=4, l2_products=["NO2"], seed=6)
    buf = _buffer(tmp_path, batch_size=16, slots=2, swap_every=100, seed=0,
                  l2_products=["NO2"])
    saw_nan = False
    for _ in range(5):
        batch = next(buf)
        assert torch.isfinite(batch["spectral"]).all()
        saw_nan |= bool(torch.isnan(batch["NO2"]).any())
    assert saw_nan  # make_tile_shards plants ~5% NaN in each L2 shard


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("l2", [False, True], ids=["plain", "l2"])
def test_batches_equal_jax_for_a_seed(tmp_path, dtype, l2):
    """The JAX package's DeviceTileBuffer and the port's, same files and
    seed: 14 batches over four swap intervals of 3, bit for bit (NaN
    included); the port's fp32 L2 fields rounded to the pool's type."""
    products = ["NO2", "HCHO"] if l2 else None
    make_tile_shards(tmp_path, n_files=5, tiles_per_file=8, tile=8,
                     n_spectral=4, l2_products=products, seed=1)
    kwargs = dict(batch_size=4, slots=2, swap_every=3, seed=7, dtype=dtype,
                  l2_products=products)
    port, ref = _buffer(tmp_path, **kwargs), JaxBuffer(tmp_path, **kwargs)
    try:
        for _ in range(14):
            got, want = next(port), next(ref)
            if not l2:
                got, want = {"spectral": got}, {"spectral": want}
            assert set(got) == set(want)
            for k, v in got.items():
                np.testing.assert_array_equal(
                    v.to(getattr(torch, dtype)).numpy(), np.asarray(want[k]))
    finally:
        port.close()
        ref.close()


def test_swap_replaces_the_least_recently_refreshed_slot(tmp_path):
    """Shards whose values are their file index: with a seed, the swap
    drawn at batch k * swap_every is in the pool from batch (k + 1) *
    swap_every on, in slot k mod slots."""
    for i in range(4):
        np.save(tmp_path / f"{i:05d}.npy", np.full((2, 4, 4, 1), i,
                                                   np.float32))
    buf = _buffer(tmp_path, batch_size=64, slots=2, swap_every=2, seed=3)
    rng = np.random.default_rng(3 + 7919)
    slots = [int(rng.integers(0, 4)) for _ in range(2)]
    pending, next_slot = None, 0
    for n in range(1, 11):
        if n % 2 == 0:
            if pending is not None:
                slots[pending[0]] = pending[1]
            pending = (next_slot, int(rng.integers(0, 4)))
            next_slot = 1 - next_slot
        values = set(next(buf)[:, 0, 0, 0].tolist())
        assert values == {float(v) for v in slots}, (n, values, slots)


def test_a_shard_that_does_not_fit_raises_at_the_swap(tmp_path):
    np.save(tmp_path / "00000.npy", np.zeros((4, 4, 4, 2), np.float32))
    np.save(tmp_path / "00001.npy", np.zeros((4, 4, 4, 3), np.float32))
    buf = _buffer(tmp_path, batch_size=2, slots=1, swap_every=1, seed=0)
    with pytest.raises((ValueError, RuntimeError)):
        for _ in range(40):
            next(buf)


def test_mesh_process_partition_and_types_are_refused(tmp_path):
    make_tile_shards(tmp_path, n_files=1, tiles_per_file=2, tile=4,
                     n_spectral=2)
    with pytest.raises(NotImplementedError, match="M13"):
        _buffer(tmp_path, mesh=object())
    with pytest.raises(NotImplementedError, match="partition"):
        _buffer(tmp_path, partition="process")
    with pytest.raises(ValueError, match="partition"):
        _buffer(tmp_path, partition="shard")
    with pytest.raises(ValueError, match="dtype"):
        _buffer(tmp_path, dtype="int8")
    with pytest.raises(FileNotFoundError, match="l2_NO2"):
        _buffer(tmp_path, l2_products=["NO2"])


def test_default_device_is_cuda_and_raises_without_it(tmp_path,
                                                      monkeypatch):
    make_tile_shards(tmp_path, n_files=1, tiles_per_file=2, tile=4,
                     n_spectral=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceTileBuffer(tmp_path, batch_size=2, slots=1)
