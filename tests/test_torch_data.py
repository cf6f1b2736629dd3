"""The port's host data layer (tempo_tpu_torch/data/{tiles,native,loader,
synthetic}.py) against the JAX package's on the CPU: tile extraction and
augmentation, the shard formats (.npy, memory-mapped, .pt), the random-pop
buffer, the native gather (float32 and float16-widening, numpy for mixed
types), the threaded loader, and the same draws as JAX's TileLoader for a
seed. All comparisons are exact: the same numpy operations on the same
bytes."""

from __future__ import annotations

import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tempo_tpu.data import loader as jloader
from tempo_tpu.data import native as jnative
from tempo_tpu.data import synthetic as jsynthetic
from tempo_tpu.data import tiles as jtiles
from tempo_tpu_torch.data import loader as ploader
from tempo_tpu_torch.data import native as pnative
from tempo_tpu_torch.data import synthetic as psynthetic
from tempo_tpu_torch.data import tiles as ptiles

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_extract_tiles_and_l2_alignment_match_jax():
    z = np.random.default_rng(0).standard_normal((40, 48, 3)).astype(
        np.float32)
    l2 = np.random.default_rng(1).standard_normal((40, 48)).astype(
        np.float32)
    tiles, positions = ptiles.extract_tiles_with_positions(
        z, (16, 16), 6, np.random.default_rng(2))
    want, want_pos = jtiles.extract_tiles_with_positions(
        z, (16, 16), 6, np.random.default_rng(2))
    np.testing.assert_array_equal(tiles, want)
    assert [p.to_dict() for p in positions] == [p.to_dict()
                                                for p in want_pos]
    np.testing.assert_array_equal(
        ptiles.extract_l2_tiles(l2, positions, (16, 16)),
        jtiles.extract_l2_tiles(l2, want_pos, (16, 16)))
    for pos, tile in zip(positions, tiles):  # the same window, augmented
        raw = z[pos.i:pos.i + 16, pos.j:pos.j + 16]
        np.testing.assert_array_equal(tile, ptiles.apply_augmentation(
            raw.copy(), pos.flip_h, pos.flip_v, pos.rotation))
    assert ptiles.extract_tiles_with_positions(
        z[:8, :8], (16, 16), 3) == (None, None)


def test_shard_formats_and_l2_lookup(tmp_path, rng):
    tiles = rng.standard_normal((4, 8, 8, 3)).astype(np.float32)
    ptiles.save_tile_shard(tmp_path / "t.npy", tiles)
    np.testing.assert_array_equal(ptiles.load_tile_shard(tmp_path / "t.npy"),
                                  tiles)
    mapped = ptiles.load_tile_shard(tmp_path / "t.npy", mmap=True)
    assert isinstance(mapped, np.memmap)
    np.testing.assert_array_equal(mapped, tiles)
    ptiles.save_tile_shard(tmp_path / "h.npy", tiles, dtype=np.float16)
    assert ptiles.load_tile_shard(tmp_path / "h.npy").dtype == np.float16
    torch.save(torch.from_numpy(tiles), tmp_path / "t.pt")
    np.testing.assert_array_equal(ptiles.load_tile_shard(tmp_path / "t.pt"),
                                  jtiles.load_tile_shard(tmp_path / "t.pt"))
    with pytest.raises(ValueError, match="Unknown shard format"):
        ptiles.load_tile_shard(tmp_path / "t.txt")
    l2 = tmp_path / "l2_NO2"
    l2.mkdir()
    np.save(l2 / "a.npy", tiles[..., 0])
    assert ptiles.find_l2_shard(l2, "a.npy") == l2 / "a.npy"
    assert ptiles.find_l2_shard(l2, "a.pt") == l2 / "a.npy"
    with pytest.raises(FileNotFoundError):
        ptiles.find_l2_shard(l2, "b.npy")


def test_random_buffer_draws_as_jax():
    got, want = (mod.RandomBuffer(np.random.default_rng(3))
                 for mod in (ploader, jloader))
    for i in range(10):
        got.put(i)
        want.put(i)
    assert [got.get() for _ in range(10)] == [want.get() for _ in range(10)]
    with pytest.raises(IndexError):
        got.get()


def test_make_tile_shards_matches_jax(tmp_path):
    a = psynthetic.make_tile_shards(tmp_path / "a", n_files=2,
                                    tiles_per_file=3, tile=4, n_spectral=5,
                                    l2_products=["NO2"], seed=4)
    b = jsynthetic.make_tile_shards(tmp_path / "b", n_files=2,
                                    tiles_per_file=3, tile=4, n_spectral=5,
                                    l2_products=["NO2"], seed=4)
    for name in ("00000.npy", "00001.npy", "l2_NO2/00001.npy"):
        np.testing.assert_array_equal(np.load(a / name), np.load(b / name))
    half = psynthetic.make_tile_shards(tmp_path / "h", n_files=1, seed=4,
                                       tiles_per_file=3, tile=4,
                                       n_spectral=5, dtype=np.float16)
    got = np.load(half / "00000.npy")
    assert got.dtype == np.float16
    np.testing.assert_array_equal(got, np.load(b / "00000.npy").astype(
        np.float16))


# ------------------------------------------------------------ the gather

def test_native_library_builds_under_build_native():
    assert pnative.native_available(), "g++ build of native/tileio.cpp"
    path = pnative.library_path()
    assert path.parent == REPO / "build" / "native" and path.exists()
    assert pnative.get_lib()._name == str(path)


def test_port_never_writes_native_libtileio(tmp_path, monkeypatch):
    """A fresh build goes to the port's build directory; the JAX package's
    native/libtileio.so is neither the target nor touched."""
    jax_lib = REPO / "native" / "libtileio.so"
    before = jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
    targets = []
    real_run = subprocess.run

    def run(cmd, *args, **kwargs):
        targets.append(Path(cmd[cmd.index("-o") + 1]))
        return real_run(cmd, *args, **kwargs)

    monkeypatch.setattr(pnative.subprocess, "run", run)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib_checked", False)
    lib = pnative.get_lib()
    assert lib is not None and lib._name == str(pnative.library_path())
    assert len(targets) == 1
    assert targets[0].parent.parent == tmp_path / "native"
    assert targets[0].name == pnative.library_path().name
    assert all(t.resolve() != jax_lib.resolve() for t in targets)
    after = jax_lib.stat().st_mtime_ns if jax_lib.exists() else None
    assert after == before


def test_without_gxx_the_numpy_gather_is_used(tmp_path, monkeypatch, rng):
    def no_gxx(*args, **kwargs):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(pnative.subprocess, "run", no_gxx)
    monkeypatch.setattr(pnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(pnative, "_lib", None)
    monkeypatch.setattr(pnative, "_lib_checked", False)
    assert not pnative.native_available()
    tiles = [rng.standard_normal((4, 4, 2)).astype(np.float16)
             for _ in range(3)]
    np.testing.assert_array_equal(pnative.gather_batch(tiles),
                                  np.stack(tiles).astype(np.float32))


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_gather_matches_jax(rng, dtype):
    tiles = [rng.standard_normal((8, 8, 4)).astype(dtype) for _ in range(10)]
    if dtype == np.float16:  # specials: subnormal, inf, nan, -0
        tiles[0][0, 0, :] = [6e-8, np.inf, np.nan, -0.0]
    got = pnative.gather_batch(tiles, n_threads=3)
    want = jnative.gather_batch(tiles, n_threads=3)
    assert got.dtype == np.float32 and got.shape == (10, 8, 8, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(tiles).astype(np.float32))


def test_gather_from_mmap_views_and_fallbacks(tmp_path, rng):
    data = rng.standard_normal((12, 8, 8, 4)).astype(np.float32)
    ptiles.save_tile_shard(tmp_path / "s.npy", data)
    shard = ptiles.load_tile_shard(tmp_path / "s.npy", mmap=True)
    views = [shard[i] for i in (3, 7, 1, 11)]
    np.testing.assert_array_equal(pnative.gather_batch(views, n_threads=2),
                                  data[[3, 7, 1, 11]])
    mixed = [data[0, ..., 0], data[1, ..., 0].astype(np.float64)]
    np.testing.assert_array_equal(pnative.gather_batch(mixed),
                                  jnative.gather_batch(mixed))
    strided = [data[0, ::2], data[1, ::2]]  # not contiguous
    np.testing.assert_array_equal(pnative.gather_batch(strided),
                                  np.stack(strided))
    with pytest.raises(ValueError, match="same shape"):
        pnative.gather_batch([data[0], data[1, :4]])


# ------------------------------------------------------------ the loader

def test_tile_loader_stream_and_l2(tmp_path):
    products = ["NO2", "CLDO4"]
    psynthetic.make_tile_shards(tmp_path, n_files=3, tiles_per_file=8,
                                tile=8, n_spectral=4, l2_products=products)
    loader = ploader.TileLoader(tmp_path, batch_size=4, min_buffer_size=8,
                                seed=0)
    try:
        for _ in range(5):
            batch = next(loader)
            assert batch.shape == (4, 8, 8, 4) and batch.dtype == np.float32
    finally:
        loader.close()
    loader = ploader.TileLoader(tmp_path, batch_size=4, min_buffer_size=8,
                                l2_products=products, seed=0)
    try:
        batch = next(loader)
        assert set(batch) == {"spectral", "NO2", "CLDO4"}
        assert batch["spectral"].shape == (4, 8, 8, 4)
        assert batch["NO2"].shape == (4, 8, 8)
    finally:
        loader.close()
    with pytest.raises(FileNotFoundError):
        ploader.TileLoader(tmp_path, l2_products=["HCHO"], min_buffer_size=1)
    with pytest.raises(ValueError, match="No .npy or .pt"):
        ploader.TileLoader(tmp_path / "l2_NO2" / "none", min_buffer_size=1)


def test_tile_loader_gives_jax_batches_for_a_seed(tmp_path):
    """Three files of 16 float16 tiles, a buffer of at least 8, batches of
    4: the first three batches come before any refill, so their draws are
    the seed's alone (later ones interleave with the refill threads in
    both packages) and must equal JAX's, widened to float32."""
    psynthetic.make_tile_shards(tmp_path, n_files=3, tiles_per_file=16,
                                tile=4, n_spectral=3, seed=5,
                                dtype=np.float16)
    loaders = [mod.TileLoader(tmp_path, batch_size=4, min_buffer_size=8,
                              seed=11) for mod in (ploader, jloader)]
    try:
        for _ in range(3):
            got, want = (next(ld) for ld in loaders)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    finally:
        for ld in loaders:
            ld.close()


def test_loader_threads_stop_on_close(tmp_path):
    psynthetic.make_tile_shards(tmp_path, n_files=2, tiles_per_file=4,
                                tile=4, n_spectral=2)
    loader = ploader.TileLoader(tmp_path, batch_size=2, min_buffer_size=4,
                                seed=0, num_threads=2)
    next(loader)
    loader.close()
    for t in loader._threads:
        t.join(timeout=10)
        assert not t.is_alive(), t.name


def test_load_normalization_stats(tmp_path):
    mean = np.arange(4, dtype=np.float32)
    np.save(tmp_path / "tempo_mean_spectrum.npy", mean)
    torch.save(torch.from_numpy(mean + 1), tmp_path / "std_spectrum.pt")
    got = ploader.load_normalization_stats(tmp_path)
    np.testing.assert_array_equal(got[0], mean)
    np.testing.assert_array_equal(got[1], mean + 1)
    with pytest.raises(FileNotFoundError):
        ploader.load_normalization_stats(tmp_path / "none")
