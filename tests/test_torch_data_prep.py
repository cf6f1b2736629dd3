"""The port's data-preparation CLIs (tempo_tpu_torch/cli/{compute_stats,
prepare_tiles,download}.py) on the CPU, against the JAX package's CLIs on
the same files: a corpus of 5 granules [40, 48, 16] with the four L2
products, seed 3 (as tests/test_e2e.py's pipeline), written by the port's
data/synthetic.py.

Tolerances: spectra rel 1e-6 (float64 sums of fp32 logs, torch's log
against numpy's); spectral tiles 1e-5 abs (the normalize in torch on the
device against numpy, as data/normalize.py's tensor path); tile positions,
flags, L2 tiles, manifests, split and L2 statistics exactly (the same numpy
code and draws). The download runs a fake ``wget`` from PATH: no network.
"""

import json
import os
import shutil
import stat
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from tempo_tpu_torch.data.synthetic import make_granule_corpus

torch.set_num_threads(1)

N_SPECTRAL, TILE = 16, 16
PRODUCTS = ["NO2", "O3TOT", "HCHO", "CLDO4"]
SPECTRA_REL = 1e-6
TILE_ATOL = 1e-5


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("prep")
    make_granule_corpus(root / "data", n_granules=5, n_mirror=40, n_track=48,
                        n_spectral=N_SPECTRAL, l2_products=PRODUCTS, seed=3)
    return root


def _write(path: Path, cfg: dict) -> str:
    path.write_text(yaml.dump(cfg))
    return str(path)


def _stats_cfg(root: Path, out: str) -> str:
    return _write(root / f"{out}.yaml", {
        "input_dir": str(root / "data" / "l1" / "raw"),
        "output_dir": str(root / out), "max_files": 5})


@pytest.fixture(scope="module")
def stats(corpus):
    from tempo_tpu.cli.compute_stats import main as jax_main
    from tempo_tpu_torch.cli.compute_stats import main

    jax_main(_stats_cfg(corpus, "stats_jax"))
    main(_stats_cfg(corpus, "stats_port"), device="cpu")
    return corpus / "stats_jax", corpus / "stats_port"


def test_compute_stats_matches_jax(stats):
    want, got = stats
    assert (sorted(p.name for p in got.iterdir())
            == sorted(p.name for p in want.iterdir()))
    for name in ("tempo_mean_spectrum", "tempo_std_spectrum",
                 "mean_spectrum", "std_spectrum"):
        a, b = np.load(got / f"{name}.npy"), np.load(want / f"{name}.npy")
        assert a.dtype == b.dtype == np.float32 and a.shape == (N_SPECTRAL,)
        np.testing.assert_allclose(a, b, rtol=SPECTRA_REL)
    for name in ("tempo_mean_spectrum", "tempo_std_spectrum"):
        np.testing.assert_allclose(np.loadtxt(got / f"{name}.txt"),
                                   np.loadtxt(want / f"{name}.txt"),
                                   rtol=SPECTRA_REL)
    mg, mw = (yaml.safe_load((d / "manifest.yaml").read_text())
              for d in (got, want))
    assert mg.keys() == mw.keys()
    for key in ("n_files_used", "total_pixels", "band", "min_radiance"):
        assert mg[key] == mw[key]
    for key in ("mean_range", "std_range"):
        np.testing.assert_allclose(mg[key], mw[key], rtol=SPECTRA_REL)


def test_log_radiance_sums_are_float64_numpy():
    """The per-granule accumulation on a tensor equals numpy's float64
    (count, sum, sumsq) of the fp32 log, within rel 1e-7 (torch's and
    numpy's fp32 logs differ by an ulp here and there)."""
    from tempo_tpu_torch.cli.compute_stats import log_radiance_sums

    rad = np.random.default_rng(0).uniform(0.0, 50.0, (6, 7, 5)).astype(
        np.float32)
    n, s, sq = log_radiance_sums(torch.from_numpy(rad), 1.0)
    flat = np.log(np.clip(rad, 1.0, None)).astype(np.float64).reshape(-1, 5)
    assert n == 42 and s.dtype == sq.dtype == torch.float64
    np.testing.assert_allclose(s.numpy(), flat.sum(0), rtol=1e-7)
    np.testing.assert_allclose(sq.numpy(), (flat ** 2).sum(0), rtol=1e-7)


def _tiles_cfg(root: Path, stats_dir: Path, out: str, with_l2: bool,
               input_dir=None) -> str:
    cfg = {
        "input_dir": str(input_dir or root / "data" / "l1" / "raw"),
        "output_dir": str(root / out),
        "normalization": {
            "mean_file": str(stats_dir / "tempo_mean_spectrum.npy"),
            "std_file": str(stats_dir / "tempo_std_spectrum.npy")},
        "processing": {"tile_size": [TILE, TILE], "tiles_per_file": 16,
                       "n_spectral": N_SPECTRAL, "min_radiance": 1.0,
                       "clip_min": -10, "clip_max": 10},
        "split": {"val_fraction": 0.3, "seed": 42},
    }
    if with_l2:
        cfg["l2"] = _l2_section(root)
    return _write(root / f"{out}.yaml", cfg)


def _l2_section(root: Path) -> dict:
    return {
        "base_path": str(root / "data"), "components": PRODUCTS,
        "products": {p: p for p in PRODUCTS},
        "subdirs": {p: f"l2_{p}" for p in PRODUCTS},
        "fields": {"NO2": "vertical_column_troposphere",
                   "O3TOT": "column_amount_o3", "HCHO": "vertical_column",
                   "CLDO4": "cloud_fraction"},
        "scales": {"NO2": 1e15, "O3TOT": 1.0, "HCHO": 1e16, "CLDO4": 1.0},
        "norm_types": {"NO2": "asinh", "O3TOT": "zscore", "HCHO": "asinh",
                       "CLDO4": "logit"},
        "compute_global_stats": True}


def _seeded_rng(monkeypatch, seed):
    """np.random.default_rng() (the CLIs' unseeded tile draws) gives a
    Generator seeded with ``seed``."""
    real = np.random.default_rng
    monkeypatch.setattr(np.random, "default_rng",
                        lambda *a, **k: real(seed) if not a else real(*a))


def _run_both(monkeypatch, root, stats_dir, with_l2, tag, input_dir=None):
    from tempo_tpu.cli.prepare_tiles import main as jax_main
    from tempo_tpu_torch.cli.prepare_tiles import main

    with monkeypatch.context() as m:
        _seeded_rng(m, 11)
        jax_main(_tiles_cfg(root, stats_dir, f"{tag}_jax", with_l2,
                            input_dir))
    with monkeypatch.context() as m:
        _seeded_rng(m, 11)
        main(_tiles_cfg(root, stats_dir, f"{tag}_port", with_l2, input_dir),
             device="cpu")
    return root / f"{tag}_jax", root / f"{tag}_port"


def _same_outputs(want: Path, got: Path) -> int:
    """Every file of the JAX CLI's output in the port's: json and yaml
    equal, .npy shards l2_* bitwise and spectral within TILE_ATOL. Returns
    the number of shards compared."""
    names = sorted(str(p.relative_to(want)) for p in want.rglob("*")
                   if p.is_file() and p.name != "config.yaml")
    assert names == sorted(str(p.relative_to(got)) for p in got.rglob("*")
                           if p.is_file() and p.name != "config.yaml")
    shards = 0
    for name in names:
        a, b = want / name, got / name
        if name.endswith(".json"):
            assert json.loads(b.read_text()) == json.loads(a.read_text())
        elif name.endswith(".yaml"):
            assert (yaml.safe_load(b.read_text())
                    == yaml.safe_load(a.read_text())), name
        elif name.endswith(".npy"):
            x, y = np.load(a), np.load(b)
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if "l2_" in name or "spectrum" in name:
                np.testing.assert_array_equal(y, x)
            else:
                shards += 1
                np.testing.assert_allclose(y, x, atol=TILE_ATOL, rtol=0)
    return shards


def test_prepare_tiles_with_l2_matches_jax(monkeypatch, corpus, stats):
    want, got = _run_both(monkeypatch, corpus, stats[0], True, "tiles_l2")
    assert _same_outputs(want, got) == 5
    assert (got / "l2_stats.json").exists()
    assert len(list((got / "train" / "l2_NO2").glob("*.npy"))) >= 1


def test_prepare_tiles_plain_matches_jax(monkeypatch, corpus, stats):
    want, got = _run_both(monkeypatch, corpus, stats[0], False, "tiles")
    assert _same_outputs(want, got) == 5


def test_process_granule_positions_match_jax(corpus, stats):
    """The same seeded Generator gives JAX's positions and flags exactly;
    process_granule's tiles (normalized and cut as tensors) are JAX's within
    TILE_ATOL, its L2 tiles bitwise."""
    from tempo_tpu.cli.prepare_tiles import process_granule as jax_process
    from tempo_tpu.data.tiles import (extract_tiles_with_positions as
                                      jax_extract)
    from tempo_tpu_torch.cli.prepare_tiles import process_granule
    from tempo_tpu_torch.data.tiles import extract_tiles_with_positions

    z = np.random.default_rng(1).standard_normal((40, 48, 4)).astype(
        np.float32)
    want, want_pos = jax_extract(z, (16, 16), 32, np.random.default_rng(5))
    got, got_pos = extract_tiles_with_positions(
        torch.from_numpy(z), (16, 16), 32, np.random.default_rng(5))
    assert [p.to_dict() for p in got_pos] == [p.to_dict() for p in want_pos]
    assert {p.rotation for p in got_pos} == {0, 1, 2, 3}
    np.testing.assert_array_equal(got.numpy(), want)

    cfg = yaml.safe_load(Path(_tiles_cfg(corpus, stats[0], "one", True))
                         .read_text())
    mean = np.load(stats[0] / "tempo_mean_spectrum.npy")
    std = np.load(stats[0] / "tempo_std_spectrum.npy")
    nc = sorted((corpus / "data" / "l1" / "raw").glob("*.nc"))[0]
    l2_stats = {"O3TOT": {"mean": 300.0, "std": 20.0}}
    want = jax_process(nc, cfg, mean, std, l2_stats,
                       np.random.default_rng(8))
    got = process_granule(nc, cfg, mean, std, l2_stats,
                          np.random.default_rng(8), device="cpu")
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["spectral"], want["spectral"],
                               atol=TILE_ATOL, rtol=0)
    for p in PRODUCTS:
        np.testing.assert_array_equal(got[f"l2_{p}"], want[f"l2_{p}"])


def test_prepare_tiles_l2_mode_fails_on_a_missing_l2_file(monkeypatch,
                                                           corpus, stats):
    """As JAX's: a granule without one of its L2 files stops the L2 run."""
    from tempo_tpu.cli.prepare_tiles import main as jax_main
    from tempo_tpu_torch.cli.prepare_tiles import main

    data = corpus / "missing"
    shutil.copytree(corpus / "data", data)
    victim = sorted((data / "l2_HCHO" / "raw").glob("*.nc"))[2]
    victim.unlink()
    for fn, tag, kw in ((jax_main, "miss_jax", {}),
                        (main, "miss_port", {"device": "cpu"})):
        cfg = yaml.safe_load(Path(_tiles_cfg(corpus, stats[0], tag, True,
                                             data / "l1" / "raw"))
                             .read_text())
        cfg["l2"]["base_path"] = str(data)
        with pytest.raises(ValueError, match="FATAL: Failed to load L2 "
                                             "component HCHO"):
            fn(_write(corpus / f"{tag}.yaml", cfg), **kw)


def test_prepare_tiles_plain_mode_logs_a_corrupt_file(monkeypatch, corpus,
                                                      stats, capsys):
    """As JAX's: the plain run logs an unreadable granule, lists it as
    failed and tiles the rest."""
    raw = corpus / "corrupt" / "raw"
    shutil.copytree(corpus / "data" / "l1" / "raw", raw)
    bad = sorted(raw.glob("*.nc"))[1]
    bad.write_bytes(b"not an HDF5 file")
    want, got = _run_both(monkeypatch, corpus, stats[0], False, "corrupt",
                          input_dir=raw)
    assert _same_outputs(want, got) == 4
    split = json.loads((got / "split_info.json").read_text())
    assert split["failed_files"] == [str(bad)]
    assert f"Failed: {bad.name}" in capsys.readouterr().out


FAKE_WGET = """#!/bin/sh
# Writes its URL to the -O file; fails, leaving a partial file, for a URL
# that holds "broken".
out=""; url=""
while [ $# -gt 0 ]; do
  case "$1" in
    -O) out="$2"; shift 2;;
    *) url="$1"; shift;;
  esac
done
printf '%s' "$url" > "$out"
case "$url" in *broken*) exit 4;; esac
exit 0
"""


def test_download_matches_jax(monkeypatch, tmp_path):
    """Both CLIs fetch through `wget` (a fake on PATH), write the same
    files and mapping yaml, remove the failed file and exit 1."""
    from tempo_tpu.cli.download import main as jax_main
    from tempo_tpu_torch.cli.download import main

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    wget = bin_dir / "wget"
    wget.write_text(FAKE_WGET)
    wget.chmod(wget.stat().st_mode | stat.S_IEXEC)
    home = tmp_path / "home"
    home.mkdir()
    (home / ".netrc").write_text("machine example.invalid login u password p\n")
    monkeypatch.setenv("HOME", str(home))
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    urls = [f"https://example.invalid/TEMPO_RAD_L1_V03_2025010{i}T1{i}.nc"
            for i in range(3)]
    urls.insert(1, "https://example.invalid/broken/TEMPO_RAD_L1_V03_X.nc")
    (tmp_path / "urls.txt").write_text("\n".join(urls) + "\n")
    outs = {}
    for fn, tag in ((jax_main, "jax"), (main, "port")):
        cfg = _write(tmp_path / f"{tag}.yaml", {
            "output_dir": str(tmp_path / tag), "product": "NO2",
            "file_list": str(tmp_path / "urls.txt")})
        with pytest.raises(SystemExit) as exit_info:
            fn(cfg)
        assert exit_info.value.code == 1
        outs[tag] = tmp_path / tag
    files = {tag: {str(p.relative_to(d)): p.read_bytes()
                   for p in sorted(d.rglob("*"))
                   if p.is_file() and p.name != "config.yaml"}
             for tag, d in outs.items()}
    assert files["port"] == files["jax"]
    raw = sorted(n for n in files["port"] if n.startswith("raw/"))
    assert raw == sorted(f"raw/{Path(u).name.replace('RAD_L1', 'NO2_L2')}"
                         for u in urls if "broken" not in u)
    assert files["port"][raw[0]].decode().endswith(Path(raw[0]).name)
    mapping = yaml.safe_load(files["port"]["rad_to_no2_mapping.yaml"])
    assert len(mapping) == 4
    assert (home / ".urs_cookies").exists()
