"""The port's granule reader and writers (tempo_tpu_torch/data/granule.py,
data/synthetic.py) and its normalization (data/normalize.py) against the
JAX package's, on the CPU.

Tolerances: the readers, writers, generators and the numpy normalizations
are copies of the JAX package's numpy code and must agree bit for bit. The
torch normalize_radiance computes in fp32 in another order (torch's log and
its reductions): it is held within 1e-4 abs of the numpy one, and no
farther (max abs) from a float64 normalize of the same array than the numpy
fp32 one is, plus 1e-5 (z lies in [-10, 10]; an ulp of the fp32 log is
divided by each channel's std).
"""

import sys

import h5py
import numpy as np
import pytest
import torch

from tempo_tpu.data import granule as jax_granule
from tempo_tpu.data import normalize as jax_normalize
from tempo_tpu.data import synthetic as jax_synthetic
from tempo_tpu_torch.data import granule, normalize, synthetic

torch.set_num_threads(1)

NORM_ATOL = 1e-4
NORM_F64_SLACK = 1e-5


def normalize_f64(rad, mean=None, std=None, clip=10.0):
    """The normalization in float64 throughout."""
    log_rad = np.log(np.clip(np.asarray(rad, np.float64), 1.0, None))
    if mean is None:
        axes = tuple(range(log_rad.ndim - 1))
        mean, std = log_rad.mean(axis=axes), log_rad.std(axis=axes)
    z = (log_rad - np.asarray(mean, np.float64)) / (
        np.asarray(std, np.float64) + 1e-8)
    return np.clip(z, -clip, clip)


def assert_normalize_rule(z_torch, rad, mean=None, std=None):
    """7c's rule: the torch normalize near numpy's fp32 one, and no
    farther from float64 than numpy's is."""
    z = z_torch.cpu().numpy() if isinstance(z_torch, torch.Tensor) \
        else z_torch
    z_np = normalize.normalize_radiance(rad, mean, std)
    z64 = normalize_f64(rad, mean, std)
    assert z.dtype == np.float32 and z.shape == z_np.shape
    np.testing.assert_allclose(z, z_np, rtol=0, atol=NORM_ATOL)
    assert np.abs(z - z64).max() <= np.abs(z_np - z64).max() + NORM_F64_SLACK


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(lambda name, obj: out.__setitem__(name, obj[...])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_granule_roundtrip(tmp_path):
    rad = synthetic.write_granule(tmp_path / "g.nc", np.random.default_rng(0),
                                  20, 24, 8)
    want = jax_synthetic.write_granule(tmp_path / "j.nc",
                                       np.random.default_rng(0), 20, 24, 8)
    np.testing.assert_array_equal(rad, want)
    got = granule.read_radiance(tmp_path / "g.nc")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_granule.read_radiance(
        tmp_path / "j.nc"))
    np.testing.assert_array_equal(got, rad)


def test_l2_field_fill_values_and_scale(tmp_path):
    raw = synthetic.write_l2_granule(tmp_path / "l2.nc",
                                     np.random.default_rng(0), "NO2", 10, 12)
    got = granule.read_l2_field(tmp_path / "l2.nc",
                                synthetic.L2_FIELDS["NO2"], scale=1e15)
    np.testing.assert_array_equal(got, jax_granule.read_l2_field(
        tmp_path / "l2.nc", jax_synthetic.L2_FIELDS["NO2"], scale=1e15))
    fill = raw < -1e29
    assert fill.any() and np.isnan(got[fill]).all()
    np.testing.assert_allclose(got[~fill], raw[~fill] / 1e15, rtol=1e-5)


def test_scale_factor_and_add_offset_are_applied(tmp_path):
    with h5py.File(tmp_path / "s.nc", "w") as f:
        ds = f.create_group("product").create_dataset(
            "x", data=np.arange(6, dtype=np.int16).reshape(2, 3))
        ds.attrs["scale_factor"] = 0.5
        ds.attrs["add_offset"] = 2.0
    got = granule.read_l2_field(tmp_path / "s.nc", "x")
    np.testing.assert_array_equal(got, jax_granule.read_l2_field(
        tmp_path / "s.nc", "x"))
    np.testing.assert_array_equal(got, np.arange(6).reshape(2, 3) * 0.5 + 2)


def test_l2_field_missing_returns_none(tmp_path):
    synthetic.write_granule(tmp_path / "g.nc", np.random.default_rng(0), 8, 8,
                            4)
    assert granule.read_l2_field(tmp_path / "g.nc", "whatever") is None
    assert jax_granule.read_l2_field(tmp_path / "g.nc", "whatever") is None


def test_reading_without_h5py_or_netcdf4_raises(tmp_path, monkeypatch):
    """Where neither package is installed (the GPU machine), a read raises
    the JAX package's OSError; the L2 reader gives None, as for a missing
    field."""
    synthetic.write_granule(tmp_path / "g.nc", np.random.default_rng(0), 8, 8,
                            4)
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    with pytest.raises(OSError, match="netCDF4 is not installed"):
        granule.read_radiance(tmp_path / "g.nc")
    assert granule.read_l2_field(tmp_path / "g.nc", "x") is None


def test_l2_filename_convention():
    name = "TEMPO_RAD_L1_V03_20250101T120000Z_S001G01.nc"
    for product in ("NO2", "CLDO4"):
        assert granule.l2_filename_for(name, product) == \
            jax_granule.l2_filename_for(name, product)
    assert granule.l2_filename_for(name, "NO2") == \
        "TEMPO_NO2_L2_V03_20250101T120000Z_S001G01.nc"


@pytest.mark.parametrize("stats", [False, True])
def test_normalize_radiance_semantics(stats):
    rng = np.random.default_rng(0)
    rad = rng.gamma(2.0, 5e10, size=(6, 7, 4)).astype(np.float32)
    rad[0, 0, 0] = 0.0  # clamped to min_radiance before the log
    mean = std = None
    if stats:
        logs = np.log(rad.clip(1.0, None)).reshape(-1, 4)
        mean, std = logs.mean(0), logs.std(0)
    z = normalize.normalize_radiance(rad, mean, std)
    np.testing.assert_array_equal(
        z, jax_normalize.normalize_radiance(rad, mean, std))
    zt = normalize.normalize_radiance(torch.from_numpy(rad), mean, std)
    assert isinstance(zt, torch.Tensor) and zt.dtype == torch.float32
    assert_normalize_rule(zt, rad, mean, std)
    assert np.isfinite(z).all()


@pytest.mark.parametrize("stats", [False, True])
def test_torch_normalize_of_a_granule_and_its_clip(stats):
    """A structured granule and a wide random one whose z-scores reach
    the clip: the torch normalize by the rule, the input unchanged."""
    rng = np.random.default_rng(1)
    rad, _ = synthetic.structured_granule(rng, 40, 56, 24)
    wide = np.exp(rng.normal(3.0, 4.0, (40, 56, 24))).astype(np.float32)
    for r in (rad, wide):
        mean = std = None
        if stats:
            logs = np.log(r.clip(1.0, None)).reshape(-1, r.shape[-1])
            mean = logs.mean(0)
            std = (0.1 * logs.std(0)).astype(np.float32)  # some z past 10
        t = torch.from_numpy(r.copy())
        assert_normalize_rule(normalize.normalize_radiance(t, mean, std), r,
                              mean, std)
        np.testing.assert_array_equal(t.numpy(), r)
    if stats:
        assert np.abs(normalize.normalize_radiance(wide, mean, std)).max() \
            == 10


@pytest.mark.parametrize("norm_type", ["zscore", "minmax", "asinh", "logit"])
def test_normalize_l2_types(norm_type):
    rng = np.random.default_rng(0)
    if norm_type == "logit":
        data = rng.random((20, 20)).astype(np.float32)
    else:
        data = rng.standard_normal((50, 50)).astype(np.float32) * 3
    data[0, :10] = np.nan
    out, stats = normalize.normalize_l2(data, norm_type)
    want, want_stats = jax_normalize.normalize_l2(data, norm_type)
    assert stats == want_stats
    np.testing.assert_array_equal(out, want)
    assert np.isnan(out[0, :10]).all() and np.isfinite(out[1:]).all()
    again, _ = normalize.normalize_l2(data, norm_type, stats)
    np.testing.assert_array_equal(again, out)


def test_l2_stats_asinh_uses_mad():
    vals = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    stats = normalize.compute_l2_stats(vals, "asinh")
    assert stats == jax_normalize.compute_l2_stats(vals, "asinh")
    med = np.median(vals)
    np.testing.assert_allclose(stats["scale"],
                               1.4826 * np.median(np.abs(vals - med)),
                               rtol=1e-6)
    assert normalize.compute_l2_stats(np.full(3, np.nan), "zscore") is None
    with pytest.raises(ValueError, match="Unknown normalization"):
        normalize.compute_l2_stats(vals, "nope")


def test_structured_granule_is_jax_s():
    rad, fields = synthetic.structured_granule(np.random.default_rng(5), 24,
                                               40, 9)
    want, want_fields = jax_synthetic.structured_granule(
        np.random.default_rng(5), 24, 40, 9)
    np.testing.assert_array_equal(rad, want)
    assert fields.keys() == want_fields.keys()
    for k in fields:
        np.testing.assert_array_equal(fields[k], want_fields[k])
    np.testing.assert_array_equal(
        synthetic.synthetic_radiance(np.random.default_rng(2), 5, 6, 7),
        jax_synthetic.synthetic_radiance(np.random.default_rng(2), 5, 6, 7))


@pytest.mark.parametrize("maker", ["make_granule_corpus",
                                   "make_structured_corpus"])
def test_corpus_layout_and_files_are_jax_s(tmp_path, maker):
    products = ["NO2", "CLDO4"]
    kw = dict(n_granules=2, n_mirror=20, n_track=24, n_spectral=4,
              l2_products=products, seed=3)
    paths = getattr(synthetic, maker)(tmp_path / "port", **kw)
    want = getattr(jax_synthetic, maker)(tmp_path / "jax", **kw)
    assert {k: p.relative_to(tmp_path / "port") for k, p in paths.items()} \
        == {k: p.relative_to(tmp_path / "jax") for k, p in want.items()}
    files = sorted(p.relative_to(tmp_path / "port")
                   for p in (tmp_path / "port").rglob("*.nc"))
    assert files == sorted(p.relative_to(tmp_path / "jax")
                           for p in (tmp_path / "jax").rglob("*.nc"))
    assert len(files) == 2 * (1 + len(products))
    for f in files:
        got, exp = _h5_arrays(tmp_path / "port" / f), _h5_arrays(
            tmp_path / "jax" / f)
        assert got.keys() == exp.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], exp[k])
    for f in (paths["l1"] / "raw").glob("*.nc"):
        for product in products:
            assert (paths[product] / "raw" /
                    granule.l2_filename_for(f.name, product)).exists()
