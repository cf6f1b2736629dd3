"""The port's connectomics toolkit (tempo_tpu_torch/ops/morphology.py,
analysis/connectomics.py, utils/h5.py, utils/devices.py) against the JAX
package on the CPU: the morphology and the segmentation labels bitwise
JAX's on the cases of tests/test_connectomics.py and on random EM-like
images (scipy as an independent oracle of the component labelling); VI,
error maps, rescan planning and patch sampling equal to JAX's;
membrane_prob through a tiny CUNet bridged from JAX parameters within
1e-5; h5 ``tree`` / ``repack`` giving JAX's output; the device helpers on
"cpu" and their refusal without CUDA."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tempo_tpu.analysis import connectomics as jc
from tempo_tpu.ops import morphology as jm
from tempo_tpu_torch.analysis import connectomics as pc
from tempo_tpu_torch.ops import morphology as pm

torch.set_num_threads(1)


def _j(fn, *args, **kw):
    return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw))


def _p(fn, *args, **kw):
    return fn(*(torch.from_numpy(np.asarray(a)) for a in args),
              **kw).numpy()


def _same(got, want):
    assert got.dtype == want.dtype or (got.dtype == np.int32
                                       and want.dtype == np.int32)
    np.testing.assert_array_equal(got, want)


def _membrane_image(size=48, cells=((12, 12), (12, 34), (34, 22))):
    """tests/test_connectomics.py's: bright ridges between cells."""
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.stack([np.hypot(yy - cy, xx - cx) for cy, cx in cells])
    nearest = np.sort(d, axis=0)
    return np.clip(200 - 18 * (nearest[1] - nearest[0]), 10, 200).astype(
        np.int32)


def em_like(size: int, seed: int, n_cells: int = 12) -> np.ndarray:
    """An EM-like uint8 image: Voronoi cells (dark interiors) with bright
    membranes on their borders, plus noise."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, size, (n_cells, 2))
    yy, xx = np.mgrid[0:size, 0:size]
    d = np.sort(np.hypot(yy[None] - centers[:, 0, None, None],
                         xx[None] - centers[:, 1, None, None]), axis=0)
    memb = 210 * np.exp(-0.5 * ((d[1] - d[0]) / 1.5) ** 2)
    im = 30 + memb + rng.normal(0, 12, (size, size))
    return np.clip(im, 0, 255).astype(np.uint8)


def _random_images():
    rng = np.random.default_rng(0)
    return {
        "random_12x17": rng.integers(0, 256, (12, 17)).astype(np.int32),
        "plateaus_20x23": (rng.integers(0, 4, (20, 23)) * 50).astype(
            np.int32),
        "membranes": _membrane_image(),
        "em_like_64": em_like(64, 3).astype(np.int32),
    }


IMAGES = _random_images()


@pytest.mark.parametrize("name", list(IMAGES))
def test_window_ops_bitwise(name):
    im = IMAGES[name]
    _same(_p(pm.erode3x3, im), _j(jm.erode3x3, im))
    _same(_p(pm.dilate3x3, im), _j(jm.dilate3x3, im))
    # the INT32 extremes survive (no float rounding, no negation overflow)
    ext = np.array([[2 ** 31 - 1, -2 ** 31, 5], [7, 2 ** 30 + 1, -3]],
                   np.int32)
    _same(_p(pm.erode3x3, ext), _j(jm.erode3x3, ext))
    _same(_p(pm.dilate3x3, ext), _j(jm.dilate3x3, ext))


def test_reconstruction_and_hmin_bitwise():
    rng = np.random.default_rng(1)
    mask = rng.integers(0, 200, (20, 20)).astype(np.int32)
    marker = mask + rng.integers(0, 50, (20, 20)).astype(np.int32)
    _same(_p(pm.reconstruct_by_erosion, marker, mask),
          _j(jm.reconstruct_by_erosion, marker, mask))
    im = np.full((16, 16), 100, np.int32)
    im[3, 3] = 97
    im[10:12, 10] = 60
    got = pm.hmin(torch.from_numpy(im), 5).numpy()
    _same(got, np.asarray(jm.hmin(jnp.asarray(im), 5)))
    assert got[3, 3] == 100 and got[10, 10] == 65
    for name, im in IMAGES.items():
        _same(pm.hmin(torch.from_numpy(im), 40).numpy(),
              np.asarray(jm.hmin(jnp.asarray(im), 40)))
        _same(_p(pm.regional_minima, im), _j(jm.regional_minima, im))


def test_label_components_bitwise_and_scipy_partition():
    from scipy import ndimage as ndi

    mask = np.zeros((10, 10), bool)
    mask[1, 1] = mask[2, 2] = True
    mask[6:8, 6:8] = True
    mask[0, 9] = True
    rng = np.random.default_rng(2)
    for m in (mask, rng.random((30, 27)) < 0.45):
        got = _p(pm.label_components, m)
        _same(got, _j(jm.label_components, m))
        want, n = ndi.label(m, structure=np.ones((3, 3)))
        assert len(np.unique(got[m])) == n
        pairs = set(zip(got[m].tolist(), want[m].tolist()))
        assert len(pairs) == n  # the same partition


@pytest.mark.parametrize("lines", [True, False])
@pytest.mark.parametrize("name", list(IMAGES))
def test_watershed_bitwise(name, lines):
    im = IMAGES[name]
    got = pm.watershed(torch.from_numpy(im), lines=lines).numpy()
    _same(got, np.asarray(jm.watershed(jnp.asarray(im), lines=lines)))


def test_watershed_voronoi_oracle_case():
    seeds = [(6, 6), (24, 25), (27, 4)]
    yy, xx = np.mgrid[0:32, 0:32]
    d = np.stack([np.hypot(yy - cy, xx - cx) for cy, cx in seeds])
    im = np.round(4 * d.min(axis=0)).astype(np.int32)
    got = pm.watershed(torch.from_numpy(im), lines=False).numpy()
    _same(got, np.asarray(jm.watershed(jnp.asarray(im), lines=False)))
    assert len(np.unique(got)) == 3


def test_fixpoint_check_interval_does_not_change_results(monkeypatch):
    im = IMAGES["em_like_64"]
    want = pm.watershed(torch.from_numpy(im)).numpy()
    for every in (1, 3):
        monkeypatch.setattr(pm, "CHECK_EVERY", every)
        pm.STEPS["fixpoint"] = 0
        _same(pm.watershed(torch.from_numpy(im)).numpy(), want)
        assert pm.STEPS["fixpoint"] > 0


# ------------------------------------------------------------- analysis

def test_get_seg_bitwise_and_counts_cells():
    mb = _membrane_image()
    got = pc.get_seg(mb, mb_thres=155, minsupp=40, device="cpu")
    _same(got, jc.get_seg(mb, mb_thres=155, minsupp=40))
    assert len(np.unique(got)) == 4
    em = em_like(96, 5)
    _same(pc.get_seg(em, device="cpu"), jc.get_seg(em))
    with pytest.raises(ValueError, match="32768"):
        pc.get_seg(np.full((4, 4), 32760), device="cpu")
    with pytest.raises(ValueError, match=r"\[H, W\]"):
        pc.get_seg(np.zeros((2, 4, 4)), device="cpu")


def test_vi_and_vi_from_seg_equal_jax():
    rng = np.random.default_rng(4)
    a = rng.integers(0, 7, 5000)
    b = rng.integers(0, 5, 5000)
    for got, want in zip(pc.vi(a, b), jc.vi(a, b)):
        np.testing.assert_array_equal(got, want)
    seg = jc.get_seg(em_like(64, 6))
    gt = jc.get_seg(em_like(64, 6), minsupp=60)
    for got, want in zip(pc.vi_from_seg(seg, gt, device="cpu"),
                         jc.vi_from_seg(seg, gt)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rm_bounds", [0, 5])
def test_error_map_equals_jax(rm_bounds):
    sm = _membrane_image()
    fm = sm.copy()
    memb12 = (sm > 155) & (np.mgrid[0:48, 0:48][0] < 24)
    fm[memb12] = 30
    got = pc.error_map(fm, sm, minsupp=40, rm_bounds=rm_bounds,
                       device="cpu")
    want = jc.error_map(fm, sm, minsupp=40, rm_bounds=rm_bounds)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == tuple(want[1:])
    if rm_bounds == 0:
        assert got[1] > 0.05 and got[0].any()


def test_rescan_smart_rescan_relabel_color_equal_jax():
    rng = np.random.default_rng(5)
    prob = rng.random((64, 64)).astype(np.float32)
    for frac in (0.0, 0.25, 1.0):
        np.testing.assert_array_equal(pc.rescan_map(prob, frac),
                                      jc.rescan_map(prob, frac))
    m = pc.rescan_map(prob, 0.25)
    fast = np.zeros((64, 64), np.uint8)
    slow = np.full((64, 64), 255, np.uint8)
    np.testing.assert_array_equal(pc.smart_rescan(fast, slow, m),
                                  jc.smart_rescan(fast, slow, m))
    lab = np.array([[0, 5, 5], [9, 0, 5]])
    np.testing.assert_array_equal(pc.relabel_consecutive(lab),
                                  jc.relabel_consecutive(lab))
    mask = (prob > 0.5).astype(np.uint8) * 255
    np.testing.assert_array_equal(pc.color_mask(mask), jc.color_mask(mask))
    with pytest.raises(ValueError):
        pc.rescan_map(prob, 1.5)


def test_sample_patches_equal_jax():
    rng = np.random.default_rng(7)
    image = rng.integers(0, 255, (100, 120)).astype(np.uint8)
    mask = (image > 128).astype(np.uint8) * 255
    got = pc.sample_patches(image, mask, n_samples=8, patch_size=32, seed=1)
    want = jc.sample_patches(image, mask, n_samples=8, patch_size=32,
                             seed=1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_membrane_prob_through_a_bridged_cunet():
    from tempo_tpu.nn.unet import CUNet as JaxCUNet
    from tempo_tpu_torch.interop.jax_params import cunet_state_dict_from_jax
    from tempo_tpu_torch.nn.unet import CUNet

    kw = dict(shape=(16, 16, 1), out_channels=1, chs=(8, 12),
              norm_groups=4, n_attention_heads=2, dropout_prob=0.0)
    net = JaxCUNet(**kw)
    params = net.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 16, 16, 1)))["params"]
    rng = np.random.default_rng(8)
    params = jax.tree_util.tree_map(
        lambda p: (np.asarray(p) + 0.1 * rng.standard_normal(
            np.shape(p))).astype(np.float32), params)
    model = CUNet(device="cpu", seed=1, **kw)
    model.load_state_dict(cunet_state_dict_from_jax(params))
    em = (rng.random((30, 29)) * 255).astype(np.uint8)

    def apply_fn(p, x):
        return net.apply({"params": p}, x)

    want = jc.membrane_prob(apply_fn, params, em, levels=1,
                            return_dtype=np.float32)
    got = pc.membrane_prob(model, em, levels=1, return_dtype=np.float32)
    assert got.shape == em.shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5
    assert 0.05 < want.std()  # the nudged net's output varies
    got8 = pc.membrane_prob(model, em, levels=1)
    want8 = jc.membrane_prob(apply_fn, params, em, levels=1)
    assert got8.dtype == np.uint8
    assert np.abs(got8.astype(int) - want8.astype(int)).max() <= 1


# ------------------------------------------------------------- utilities

def test_h5_tree_and_repack_equal_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    from tempo_tpu.utils import h5 as jh5
    from tempo_tpu_torch.utils import h5 as ph5

    paths = []
    for side in ("jax", "port"):
        path = tmp_path / f"{side}.h5"
        with h5py.File(path, "w") as f:
            f.create_dataset("scratch", data=np.ones((256, 256)))
            f.attrs["title"] = "granule"
            g = f.create_group("geo")
            g.attrs["units"] = "deg"
            g.create_dataset("lat", data=np.zeros((4, 5), np.float32))
            f.create_dataset("radiance", data=np.ones((64, 64), np.float64))
        with h5py.File(path, "a") as f:
            del f["scratch"]
        paths.append(path)
    assert ph5.tree(str(paths[1])) == jh5.tree(str(paths[0]))
    before = paths[1].stat().st_size
    ph5.repack(str(paths[1]))
    jh5.repack(str(paths[0]))
    assert paths[1].stat().st_size < before
    assert paths[1].stat().st_size == paths[0].stat().st_size
    assert ph5.tree(str(paths[1])) == jh5.tree(str(paths[0]))


def test_device_helpers_on_cpu_and_without_cuda(monkeypatch):
    from tempo_tpu_torch.utils.devices import (device_memory_summary,
                                               get_freer_device)

    recs = device_memory_summary("cpu")
    assert len(recs) == 1
    assert {"id", "platform", "bytes_limit", "bytes_in_use",
            "bytes_free"} <= set(recs[0])
    assert recs[0]["bytes_free"] is None
    assert get_freer_device(verbose=True, device="cpu") == torch.device(
        "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_freer_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_memory_summary()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pc.get_seg(_membrane_image())


def test_freer_device_picks_the_most_free_cuda_device(monkeypatch):
    """Over three stand-in CUDA devices: the most free memory wins, the
    lowest index among ties; every record names its device."""
    from tempo_tpu_torch.utils import devices

    free = {0: 10, 1: 30, 2: 30}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (free[d.index], 100))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d: f"card{d.index}")
    assert devices.get_freer_device() == torch.device("cuda", 1)
    recs = devices.device_memory_summary()
    assert [r["name"] for r in recs] == ["card0", "card1", "card2"]
    assert recs[0]["bytes_in_use"] == 90
