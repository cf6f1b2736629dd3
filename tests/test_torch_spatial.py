"""The port's spatial sharding (tempo_tpu_torch/parallel/spatial.py, the
codec's ``mesh``, encode_granules' ``spatial_sharding``) against the JAX
package's sharded functions on its 8-device CPU mesh
(tests/test_parallel.py:86 and :321) and against the one-process port,
with the port's ranks as gloo processes on the CPU
(tests/torch_parallel_workers.py; the children import no JAX).

The tiny config is tests/test_parallel.py's TINY, fp32, its weights
JAX's init nudged (so the zero-initialized output convs carry signal),
carried across by interop/jax_params.py. Each world (2, 3 and 4 ranks: W
splits 64/64, 44/44/40 and 32 each) runs once and its results feed the
cases below; the world-2 run also takes encode_granules over a corpus.

Tolerances: against JAX, JAX's own (atol 2e-4, rtol 1e-3). Against the
one-process port, atol 1e-5 / rtol 1e-5: the sharded GroupNorm sums its
statistics in another order (per rank, then over the ranks), and the
gathered attention sums in another order too, so fp32 agreement is to
rounding, not bitwise (~2e-6 at most here). At world 1 the sharded path
is bitwise the unsharded one.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_parallel_workers as workers
from tempo_tpu.infer.granule_codec import GranuleCodec as JaxCodec
from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.parallel.mesh import create_mesh
from tempo_tpu.parallel.spatial import (decode_spatially_sharded,
                                        encode_spatially_sharded)
from tempo_tpu_torch.cli import encode_granules
from tempo_tpu_torch.data.synthetic import make_structured_corpus
from tempo_tpu_torch.infer.granule_codec import GranuleCodec
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.ops import cuda_gn
from tempo_tpu_torch.parallel import spatial
from tempo_tpu_torch.train.checkpoint import save_checkpoint
from tempo_tpu_torch.train.state import create_train_state, make_optimizer

torch.set_num_threads(1)

TINY = dict(shape=(8, 16, 16), chs=(12, 8, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")
JAX_TOL = dict(atol=2e-4, rtol=1e-3)
PORT_TOL = dict(atol=1e-5, rtol=1e-5)
WORLDS = (2, 3, 4)

_RUNS: dict = {}


def _once(key, make):
    if key not in _RUNS:
        _RUNS[key] = make()
    return _RUNS[key]


def _case():
    """JAX's nudged weights, the port's state dict of them, the inputs and
    every JAX reference (its unsharded and 8-device sharded results)."""
    def make():
        jm = JaxVAE(JaxConfig(**TINY))
        x = np.random.default_rng(5).standard_normal(
            (1, 32, 128, 8)).astype(np.float32)  # W = 8 devices x 16
        params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         rng=jax.random.PRNGKey(1))["params"]
        rng = np.random.default_rng(0)
        params = jax.tree_util.tree_map(
            lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
                np.shape(p)).astype(np.float32), params)
        granule = np.random.default_rng(11).standard_normal(
            (32, 128, 8)).astype(np.float32)
        raw = np.exp(3.0 + 0.5 * np.random.default_rng(12).standard_normal(
            (34, 131, 8))).astype(np.float32)
        spectra = (np.linspace(2.5, 3.5, 8).astype(np.float32),
                   np.linspace(0.4, 0.6, 8).astype(np.float32))
        mesh = create_mesh()
        want = jm.apply({"params": params}, jnp.asarray(x),
                        method=JaxVAE.encode).mean
        plain = JaxCodec(jm, params, multiple=16, seed=0)
        sharded = JaxCodec(jm, params, multiple=16, seed=0, mesh=mesh)
        lat_plain = np.asarray(plain.encode(granule))
        return {
            "sd": state_dict_from_jax_params(params), "x": x,
            "granule": granule, "raw": raw, "spectra": spectra,
            "jax": {
                "encode": np.asarray(encode_spatially_sharded(
                    jm, params, x, mesh)),
                "decode": np.asarray(decode_spatially_sharded(
                    jm, params, np.asarray(want), mesh)),
                "codec_latent": np.asarray(sharded.encode(granule)),
                "codec_rec": sharded.reconstruct(granule,
                                                 sample_posterior=False),
                "codec_dec": sharded.decode(lat_plain)}}
    return _once("case", make)


def _port_model():
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu", seed=0)
    model.load_state_dict(_case()["sd"])
    return model.eval()


def _one_process():
    """The one-process port on the same inputs."""
    def make():
        case, model = _case(), _port_model()
        x = torch.from_numpy(case["x"])
        with torch.inference_mode():
            lat = model.encode(x).mean
            dec = model.decode(lat)
        codec = GranuleCodec(model, multiple=16, seed=0, device="cpu")
        latent = codec.encode(case["granule"]).numpy()
        return {
            "encode": lat, "decode": dec, "codec_latent": latent,
            "codec_rec": codec.reconstruct(case["granule"],
                                           sample_posterior=False),
            "codec_rec_sampled": [codec.reconstruct(case["granule"])
                                  for _ in range(2)],
            "codec_dec": codec.decode(latent),
            "normalized_own": codec.normalize(case["raw"]),
            "normalized_spectra": GranuleCodec(
                model, *case["spectra"], multiple=16,
                device="cpu").normalize(case["raw"])}
    return _once("one", make)


# ----------------------------------------------------- the CLI's corpus

N_SPEC, TILE = 8, 16


def _corpus(root: Path) -> dict:
    """Two structured granules (40 x 56 -> 32 x 48 crops), their stats, and
    a port checkpoint of the case's weights with its config.yaml."""
    make_structured_corpus(root / "data", n_granules=2, n_mirror=40,
                           n_track=56, n_spectral=N_SPEC, seed=3)
    tiles = root / "tiles"
    tiles.mkdir()
    spectra = _case()["spectra"]
    np.save(tiles / "tempo_mean_spectrum.npy", spectra[0])
    np.save(tiles / "tempo_std_spectrum.npy", spectra[1])
    run = root / "run"
    (run / "checkpoints").mkdir(parents=True)
    (run / "config.yaml").write_text(yaml.dump(
        {"model": {k: list(v) if isinstance(v, tuple) else v
                   for k, v in TINY.items()}}))
    state = create_train_state(_port_model(), make_optimizer())
    state.step = 10
    ckpt = save_checkpoint(run / "checkpoints", state)
    return {"input_dir": str(root / "data" / "l1" / "raw"),
            "tiles": str(tiles), "ckpt": str(ckpt),
            "train_config": str(run / "config.yaml")}


def _cli_config(corpus: dict, out: Path, stats: bool, sharded: bool) -> dict:
    cfg = {"input_dir": corpus["input_dir"], "decode_roundtrip": True,
           "seed": 42, "output_dir": str(out),
           "model": {"checkpoint_path": corpus["ckpt"],
                     "training_config_path": corpus["train_config"]}}
    if stats:
        cfg["data"] = {"tiles_path": corpus["tiles"]}
    if sharded:
        cfg["spatial_sharding"] = True
    return cfg


def _cli_root(tmp_path_factory) -> Path:
    return _once("cli_root", lambda: tmp_path_factory.mktemp("encode_cli"))


def _port(world: int, tmp_path_factory) -> list:
    """Every rank's results at ``world`` ranks (world 2 also runs the CLI
    over the corpus, with and without the stats)."""
    def make():
        case, one = _case(), _one_process()
        cli = []
        if world == 2:
            root = _cli_root(tmp_path_factory)
            corpus = _once("corpus", lambda: _corpus(root / "corpus"))
            cli = [_cli_config(corpus, root / f"sharded_{s}", s, True)
                   for s in (True, False)]
        return workers.launch(
            workers.spatial_run, world,
            tmp_path_factory.mktemp(f"spatial{world}"), TINY, case["sd"],
            case["x"], case["granule"], one["codec_latent"], case["raw"],
            case["spectra"], cli)
    return _once(("port", world), make)


# ------------------------------------------------------------ the kernel

@pytest.mark.parametrize("shape, groups, dtype", [
    ((2, 5, 7, 16), 4, torch.float32), ((1, 3, 9, 24), 8, torch.bfloat16),
    ((3, 4, 4, 12), 1, torch.float32)])
def test_gn_sums_and_stats_from_sums_reproduce_gn_stats_plain(shape, groups,
                                                              dtype):
    """K1a's sums mode's plain version, finished by stats_from_sums, is
    bitwise K1a's plain statistics; the pieces of a sample split along W
    add up to the whole's sums (to fp32 rounding)."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        shape).astype(np.float32) + 0.3).to(dtype)
    b, c = shape[0], shape[-1]
    sums = cuda_gn.gn_sums_plain(x, groups)
    assert sums.shape == (b, 2, groups) and sums.dtype == torch.float32
    n = shape[1] * shape[2] * (c // groups)
    assert torch.equal(cuda_gn.stats_from_sums(sums, n, c),
                       cuda_gn.gn_stats_plain(x, groups))
    assert torch.equal(cuda_gn.gn_sums(x, groups), sums)  # the CPU op
    halves = (cuda_gn.gn_sums_plain(x[:, :, :3].contiguous(), groups)
              + cuda_gn.gn_sums_plain(x[:, :, 3:].contiguous(), groups))
    torch.testing.assert_close(halves, sums, atol=1e-5, rtol=1e-5)
    want = cuda_gn.gn_stats_plain(x, groups, 1e-6)
    torch.testing.assert_close(cuda_gn.stats_from_sums(halves, n, c, 1e-6),
                               want, atol=1e-5, rtol=1e-4)


def test_gn_sums_op_schema_and_fake():
    x = torch.randn(2, 3, 5, 8)
    torch.library.opcheck(torch.ops.tempo.gn_sums.default, (x, 4))


# ------------------------------------------------------------- the split

def test_widths_are_stride_multiples_as_even_as_they_allow():
    split = spatial.SpatialSharding
    assert split(0, 2).widths(128, 4) == [64, 64]
    assert split(0, 3).widths(128, 4) == [44, 44, 40]
    assert split(2, 3).bounds(128, 4) == (88, 128)
    assert split(1, 4).widths(2048, 4) == [512] * 4
    assert split(0, 8).widths(32, 4) == [4] * 8
    assert split(0, 3).widths(32) == [11, 11, 10]


@pytest.mark.parametrize("width, world", [(130, 2), (8, 3), (4, 2)])
def test_a_width_that_cannot_be_split_raises(width, world):
    with pytest.raises(ValueError, match="multiple of the model's total "
                                         "stride 4"):
        spatial.SpatialSharding(0, world).widths(width, 4)


def test_world_one_is_bitwise_the_unsharded_forward():
    case, model = _case(), _port_model()
    x = torch.from_numpy(case["x"])
    lat = spatial.encode_spatially_sharded(model, x, None)
    with torch.inference_mode():
        want = model.encode(x).mean
        dec = model.decode(want)
    assert torch.equal(lat, want)
    assert torch.equal(spatial.decode_spatially_sharded(model, want, None),
                       dec)


# ------------------------------------------------------- sharded forwards

def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol,
                               err_msg=msg)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_encode_decode_match_jax_and_the_one_process_port(
        world, tmp_path_factory):
    ranks = _port(world, tmp_path_factory)
    case, one = _case(), _one_process()
    widths = spatial.SpatialSharding(0, world).widths(128, 4)
    for r, res in enumerate(ranks):
        assert res["sharding"] == (r, world)
        # the latent stays split: a quarter of the rank's share of W
        assert res["encode_share"] == (1, 8, widths[r] // 4, 4)
        assert res["decode_share"] == (1, 32, widths[r], 8)
        _close(res["encode"], ranks[0]["encode"], dict(atol=0, rtol=0))
        _close(res["encode"], one["encode"], PORT_TOL, f"rank {r}")
        _close(res["decode"], one["decode"], PORT_TOL, f"rank {r}")
        _close(res["encode"], case["jax"]["encode"], JAX_TOL, f"rank {r}")
        _close(res["decode"], case["jax"]["decode"], JAX_TOL, f"rank {r}")
        ex = res["exchanged"]
        assert ex["halo"] > 0 and ex["gather"] > 0 and ex["reduce"] > 0


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_codec_matches_jax_and_the_one_process_port(
        world, tmp_path_factory):
    ranks = _port(world, tmp_path_factory)
    case, one = _case(), _one_process()
    widths = spatial.SpatialSharding(0, world).widths(128, 4)
    for r, res in enumerate(ranks):
        assert res["codec_latent_share"] == (8, widths[r] // 4, 4)
        assert res["codec_latent"].shape == (8, 32, 4)
        for key in ("codec_latent", "codec_rec", "codec_dec"):
            _close(res[key], one[key], PORT_TOL, f"{key} rank {r}")
            _close(res[key], case["jax"][key], JAX_TOL, f"{key} rank {r}")


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_sampled_reconstruct_equals_one_process_with_the_seed(
        world, tmp_path_factory):
    """The noise is drawn for the whole latent from the codec's generator
    and cut to each rank's columns: two draws in turn equal the
    one-process codec's two draws with the same seed."""
    ranks = _port(world, tmp_path_factory)
    one = _one_process()
    assert not np.allclose(one["codec_rec_sampled"][0],
                           one["codec_rec_sampled"][1])
    for res in ranks:
        for got, want in zip(res["codec_rec_sampled"],
                             one["codec_rec_sampled"]):
            _close(got, want, PORT_TOL)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_normalize_matches_one_process(world, tmp_path_factory):
    """Each rank normalizes its share on its device: with a stats file's
    spectra element by element, with the granule's own statistics from
    float64 sums over the ranks (the uncropped granule, as on one
    device)."""
    ranks = _port(world, tmp_path_factory)
    one = _one_process()
    assert one["normalized_own"].shape == (32, 128, 8)
    for res in ranks:
        _close(res["normalized_spectra"], one["normalized_spectra"],
               dict(atol=0, rtol=0))
        _close(res["normalized_own"], one["normalized_own"], PORT_TOL)


# ------------------------------------------------------------------ CLI

@pytest.mark.parametrize("stats", [True, False], ids=["stats", "own"])
def test_encode_granules_spatial_sharding_matches_one_process(
        stats, tmp_path_factory):
    """encode_granules with ``spatial_sharding: true`` over 2 gloo ranks:
    rank 0 alone writes, and its latents and summary equal a one-process
    run's."""
    ranks = _port(2, tmp_path_factory)
    root = _cli_root(tmp_path_factory)
    corpus = _once("corpus", lambda: _corpus(root / "corpus"))
    i = 0 if stats else 1
    out = root / f"sharded_{stats}"
    ref_out = root / f"one_{stats}"
    want = encode_granules.run(_cli_config(corpus, ref_out, stats, False),
                               device="cpu")
    got = ranks[0]["cli"][i]["summary"]
    assert ranks[1]["cli"][i]["written"] == []
    assert json.loads((out / "encode_summary.json").read_text()) == got
    assert got["n_granules"] == want["n_granules"] == 2
    assert got["total_pixels"] == want["total_pixels"] == 2 * 32 * 48
    for rank in ranks:
        for g, w in zip(rank["cli"][i]["summary"]["granules"],
                        want["granules"]):
            assert g.keys() == w.keys()
            assert (g["granule"], g["input_shape"], g["latent_shape"]) == (
                w["granule"], [32, 48, N_SPEC], [8, 12, 4])
            for k in ("mse", "mae", "psnr"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
    for g in got["granules"]:
        name = Path(g["granule"]).stem + ".npz"
        a, b = np.load(out / "latents" / name), np.load(
            ref_out / "latents" / name)
        assert sorted(a.files) == sorted(b.files) == ["latent", "shape"]
        assert a["latent"].dtype == b["latent"].dtype == np.float32
        np.testing.assert_array_equal(a["shape"], b["shape"])
        _close(a["latent"], b["latent"], PORT_TOL)
