"""The port's analysis CLIs (tempo_tpu_torch/cli/{evaluate_reconstruction,
extract_pca, analyze_reconstruction, encode_granules, probe_analysis}.py)
run whole on a tiny h5py corpus on the CPU, against the JAX package's CLIs
on the same files and weights (the JAX CLIs read .msgpack checkpoints, the
port's .pt ones, both written from the same parameters); the port's sweep
and encode_granules also read the JAX run's .msgpack files and give what
they give from the .pt ones, exactly.

Compared wherever the outputs are deterministic, with these tolerances:
- the sweep's metrics, pk_err included: rel 1e-4 (fp32; the posterior's
  logvar half is pinned at the clamp's floor, so the sample is the mean);
- latents and the encode metrics: 1e-4 abs / rel (fp32, ~30 layers);
- PCA components and explained variance: 1e-4 (the port normalizes on the
  device, within 1e-4 of numpy; the same pixels are drawn);
- normalize_l2 stats, the probes' targets and splits: exactly (the same
  numpy code and draws); the probes' latents 1e-4 abs.
The figures are checked, file by file, without matplotlib (train/png.py).
"""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from tempo_tpu.models.vae import AutoencoderKL as JaxVAE
from tempo_tpu.models.vae import VAEConfig as JaxConfig
from tempo_tpu.train.checkpoint import _write_payload
from tempo_tpu_torch.cli import (analyze_reconstruction, encode_granules,
                                 evaluate_reconstruction, extract_pca,
                                 probe_analysis)
from tempo_tpu_torch.data.granule import read_radiance
from tempo_tpu_torch.data.synthetic import make_structured_corpus
from tempo_tpu_torch.interop.jax_params import state_dict_from_jax_params
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from tempo_tpu_torch.train.checkpoint import save_checkpoint
from tempo_tpu_torch.train.state import create_train_state, make_optimizer

torch.set_num_threads(1)

N_SPEC, TILE = 12, 16
TINY = dict(shape=[N_SPEC, TILE, TILE], chs=[16, 12, 8], z_channels=4,
            embed_dim=4, n_attention_heads=2, norm_groups=4,
            compute_dtype="float32")
PRODUCTS = {"NO2": {"field": "vertical_column_troposphere", "scale": 1e15,
                    "norm_type": "asinh"},
            "O3TOT": {"field": "column_amount_o3", "scale": 1.0,
                      "norm_type": "zscore"},
            "HCHO": {"field": "vertical_column", "scale": 1e16,
                     "norm_type": "minmax"},
            "CLDO4": {"field": "cloud_fraction", "scale": 1.0,
                      "norm_type": "logit"}}
PNG = b"\x89PNG\r\n\x1a\n"


def _write_yaml(path: Path, cfg: dict) -> str:
    path.write_text(yaml.dump(cfg))
    return str(path)


def _pinned_params(seed):
    jm = JaxVAE(JaxConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in TINY.items()}))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, TILE, TILE, N_SPEC)),
                     rng=jax.random.PRNGKey(1))["params"]
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.standard_normal(
            np.shape(p)).astype(np.float32), params)
    e = TINY["embed_dim"]
    params["quant_conv"]["kernel"][:, e:] = 0.0
    params["quant_conv"]["bias"][e:] = -30.0
    return params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """A structured corpus of three granules with four products, the
    normalization stats and split of a tile directory, validation tiles,
    and one run directory for each package with checkpoints at steps 10
    and 20 of the same weights."""
    root = tmp_path_factory.mktemp("analysis_cli")
    make_structured_corpus(root / "data", n_granules=3, n_mirror=40,
                           n_track=56, n_spectral=N_SPEC,
                           l2_products=list(PRODUCTS), seed=3)
    l1 = sorted((root / "data" / "l1" / "raw").glob("*.nc"))
    tiles = root / "tiles"
    (tiles / "val").mkdir(parents=True)
    logs = np.concatenate([np.log(np.clip(read_radiance(f), 1.0, None))
                           .reshape(-1, N_SPEC) for f in l1])
    np.save(tiles / "tempo_mean_spectrum.npy", logs.mean(0).astype(np.float32))
    np.save(tiles / "tempo_std_spectrum.npy", logs.std(0).astype(np.float32))
    (tiles / "split_info.json").write_text(json.dumps(
        {"val_sources": {"0": l1[0].name, "1": l1[2].name}}))
    np.save(tiles / "val" / "00000.npy", np.random.default_rng(4)
            .standard_normal((6, TILE, TILE, N_SPEC)).astype(np.float32))
    runs = {}
    for pkg in ("jax", "port"):
        runs[pkg] = root / f"run_{pkg}"
        (runs[pkg] / "checkpoints").mkdir(parents=True)
        _write_yaml(runs[pkg] / "config.yaml", {"model": TINY})
    for step, seed in ((10, 1), (20, 2)):
        params = _pinned_params(seed)
        _write_payload(runs["jax"] / "checkpoints", {
            "step": step, "params": serialization.to_state_dict(params)})
        model = AutoencoderKL(VAEConfig.from_dict(TINY), device="cpu")
        model.load_state_dict(state_dict_from_jax_params(params))
        state = create_train_state(model, make_optimizer())
        state.step = step
        save_checkpoint(runs["port"] / "checkpoints", state)
    return {"root": root, "l1": root / "data" / "l1", "tiles": tiles,
            "runs": runs}


def _ckpt(world, pkg, step=20):
    ext = "msgpack" if pkg == "jax" else "pt"
    return str(world["runs"][pkg] / "checkpoints" /
               f"ckpt_step={step:06d}.{ext}")


def _no_matplotlib(monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)


def _is_png(path: Path) -> bool:
    return path.exists() and path.read_bytes()[:8] == PNG


def test_evaluate_reconstruction_matches_jax(world, monkeypatch):
    from tempo_tpu.cli.evaluate_reconstruction import main as jax_main

    cfg = {"output_dir": "eval_reconstruction",
           "data": {"val_dir": str(world["tiles"] / "val"),
                    "max_val_samples": 5},
           "model": {"training_config_path": "config.yaml"},
           "evaluation": {"batch_size": 4,
                          "metrics": ["mse", "mae", "psnr", "pk_err"]},
           "plotting": {"plot_metrics": True, "dpi": 72}, "seed": 42}
    jax_main(_write_yaml(world["root"] / "eval.yaml",
                         dict(cfg, exp_dir=str(world["runs"]["jax"]))))
    _no_matplotlib(monkeypatch)
    got = evaluate_reconstruction.run(
        dict(cfg, exp_dir=str(world["runs"]["port"])), device="cpu")
    out = {pkg: world["runs"][pkg] / "eval_reconstruction"
           for pkg in ("jax", "port")}
    want = json.loads((out["jax"] / "results" /
                       "reconstruction_metrics.json").read_text())
    assert json.loads((out["port"] / "results" /
                       "reconstruction_metrics.json").read_text()) == got
    assert [r["step"] for r in got] == [r["step"] for r in want] == [10, 20]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in cfg["evaluation"]["metrics"]:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)
    for name in ("metrics_vs_step.png", "best_metrics_summary.png"):
        assert _is_png(out["port"] / "figures" / name)
        assert (out["jax"] / "figures" / name).exists()
    assert json.loads((out["port"] / "config.yaml").read_text())["seed"] == 42


def test_port_clis_read_the_jax_msgpack(world):
    """The sweep over the JAX run directory with the repo configs'
    checkpoint_pattern (ckpt_step=*.msgpack), and encode_granules over a
    .msgpack: the numbers and latents the port gives over its .pt
    checkpoints of the same weights."""
    cfg = {"data": {"val_dir": str(world["tiles"] / "val"),
                    "max_val_samples": 5},
           "evaluation": {"batch_size": 4,
                          "metrics": ["mse", "mae", "psnr", "pk_err"]},
           "plotting": {"plot_metrics": False}, "seed": 42}
    got = evaluate_reconstruction.run(dict(
        cfg, exp_dir=str(world["runs"]["jax"]), output_dir="eval_msgpack",
        model={"training_config_path": "config.yaml",
               "checkpoint_pattern": "checkpoints/ckpt_step=*.msgpack"}),
        device="cpu")
    want = evaluate_reconstruction.run(dict(
        cfg, exp_dir=str(world["runs"]["port"]), output_dir="eval_pt",
        model={"training_config_path": "config.yaml"}), device="cpu")
    assert [r.pop("checkpoint") for r in got] == [
        "ckpt_step=000010.msgpack", "ckpt_step=000020.msgpack"]
    assert [r.pop("checkpoint") for r in want] == [
        "ckpt_step=000010.pt", "ckpt_step=000020.pt"]
    assert got == want

    root = world["root"]
    enc = {"input_dir": str(world["l1"] / "raw"), "decode_roundtrip": True,
           "max_files": 1, "seed": 42,
           "data": {"tiles_path": str(world["tiles"])}}
    summaries = {}
    for pkg in ("jax", "port"):
        summaries[pkg] = encode_granules.run(dict(
            enc, output_dir=str(root / f"encoded_from_{pkg}_ckpt"),
            model={"checkpoint_path": _ckpt(world, pkg),
                   "training_config_path": str(world["runs"][pkg] /
                                               "config.yaml")}),
            device="cpu")
    for g, w in zip(summaries["jax"]["granules"],
                    summaries["port"]["granules"]):
        assert {k: g[k] for k in ("mse", "mae", "psnr", "latent_shape")} == \
            {k: w[k] for k in ("mse", "mae", "psnr", "latent_shape")}
        stem = Path(g["granule"]).stem + ".npz"
        np.testing.assert_array_equal(
            np.load(root / "encoded_from_jax_ckpt" / "latents" / stem)[
                "latent"],
            np.load(root / "encoded_from_port_ckpt" / "latents" / stem)[
                "latent"])


def test_extract_pca_and_analyze_reconstruction_match_jax(world,
                                                          monkeypatch):
    from tempo_tpu.cli.analyze_reconstruction import main as jax_analyze
    from tempo_tpu.cli.extract_pca import main as jax_pca

    root = world["root"]
    pca_cfg = {
        "input_dir": str(world["l1"] / "raw"),
        "normalization": {
            "mean_file": str(world["tiles"] / "tempo_mean_spectrum.npy"),
            "std_file": str(world["tiles"] / "tempo_std_spectrum.npy")},
        "sampling": {"pixels_per_file": 64, "max_files": 3, "seed": 42},
        "pca": {"n_components": 3},
        "processing": {"min_radiance": 1.0, "clip_min": -10,
                       "clip_max": 10}}
    jax_pca(_write_yaml(root / "pca.yaml",
                        dict(pca_cfg, output_dir=str(root / "pca_jax"))))
    fit = extract_pca.run(dict(pca_cfg, output_dir=str(root / "pca_port")),
                          device="cpu")
    want = np.load(root / "pca_jax" / "pca_components.npz")
    got = np.load(root / "pca_port" / "pca_components.npz")
    assert sorted(got.files) == sorted(want.files)
    for k in ("components", "mean"):
        assert got[k].dtype == want[k].dtype
        np.testing.assert_allclose(got[k], want[k], atol=1e-4)
    np.testing.assert_allclose(got["explained_variance_ratio"],
                               want["explained_variance_ratio"], rtol=1e-4)
    np.testing.assert_array_equal(fit.components, got["components"])
    assert int(got["n_samples"]) == int(want["n_samples"]) == 192
    assert np.load(root / "pca_port" / "sample_projections.npy").shape == \
        np.load(root / "pca_jax" / "sample_projections.npy").shape
    summary = yaml.safe_load((root / "pca_port" / "summary.yaml").read_text())
    summary_jax = yaml.safe_load((root / "pca_jax" /
                                  "summary.yaml").read_text())
    assert summary.keys() == summary_jax.keys()
    assert summary["total_samples"] == summary_jax["total_samples"]

    analyze = {"data": {"nc_path": str(world["l1"]),
                        "tiles_path": str(world["tiles"])}, "seed": 42}
    jax_analyze(_write_yaml(root / "analyze.yaml", dict(
        analyze, output_dir=str(root / "analysis_jax"),
        model={"checkpoint_path": _ckpt(world, "jax"),
               "training_config_path": str(world["runs"]["jax"] /
                                           "config.yaml")},
        visualization={"mode": "pca_rgb", "pca_components_path":
                       str(root / "pca_jax" / "pca_components.npz")})))
    names = sorted(p.name for p in (root / "analysis_jax").glob("*.png"))
    assert len(names) == 2
    model = {"checkpoint_path": _ckpt(world, "port"),
             "training_config_path": str(world["runs"]["port"] /
                                         "config.yaml")}
    paths = analyze_reconstruction.run(dict(
        analyze, output_dir=str(root / "analysis_port"), model=model,
        visualization={"mode": "pca_rgb", "pca_components_path":
                       str(root / "pca_port" / "pca_components.npz")}),
        device="cpu")
    assert sorted(p.name for p in paths) == names
    assert all(_is_png(p) for p in paths)
    _no_matplotlib(monkeypatch)
    paths = analyze_reconstruction.run(dict(
        analyze, output_dir=str(root / "analysis_ch"), model=model,
        visualization={"mode": "single_channel", "single_channel": 500}),
        device="cpu")
    assert [p.name[-9:] for p in paths] == ["_ch11.png"] * 2
    assert all(_is_png(p) for p in paths)


@pytest.mark.parametrize("stats", [True, False])
def test_encode_granules_matches_jax(world, stats):
    from tempo_tpu.cli.encode_granules import main as jax_main

    root = world["root"]
    cfg = {"input_dir": str(world["l1"] / "raw"), "decode_roundtrip": True,
           "max_files": 2, "seed": 42}
    if stats:
        cfg["data"] = {"tiles_path": str(world["tiles"])}
    tag = "stats" if stats else "own"
    jax_main(_write_yaml(root / f"encode_{tag}.yaml", dict(
        cfg, output_dir=str(root / f"encoded_jax_{tag}"),
        model={"checkpoint_path": _ckpt(world, "jax"),
               "training_config_path": str(world["runs"]["jax"] /
                                           "config.yaml")})))
    summary = encode_granules.run(dict(
        cfg, output_dir=str(root / f"encoded_port_{tag}"),
        model={"checkpoint_path": _ckpt(world, "port"),
               "training_config_path": str(world["runs"]["port"] /
                                           "config.yaml")}), device="cpu")
    want = json.loads((root / f"encoded_jax_{tag}" /
                       "encode_summary.json").read_text())
    assert json.loads((root / f"encoded_port_{tag}" /
                       "encode_summary.json").read_text()) == summary
    assert summary.keys() == want.keys()
    assert summary["n_granules"] == want["n_granules"] == 2
    assert summary["total_pixels"] == want["total_pixels"] == 2 * 32 * 48
    for g, w in zip(summary["granules"], want["granules"]):
        assert g.keys() == w.keys()
        assert (g["granule"], g["input_shape"], g["latent_shape"]) == \
            (w["granule"], w["input_shape"], w["latent_shape"]) == \
            (w["granule"], [32, 48, N_SPEC], [8, 12, 4])
        for k in ("mse", "mae", "psnr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4)
        got = np.load(root / f"encoded_port_{tag}" / "latents" /
                      (Path(g["granule"]).stem + ".npz"))
        exp = np.load(root / f"encoded_jax_{tag}" / "latents" /
                      (Path(w["granule"]).stem + ".npz"))
        assert sorted(got.files) == sorted(exp.files) == ["latent", "shape"]
        for k in got.files:
            assert got[k].dtype == exp[k].dtype and \
                got[k].shape == exp[k].shape
        np.testing.assert_array_equal(got["shape"], exp["shape"])
        np.testing.assert_allclose(got["latent"], exp["latent"], atol=1e-4)


def test_probe_analysis_matches_jax(world, monkeypatch):
    from tempo_tpu.cli.probe_analysis import main as jax_main

    root = world["root"]
    cfg = {"seed": 42,
           "data": {"l1_nc_path": str(world["l1"]),
                    "l2_base_path": str(root / "data"),
                    "tiles_path": str(world["tiles"]),
                    "l2_products": {p: f"l2_{p}" for p in PRODUCTS}},
           "probe": {"n_pixels_per_file": 50, "test_split": 0.2,
                     "max_epochs": 20, "learning_rate": 1e-2,
                     "weight_decay": 0.01, "batch_size": 64},
           "components": PRODUCTS}
    out = {"jax": root / "probes_jax", "port": root / "probes_port"}
    jax_main(_write_yaml(root / "probe.yaml", dict(
        cfg, output_dir=str(out["jax"]),
        model={"checkpoint_path": _ckpt(world, "jax"),
               "training_config_path": str(world["runs"]["jax"] /
                                           "config.yaml")})))
    _no_matplotlib(monkeypatch)
    # through main and the same YAML reader: the components in the file's
    # order, which sets the order of the draws
    probe_analysis.main(_write_yaml(root / "probe_port.yaml", dict(
        cfg, output_dir=str(out["port"]),
        model={"checkpoint_path": _ckpt(world, "port"),
               "training_config_path": str(world["runs"]["port"] /
                                           "config.yaml")})), device="cpu")

    def load(pkg, name):
        return json.loads((out[pkg] / "results" / name).read_text())

    assert load("port", "component_norm_stats.json") == \
        load("jax", "component_norm_stats.json")
    want = load("jax", "probe_results.json")
    results = load("port", "probe_results.json")
    assert list(results) == list(want)
    assert results.keys() == want.keys() == PRODUCTS.keys()
    for comp in PRODUCTS:
        assert results[comp].keys() == want[comp].keys()
        assert (results[comp]["n_train"], results[comp]["n_test"]) == \
            (want[comp]["n_train"], want[comp]["n_test"]) == (80, 20)
        assert np.isfinite(results[comp]["r2_score"])
        for name in (f"predictions_{comp}.npz",
                     f"training_curves_{comp}.npz"):
            got = np.load(out["port"] / "results" / name)
            exp = np.load(out["jax"] / "results" / name)
            assert sorted(got.files) == sorted(exp.files)
            for k in got.files:
                assert got[k].shape == exp[k].shape
        got = np.load(out["port"] / "results" / f"predictions_{comp}.npz")
        exp = np.load(out["jax"] / "results" / f"predictions_{comp}.npz")
        np.testing.assert_array_equal(got["y_test"], exp["y_test"])
        np.testing.assert_allclose(got["X_test"], exp["X_test"], atol=1e-4)
        curves = np.load(out["port"] / "results" /
                         f"training_curves_{comp}.npz")
        assert np.isfinite(curves["val_losses"]).all()
        model = np.load(out["port"] / "models" / f"probe_{comp}.npz")
        assert sorted(model.files) == sorted(np.load(
            out["jax"] / "models" / f"probe_{comp}.npz").files)
        assert _is_png(out["port"] / "figures" / f"probe_{comp}.png")
    assert _is_png(out["port"] / "figures" / "probe_summary.png")
    for name in ("all_normalizations_comparison.png",
                 "input_latent_distributions.png",
                 "target_distributions.png"):
        assert _is_png(out["port"] / "data_stats" / name)
