"""Guards of the PyTorch/CUDA port: it imports nothing of JAX or of the JAX
package (nor yaml, matplotlib, msgpack, h5py or netCDF4, which the card's
machine lacks) at load, its entry points default to CUDA and raise without it, and its
CUDA wrappers refuse what the kernels do not take."""

import json
import pkgutil
import subprocess
import sys

import pytest
import torch

import tempo_tpu_torch
from tempo_tpu_torch.infer.granule_codec import GranuleCodec
from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig, build_vae
from tempo_tpu_torch.ops import cuda_gn

torch.set_num_threads(1)

TINY = dict(shape=(12, 16, 16), chs=(16, 12, 8), z_channels=4, embed_dim=4,
            n_attention_heads=2, norm_groups=4, compute_dtype="float32")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        tempo_tpu_torch.__path__, "tempo_tpu_torch."))


def test_port_imports_no_jax():
    """Importing every module of the port loads neither jax, flax, optax,
    yaml, matplotlib, msgpack, h5py, netCDF4 nor any tempo_tpu module."""
    mods = _port_modules()
    for name in ("ops.cuda_gn_conv", "infer.paged", "ops.flash_attention",
                 "train.trainer", "train.checkpoint", "train.plots",
                 "cli.train_gpt", "utils.config", "data.tokens",
                 "data.loader", "data.native", "data.tiles",
                 "data.synthetic", "cli.train_vae", "infer.graphs",
                 "infer.serving", "infer.export_lm", "ops.launches",
                 "cli.export_lm", "cli.serve_lm", "data.device_buffer",
                 "models.vae_l2", "cli.train_vae_l2", "train.png",
                 "data.granule", "data.normalize", "infer.granule_codec",
                 "analysis.spectrum", "infer.sweep", "utils.figures",
                 "cli.evaluate_reconstruction", "analysis.pca",
                 "cli.extract_pca", "cli.encode_granules",
                 "cli.analyze_reconstruction", "analysis.probes",
                 "cli.probe_analysis", "infer.export_codec",
                 "cli.export_codec", "cli.compute_stats",
                 "cli.prepare_tiles", "cli.download", "ops.morphology",
                 "analysis.connectomics", "utils.h5", "utils.devices",
                 "interop.gpt_ckpt", "interop.optax_state"):
        assert f"tempo_tpu_torch.{name}" in mods
    code = (
        "import sys, importlib\n"
        "before = set(sys.modules)\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'tempo_tpu', 'yaml', "
        "'matplotlib', 'msgpack', 'h5py', 'netCDF4'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_chip_smoke_imports_nothing_the_card_lacks():
    """Every import statement of chip_smoke.py, those inside its functions
    included, names none of the packages the card's machine lacks."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parents[1] / "chip_smoke.py")
                     .read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert "tempo_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "optax", "tempo_tpu", "yaml",
                        "matplotlib", "msgpack", "h5py", "netCDF4"}


def test_host_only_packages_are_imported_inside_functions():
    """utils/h5.py imports h5py (and connectomics cv2) only inside the
    functions that use it; chip_smoke.py imports only the standard
    library at module level (the port and torch inside main)."""
    import ast
    import sys as _sys
    from pathlib import Path

    root = Path(__file__).parents[1]
    for rel, lazy in (("tempo_tpu_torch/utils/h5.py", "h5py"),
                      ("tempo_tpu_torch/analysis/connectomics.py", "cv2")):
        tree = ast.parse((root / rel).read_text())
        top = {a.name.split(".")[0] for node in tree.body
               if isinstance(node, ast.Import) for a in node.names}
        top |= {node.module.split(".")[0] for node in tree.body
                if isinstance(node, ast.ImportFrom) and node.module}
        inner = {a.name for node in ast.walk(tree)
                 if isinstance(node, ast.Import) for a in node.names}
        assert lazy not in top and lazy in inner, rel
    tree = ast.parse((root / "chip_smoke.py").read_text())
    top = {a.name.split(".")[0] for node in tree.body
           if isinstance(node, ast.Import) for a in node.names}
    top |= {node.module.split(".")[0] for node in tree.body
            if isinstance(node, ast.ImportFrom) and node.module}
    assert top - {"__future__"} <= set(_sys.stdlib_module_names), top


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_vae(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoencoderKL(VAEConfig(**TINY), device="cuda")
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GranuleCodec(model)
    assert tempo_tpu_torch.resolve_device("cpu") == torch.device("cpu")


def test_wrappers_refuse_other_devices():
    x = torch.zeros(1, 4, 4, 8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        cuda_gn.check_cuda_input(x, "x")


def test_refuse_grad_only_when_building_a_graph():
    w = torch.ones(3, requires_grad=True)
    with pytest.raises(NotImplementedError):
        cuda_gn.refuse_grad(torch.ones(3), w)
    with torch.no_grad():
        cuda_gn.refuse_grad(w)
    with torch.inference_mode():
        cuda_gn.refuse_grad(w)


def test_lm_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from tempo_tpu_torch.infer.export_lm import live_paged_surface
    from tempo_tpu_torch.infer.paged import PagedLMServer
    from tempo_tpu_torch.nn.transformer import Transformer, TransformerConfig

    cfg = TransformerConfig(in_size=31, block_size=32, n_layer=1, n_head=2,
                            n_embd=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer(cfg)
    model = Transformer(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        live_paged_surface(model, page_size=8)
    surface = live_paged_surface(model, page_size=8, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedLMServer(surface=surface)
    PagedLMServer(surface=surface, device="cpu")


def test_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from tempo_tpu_torch.cli.train_gpt import main
    from tempo_tpu_torch.nn.transformer import (Transformer,
                                                TransformerConfig,
                                                make_gpt_optimizer)
    from tempo_tpu_torch.train.state import create_train_state
    from tempo_tpu_torch.train.step import lm_loss_fn
    from tempo_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = Transformer(TransformerConfig(in_size=17, block_size=16,
                                          n_layer=1, n_head=2, n_embd=32),
                        device="cpu")
    tx = make_gpt_optimizer(model, 0.1, 1e-3, (0.9, 0.95))
    state = create_train_state(model, tx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(lm_loss_fn(model), tx, state, tmp_path / "a")
    Trainer(lm_loss_fn(model), tx, state, tmp_path / "b", device="cpu")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"output_dir: {tmp_path / 'run'}\n"
        "data: {synthetic: {vocab_size: 17, length: 2000}, batch_size: 2}\n"
        "model: {n_layer: 1, n_head: 2, n_embd: 32, block_size: 16}\n"
        "training: {n_steps: 2}\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(str(cfg))


def test_vae_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from tempo_tpu_torch.cli.train_vae import main
    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.train.state import create_train_state, make_optimizer
    from tempo_tpu_torch.train.step import vae_loss_fn
    from tempo_tpu_torch.train.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = AutoencoderKL(VAEConfig(**TINY), device="cpu")
    tx = make_optimizer()
    state = create_train_state(model, tx)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(vae_loss_fn(model), tx, state, tmp_path / "a")
    Trainer(vae_loss_fn(model), tx, state, tmp_path / "b", device="cpu")
    tiles = make_tile_shards(tmp_path / "tiles", n_files=1)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(
        f"output_dir: {tmp_path / 'run'}\n"
        f"data: {{train_dir: {tiles}, batch_size: 2, min_buffer_size: 2}}\n"
        "model: {shape: [8, 16, 16], chs: [16, 12, 8], z_channels: 4,"
        " embed_dim: 4, n_attention_heads: 2, norm_groups: 4}\n"
        "training: {n_steps: 2}\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(str(cfg))
    assert not (tmp_path / "run").exists()


def test_trainer_run_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """train_vae.run and train_gpt.run (a config dict, no YAML) resolve
    device None to CUDA and raise without it; train_vae's before it writes
    anything."""
    from tempo_tpu_torch.cli import train_gpt, train_vae
    from tempo_tpu_torch.data.synthetic import make_tile_shards

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiles = make_tile_shards(tmp_path / "tiles", n_files=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_vae.run({
            "output_dir": str(tmp_path / "vae"),
            "data": {"train_dir": str(tiles), "batch_size": 2,
                     "min_buffer_size": 2},
            "model": {"shape": [8, 16, 16], "chs": [16, 12, 8],
                      "z_channels": 4, "embed_dim": 4,
                      "n_attention_heads": 2, "norm_groups": 4},
            "training": {"n_steps": 2, "checkpoint_format": "async",
                         "metrics_jsonl": True, "profile_steps": [0, 1]}})
    assert not (tmp_path / "vae").exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_gpt.run({
            "output_dir": str(tmp_path / "gpt"),
            "data": {"synthetic": {"vocab_size": 17, "length": 2000},
                     "batch_size": 2},
            "model": {"n_layer": 1, "n_head": 2, "n_embd": 32,
                      "block_size": 16},
            "training": {"n_steps": 2, "checkpoint_format": "async"}})


def test_l2_training_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    from tempo_tpu_torch.cli.train_vae_l2 import main, run
    from tempo_tpu_torch.data.device_buffer import DeviceTileBuffer
    from tempo_tpu_torch.data.synthetic import make_tile_shards
    from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head, build_vae_l2

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VAEWithL2Head(VAEConfig(**TINY), (16, 16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_vae_l2(TINY, (16, 16))
    VAEWithL2Head(VAEConfig(**TINY), (16, 16), device="cpu")
    tiles = make_tile_shards(tmp_path / "tiles" / "train", n_files=1,
                             l2_products=["NO2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DeviceTileBuffer(tiles, batch_size=2, slots=1)
    DeviceTileBuffer(tiles, batch_size=2, slots=1, device="cpu")
    cfg = {"output_dir": str(tmp_path / "run"),
           "data": {"data_dir": str(tmp_path / "tiles"), "batch_size": 2,
                    "loader": "device", "buffer_slots": 1},
           "model": dict(TINY, shape=[8, 16, 16]),
           "l2": {"components": ["NO2"], "mlp_hidden": [16, 16]},
           "training": {"n_steps": 2}}
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run(cfg)
    (tmp_path / "cfg.yaml").write_text(json.dumps(cfg))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(str(tmp_path / "cfg.yaml"))
    assert not (tmp_path / "run").exists()


def test_analysis_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The analysis path: its library entry points and every analysis
    CLI's ``run`` raise before they write anything."""
    import numpy as np

    from tempo_tpu_torch.analysis.probes import init_probe_params, train_probe
    from tempo_tpu_torch.analysis.spectrum import pk_op
    from tempo_tpu_torch.cli import (analyze_reconstruction, encode_granules,
                                     evaluate_reconstruction, extract_pca,
                                     probe_analysis)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pk_op(16, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_probe_params(4, ())
    x = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_probe(x, x[:, 0], x, x[:, 0], {"max_epochs": 1})
    out = tmp_path / "out"
    for cli, cfg in (
            (evaluate_reconstruction, {"exp_dir": str(tmp_path),
                                       "output_dir": "eval"}),
            (extract_pca, {"output_dir": str(out), "input_dir": "x",
                           "normalization": {}, "sampling": {}, "pca": {}}),
            (encode_granules, {"output_dir": str(out), "model": {},
                               "nc_files": ["x.nc"]}),
            (analyze_reconstruction, {"output_dir": str(out), "data": {},
                                      "model": {}}),
            (probe_analysis, {"output_dir": str(out), "data": {},
                              "model": {}, "probe": {}, "components": {}})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.run(cfg)
        assert not out.exists() and not (tmp_path / "eval").exists()


def test_export_and_data_prep_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """load_exported and the export and data-preparation CLIs' ``run``
    raise before they write anything."""
    from tempo_tpu_torch.cli import compute_stats, export_codec, prepare_tiles
    from tempo_tpu_torch.infer.export_codec import load_exported

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported(tmp_path)
    out = tmp_path / "out"
    for cli, cfg in (
            (export_codec, {"output_dir": str(out),
                            "model": {"checkpoint_path": "c.pt",
                                      "training_config_path": "t.yaml"}}),
            (compute_stats, {"output_dir": str(out),
                             "input_dir": str(tmp_path)}),
            (prepare_tiles, {"output_dir": str(out),
                             "input_dir": str(tmp_path),
                             "processing": {}})):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.run(cfg)
        assert not out.exists()


def test_speculative_and_online_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The speculative servers, the online front and serve_lm's new modes
    resolve device None to CUDA and raise without it; the CPU works when
    asked for."""
    from tempo_tpu_torch.cli.serve_lm import build_server
    from tempo_tpu_torch.infer.export_lm import export_lm
    from tempo_tpu_torch.infer.paged import PagedLMServer
    from tempo_tpu_torch.infer.serving import (ContinuousLMServer,
                                               OnlineLMServer,
                                               SpeculativeLMServer)
    from tempo_tpu_torch.nn.transformer import Transformer, TransformerConfig

    cfg = TransformerConfig(in_size=31, block_size=32, n_layer=1, n_head=2,
                            n_embd=32)
    art = export_lm(Transformer(cfg, device="cpu", seed=0).state_dict(), cfg,
                    tmp_path / "lm", page_size=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = {"draft_dir": art, "k_draft": 2}
    for make in (lambda **d: SpeculativeLMServer(art, art, **d),
                 lambda **d: ContinuousLMServer(art, **spec, **d),
                 lambda **d: PagedLMServer(art, **spec, **d),
                 lambda **d: OnlineLMServer(art, **spec, **d),
                 lambda **d: OnlineLMServer(art, scheduler="paged", **d)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        srv = make(device="cpu")
        if isinstance(srv, OnlineLMServer):
            srv.close()
    for config in ({"scheduler": "speculative", "draft_artifacts": str(art)},
                   {"scheduler": "continuous", "online": True}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_server({"artifacts": str(art), **config})


def test_lm_loaders_import_no_model_code():
    """Importing infer/export_lm.py, whose loaders serve the exported
    programs, imports no model code (tempo_tpu_torch.nn)."""
    code = (
        "import sys\n"
        "import tempo_tpu_torch.infer.export_lm\n"
        "print(sorted(m for m in sys.modules\n"
        "             if m.startswith('tempo_tpu_torch.nn')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def test_lm_loaders_default_to_cuda_and_raise_without_it(monkeypatch,
                                                        tmp_path):
    """Every loader of infer/export_lm.py, zero_cache and
    greedy_decode_exported resolve device None to CUDA and raise without
    it, before they read the directory."""
    from tempo_tpu_torch.infer import export_lm as e

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = {"max_seq": 8, "n_kv_head": 2, "n_head": 2, "n_embd": 16,
            "compute_dtype": "float32", "n_layer": 1}
    for call in (lambda: e.load_exported_lm(tmp_path),
                 lambda: e.load_exported_continuous(tmp_path),
                 lambda: e.load_exported_extend_rows(tmp_path),
                 lambda: e.load_exported_decode_k(tmp_path),
                 lambda: e.load_exported_decode_k_sample(tmp_path),
                 lambda: e.load_exported_paged(tmp_path),
                 lambda: e.load_exported_extend_paged(tmp_path),
                 lambda: e.load_exported_paged_k(tmp_path),
                 lambda: e.load_exported_speculative(tmp_path),
                 lambda: e.greedy_decode_exported(tmp_path, [[1]], 2),
                 lambda: e.zero_cache(meta, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    assert e.zero_cache(meta, 2, "cpu")[0][0].shape == (2, 8, 2, 8)


def test_model_option_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, tmp_path):
    """The GPT family's options: MoE, int8, dropout models, a LoRA
    fine-tune run and its adapters, and the beam searches, live and over
    artifacts, default to CUDA and raise without it; their modules are
    among those that import nothing the card lacks."""
    from tempo_tpu_torch.cli.train_gpt import run
    from tempo_tpu_torch.infer.serving import LMServer
    from tempo_tpu_torch.nn.lora import LoRA, init_lora
    from tempo_tpu_torch.nn.transformer import Transformer, TransformerConfig

    assert {f"tempo_tpu_torch.nn.{m}" for m in ("moe", "quant", "lora",
                                                "beam")} <= set(
        _port_modules())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    base = dict(in_size=17, block_size=16, n_layer=1, n_head=2, n_embd=32)
    for kw in (dict(n_experts=2), dict(n_experts=2, expert_top_k=2,
                                       quantize="int8"),
               dict(quantize="int8"), dict(dropout=0.1)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Transformer(TransformerConfig(**base, **kw))
        Transformer(TransformerConfig(**base, **kw), device="cpu")
    model = Transformer(TransformerConfig(**base, n_experts=2), device="cpu")
    adapters = init_lora(model, 2)
    assert {t.device.type for ab in adapters.values()
            for t in ab.values()} == {"cpu"}
    LoRA(model, adapters)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run({"output_dir": str(tmp_path / "ft"),
             "data": {"synthetic": {"vocab_size": 17, "length": 2000},
                      "batch_size": 2},
             "model": {"n_layer": 1, "n_head": 2, "n_embd": 32,
                       "block_size": 16, "n_experts": 2},
             "training": {"n_steps": 2},
             "finetune": {"lora_rank": 2,
                          "base_checkpoint": str(tmp_path / "x.pt")}})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LMServer(tmp_path)
