#!/usr/bin/env python3
"""Train a generative model on TEMPO tiles on one GPU or data-parallel
over many, variational diffusion (VDM) or stochastic flow matching (SFM),
in pixel space or in the latent space of a frozen VAE; counterpart of
tempo_tpu/cli/train_diffusion.py.

    python -m tempo_tpu_torch.cli.train_diffusion config.yaml [--overwrite] [--debug]
    torchrun --nproc-per-node=N -m tempo_tpu_torch.cli.train_diffusion config.yaml

The same config schema (``family``, ``latent``, ``score_model``,
``diffusion``, ``sampling`` beside train_vae's ``data``, ``optimizer`` and
``training``), directory contract and artifacts: config.yaml copied into
output_dir, checkpoints/ckpt_step=NNNNNN.pt, figures/
reconstructions_step_NNNNNN.png at every checkpoint (VDM: a denoising round
trip from t = 0.25), summary plots, metrics.json, figures/samples_final.npy
and .png (the end-of-run panel: ``sampling.n_samples`` samples over
``sampling.n_steps`` steps, decoded to pixels in latent mode) and
training_info.yaml with the JAX CLI's keys.

The score (or velocity) model is a CUNet (nn/unet.py) over the tile or
latent shape; its GroupNorms run through K1 and K2 in fp32. With
``latent:`` the VAE of ``latent.vae_model`` is loaded from
``latent.vae_checkpoint`` (a .pt of the port's train_vae or the JAX
package's .msgpack, through train/checkpoint.py ``load_params``) and
frozen: it is no submodule of the trained model, its parameters do not
require grad, and it stays out of the optimizer, the checkpoints and the
parameter count. Its
encode (bf16 through K1/K2) runs without gradients inside every step,
drawing a fresh posterior sample from the step's generator, scaled by
``latent.scale``; the latent reaches the CUNet in fp32. The model's
dropout never drops (``dropout_prob`` builds the modules only), as in the
JAX package. Weights come from the config's seed through the port's own
initializer, so a run does not reproduce the JAX package's weights.

Under torchrun (one process per GPU, parallel/mesh.py) the VDM, SFM or
CUNet trains under DDP: each rank loads ``batch_size //
LOCAL_WORLD_SIZE`` tiles from ``seed + 1000 + 1000 * rank`` (JAX splits
its process's batch over the local devices) and draws its own times and
noise; the frozen VAE is not wrapped (each rank encodes its own batch).
Rank 0 writes the run's files and samples the end-of-run panel;
training_info's ``n_devices`` is the world size.

``run(config_dict)`` is the same run from a dict: it needs no YAML reader
and writes config.yaml and training_info.yaml as JSON.
``training.checkpoint_format: async`` writes the same checkpoints on a
background thread. Not ported (NotImplementedError):
``training.checkpoint_format: sharded`` and a sharded checkpoint directory
as ``latent.vae_checkpoint`` (M13).
"""

from __future__ import annotations

from datetime import datetime
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

from tempo_tpu_torch.cli import (host_batch, parallelize, run_cli,
                                 start_run_directory)
from tempo_tpu_torch.data.loader import TileLoader
from tempo_tpu_torch.device import resolve_device
from tempo_tpu_torch.models.diffusion import VDM
from tempo_tpu_torch.models.diffusion import sample as vdm_sample
from tempo_tpu_torch.models.flow import SFM
from tempo_tpu_torch.models.flow import predict as flow_predict
from tempo_tpu_torch.models.vae import build_vae
from tempo_tpu_torch.nn.unet import CUNet
from tempo_tpu_torch.parallel.mesh import (is_primary, process_count,
                                           process_group, process_index)
from tempo_tpu_torch.train import png
from tempo_tpu_torch.train.checkpoint import (check_format, load_params,
                                              resolve_resume_from)
from tempo_tpu_torch.train.state import (create_train_state,
                                         make_optimizer_from_config)
from tempo_tpu_torch.train.step import diffusion_loss_fn, flow_loss_fn
from tempo_tpu_torch.train.trainer import Trainer
from tempo_tpu_torch.utils.config import (load_config, require_keys,
                                          save_json_yaml)
from tempo_tpu_torch.utils.figures import pyplot


def validate_config(config: Dict[str, Any]) -> None:
    require_keys(config, ["output_dir", "data", "data.train_dir",
                          "score_model", "training"])
    train_dir = Path(config["data"]["train_dir"])
    if not train_dir.exists():
        raise ValueError(f"FATAL: Training directory doesn't exist: "
                         f"{train_dir}")
    if "latent" in config:
        require_keys(config, ["latent.vae_checkpoint", "latent.vae_model"])
        ckpt = Path(config["latent"]["vae_checkpoint"])
        if not ckpt.exists():
            raise ValueError(f"FATAL: VAE checkpoint doesn't exist: {ckpt}")
        if ckpt.is_dir():
            raise NotImplementedError(
                f"latent.vae_checkpoint {ckpt}: sharded checkpoint "
                f"directories wait for the sharded checkpoint format "
                f"(ROADMAP Queue 1, M13), which is not ported; give a .pt "
                f"or .msgpack checkpoint")
    check_format(config["training"].get("checkpoint_format", "msgpack"))


def _build_generative(train_config: Dict[str, Any], model_shape,
                      device: torch.device, seed: int = 0):
    """(model, family) over ``model_shape`` from a train_diffusion config,
    shared by the train and sample CLIs so that a run directory rebuilds
    the model it trained. family 'vdm' (default) wraps the CUNet as a VDM
    score model; 'sfm' as the velocity model of a flow from N(0, 1), the
    source sample fed back as spatial conditioning. Weights from a
    generator seeded with ``seed``."""
    family = str(train_config.get("family", "vdm")).lower()
    if family not in ("vdm", "sfm"):
        raise ValueError(f"FATAL: unknown family {family!r} (vdm | sfm)")
    score_cfg = dict(train_config["score_model"])
    kw = dict(shape=tuple(model_shape),
              chs=tuple(score_cfg.get("chs", [64, 96])),
              norm_groups=score_cfg.get("norm_groups", 8),
              n_attention_heads=score_cfg.get("n_attention_heads", 4),
              dropout_prob=score_cfg.get("dropout_prob", 0.0),
              t_conditioning=True,
              t_embedding_dim=score_cfg.get("t_embedding_dim", 64),
              device=device, seed=seed)
    if family == "sfm":
        velocity = CUNet(s_conditioning_channels=int(model_shape[-1]), **kw)
        return SFM(velocity), family
    diff_cfg = dict(train_config.get("diffusion", {}))
    model = VDM(CUNet(**kw),
                noise_schedule=diff_cfg.get("noise_schedule", "fixed_linear"),
                gamma_min=float(diff_cfg.get("gamma_min", -13.3)),
                gamma_max=float(diff_cfg.get("gamma_max", 5.0)),
                antithetic_time_sampling=diff_cfg.get(
                    "antithetic_time_sampling", True),
                data_noise=float(diff_cfg.get("data_noise", 1.0e-3)),
                seed=seed + 1)
    return model, family


def _make_sampler(model, family: str, model_shape, n_samples: int,
                  n_steps: int, decode_fn=None, method: str = "euler",
                  eta: float = 0.0):
    """generator -> pixel (or latent) samples for either family: ancestral
    or DDIM sampling (VDM) or SDE integration from a standard-normal
    source (SFM), then ``decode_fn`` where given.

    ``method`` is family-scoped: euler|lm for sfm, ancestral|ddim for vdm
    (the shared default 'euler' means 'ancestral' there); ``eta`` is the
    DDIM noise knob (0 deterministic, 1 ancestral-equivalent)."""
    shape = (n_samples,) + tuple(model_shape)

    def _sample(generator: torch.Generator) -> torch.Tensor:
        if family == "sfm":
            x0 = torch.randn(shape, generator=generator,
                             device=model.device)
            z = flow_predict(model, x0, generator,
                             n_sampling_steps=n_steps, method=method)
        else:
            z = vdm_sample(model, generator, n_samples, n_steps,
                           tuple(model_shape),
                           method="ancestral" if method == "euler"
                           else method, eta=eta)
        return decode_fn(z) if decode_fn is not None else z

    return _sample


def _build_codec(latent_cfg: Dict[str, Any], sample_shape,
                 device: torch.device):
    """(encode_fn, decode_fn, latent_shape, vae) for a frozen trained VAE.

    encode_fn(x, generator) samples the posterior (bf16 through K1/K2,
    fp32 out) and applies the LDM latent scale; decode_fn inverts the
    scale and decodes, in fp32 out. Neither builds a graph."""
    vae, cfg = build_vae(dict(latent_cfg["vae_model"]), device=device)
    load_params(latent_cfg["vae_checkpoint"], vae)
    vae.eval().requires_grad_(False)
    scale = float(latent_cfg.get("scale", 1.0))
    h, w = sample_shape[1] // cfg.spatial_factor, (
        sample_shape[2] // cfg.spatial_factor)

    def encode_fn(x: torch.Tensor, generator: torch.Generator):
        with torch.no_grad():
            return vae.encode(x).sample(generator) * scale

    def decode_fn(z: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return vae.decode(z / scale).float()

    return encode_fn, decode_fn, (sample_shape[0], h, w, cfg.embed_dim), vae


def _save_sample_panel(path: Path, samples: np.ndarray) -> None:
    """A row of generated tiles, the first channel of each (viridis);
    through matplotlib where it is installed, else train/png.py."""
    n = samples.shape[0]
    plt = pyplot()
    if plt is None:
        png.write_png(path, png.grid([[png.colorize(samples[i, :, :, 0],
                                                    "viridis")
                                       for i in range(n)]]))
        return
    fig, axes = plt.subplots(1, n, figsize=(2.2 * n, 2.4))
    for i, ax in enumerate(np.atleast_1d(axes)):
        ax.imshow(samples[i, :, :, 0], cmap="viridis")
        ax.set_title(f"sample {i}", fontsize=8)
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _make_recon_fn(encode_fn, decode_fn):
    """(model, x, generator) -> the VDM's denoising round trip for the
    periodic figures: encode, diffuse to t = 0.25, one-shot x0-hat from
    the predicted noise, decode."""

    def recon_fn(model: VDM, x: torch.Tensor, generator: torch.Generator):
        z = encode_fn(x, generator) if encode_fn is not None else x
        b = z.shape[0]
        times = torch.full((b,), 0.25, device=z.device)
        noise = torch.randn(z.shape, generator=generator, device=z.device)
        zt, gamma_t = model.variance_preserving_map(z, times, noise)
        eps_hat = model.get_pred_noise(zt, gamma_t.reshape(b))
        z0_hat = (zt - VDM.sigma(gamma_t) * eps_hat) / VDM.alpha(gamma_t)
        return decode_fn(z0_hat) if decode_fn is not None else z0_hat

    return recon_fn


def run(config: Dict[str, Any], overwrite: bool = False, debug: bool = False,
        device: Union[str, torch.device, None] = None,
        config_path: Optional[str] = None) -> Tuple[Trainer, Dict, Dict]:
    """Train as the config dict says, on ``device`` (None: CUDA, raising
    without it); returns the Trainer, its throughput stats and the
    training info (None on a rank other than 0). ``config_path`` is copied
    into the run as config.yaml; without it the dict is written there."""
    validate_config(config)
    with process_group(config, device) as mesh:
        return _run(config, overwrite, debug, device, config_path, mesh)


def _run(config, overwrite, debug, device, config_path, mesh):
    dev = resolve_device(device)
    output_dir = start_run_directory(config, overwrite, config_path,
                                     subdirs=("checkpoints", "figures"))

    seed = config.get("seed", 42)
    if debug:
        print("DEBUG MODE: Reduced training steps and data")
        config["training"]["n_steps"] = min(
            200, config["training"].get("n_steps", 10000))
        config["data"]["min_buffer_size"] = min(
            10, config["data"].get("min_buffer_size", 200))
        config["training"]["save_every"] = 50
        config["training"]["val_every"] = 25
        config["training"]["plot_every"] = 20

    data_cfg = config["data"]
    print("\nLoading training data...")
    batch_size = host_batch(data_cfg.get("batch_size", 16), mesh)
    rank_offset = 1000 * process_index()
    train_loader = TileLoader(
        data_dir=data_cfg["train_dir"], batch_size=batch_size,
        min_buffer_size=data_cfg.get("min_buffer_size", 200),
        seed=seed + 1000 + rank_offset, prefetch=data_cfg.get("prefetch", 2),
        num_threads=data_cfg.get("loader_threads", 2), verbose=True)
    val_loader = None
    if "val_dir" in data_cfg:
        val_loader = TileLoader(
            data_dir=data_cfg["val_dir"], batch_size=batch_size,
            min_buffer_size=data_cfg.get("val_min_buffer_size", 100),
            seed=seed + 1001 + rank_offset, num_threads=1, verbose=True)

    try:
        probe = next(iter(train_loader))
        sample_shape = (2,) + tuple(probe.shape[1:])
        encode_fn = decode_fn = None
        model_shape = sample_shape[1:]
        if "latent" in config:
            print("\nBuilding frozen VAE codec for latent-space training...")
            encode_fn, decode_fn, z_shape, _ = _build_codec(
                config["latent"], sample_shape, dev)
            model_shape = z_shape[1:]
            print(f"Latent shape: {model_shape}")

        model, family = _build_generative(config, model_shape, dev, seed)
        print(f"\nInitialized {family} model")
        n_params = sum(p.numel() for p in model.parameters())
        print(f"Score-model + schedule parameters: {n_params:,}")

        train_cfg = config["training"]
        tx = make_optimizer_from_config(
            config.get("optimizer", {}),
            n_steps=int(train_cfg.get("n_steps", 10_000)))
        state = parallelize(create_train_state(model, tx, seed + 2), tx,
                            mesh, fsdp=False)
        if family == "sfm":
            # a flow has no denoising round trip: no recon figures; the
            # end-of-run sample panel is the visual artifact
            loss_fn, recon_fn = flow_loss_fn(model, encode_fn), None
        else:
            loss_fn = diffusion_loss_fn(model, encode_fn)
            recon_fn = _make_recon_fn(encode_fn, decode_fn)
        trainer = Trainer(
            loss_fn=loss_fn, tx=tx, state=state, output_dir=output_dir,
            save_every=train_cfg.get("save_every", 1000),
            val_every=train_cfg.get("val_every", 100),
            log_every=train_cfg.get("log_every", 10),
            plot_every=train_cfg.get("plot_every", 50),
            grad_accum=int(train_cfg.get("grad_accum", 1)), device=dev,
            recon_fn=recon_fn,
            checkpoint_format=train_cfg.get("checkpoint_format", "msgpack"))
        resume_from = resolve_resume_from(train_cfg, output_dir)
        if resume_from:
            print(f"\nResuming from checkpoint: {resume_from}")
            trainer.load_checkpoint(resume_from)

        n_steps = train_cfg["n_steps"]
        print(f"\nStarting {family} training for {n_steps} steps...")
        start_time = datetime.now()
        stats = trainer.train(
            train_iter=iter(train_loader),
            val_iter_factory=(None if val_loader is None
                              else lambda: iter(val_loader)),
            n_steps=n_steps)
        end_time = datetime.now()
    finally:
        train_loader.close()
        if val_loader is not None:
            val_loader.close()
    if not is_primary():
        return trainer, stats, None

    # the end-of-run sample panel, decoded to pixels in latent mode
    samp_cfg = dict(config.get("sampling", {}))
    n_samples = int(samp_cfg.get("n_samples", 8))
    n_samp_steps = int(samp_cfg.get("n_steps", 50 if debug else 250))
    print(f"\nSampling {n_samples} tiles ({n_samp_steps} steps)...")
    sampler = _make_sampler(model, family, model_shape, n_samples,
                            n_samp_steps, decode_fn=decode_fn,
                            method=samp_cfg.get("method", "euler"),
                            eta=float(samp_cfg.get("eta", 0.0)))
    samples = sampler(torch.Generator(device=dev).manual_seed(seed + 3))
    samples = samples.float().cpu().numpy()
    np.save(output_dir / "figures" / "samples_final.npy", samples)
    _save_sample_panel(output_dir / "figures" / "samples_final.png", samples)

    info = {
        "seed": seed,
        "family": family,
        "n_devices": process_count(),
        "n_params": int(n_params),
        "latent_space": "latent" in config,
        "model_shape": [int(s) for s in model_shape],
        "training_time": str(end_time - start_time),
        "samples_per_sec": float(stats["samples_per_sec"]),
    }
    save_json_yaml(info, output_dir / "training_info.yaml")
    print("\nDone!")
    return trainer, stats, info


def main(config_path: str, overwrite: bool = False, debug: bool = False,
         device: Union[str, torch.device, None] = None) -> None:
    """Train as the YAML config at ``config_path`` says."""
    run(load_config(config_path), overwrite, debug, device, config_path)


if __name__ == "__main__":
    run_cli(main, "Train a VDM diffusion model on TEMPO tiles (one GPU)")
