"""Worker processes for the port's multi-process tests
(tests/test_torch_parallel*.py).

``launch`` starts one spawned process per rank, joins them in a gloo group
through a file store under the test's directory (no fixed port: the suite
runs in parallel), and joins them with its own timeout: a rank that hangs
(a rendezvous that never completes) is killed and the test fails. The
children import only torch, numpy and the port, never JAX: the JAX
references are computed in the test's own process. Each worker below is
``fn(rank, world, *args)``; what it returns comes back to the test.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

JOIN_TIMEOUT_S = 120.0
RENDEZVOUS_TIMEOUT_S = 60.0


def launch(fn, world: int, workdir, *args, join: bool = True,
           ranks=None, timeout_s: float = JOIN_TIMEOUT_S):
    """Run ``fn(rank, world, *args)`` on ``world`` ranks (``ranks``: only
    these start) and return their results in rank order. ``join=False``
    leaves joining the group to ``fn`` (the CLIs' ``distributed:``
    section), with RANK set. Raises TimeoutError (after killing every
    child) past ``timeout_s``, RuntimeError with a child's traceback when
    one fails."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ranks = list(range(world) if ranks is None else ranks)
    ctx = mp.get_context("spawn")
    rendezvous_s = min(RENDEZVOUS_TIMEOUT_S, timeout_s / 2)
    procs = [ctx.Process(target=_child, daemon=True,
                         args=(fn, r, world, str(workdir), join,
                               rendezvous_s, args))
             for r in ranks]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in zip(ranks, procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(10)
    errors = [(workdir / f"error{r}.txt") for r in ranks]
    text = "\n".join(e.read_text() for e in errors if e.exists())
    if hung:
        raise TimeoutError(f"ranks {hung} of {world} still running after "
                           f"{timeout_s} s; killed\n{text}")
    failed = [r for r, p in zip(ranks, procs) if p.exitcode != 0]
    if failed:
        raise RuntimeError(f"ranks {failed} of {world} failed\n{text}")
    return [torch.load(workdir / f"result{r}.pt", weights_only=False)
            for r in ranks]


def _child(fn, rank, world, workdir, join, rendezvous_s, args):
    torch.set_num_threads(1)
    try:
        if join:
            dist.init_process_group(
                "gloo", init_method=f"file://{workdir}/store", rank=rank,
                world_size=world,
                timeout=datetime.timedelta(seconds=rendezvous_s))
        else:
            os.environ["RANK"] = str(rank)
        result = fn(rank, world, *args)
        torch.save(result, Path(workdir) / f"result{rank}.pt")
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        (Path(workdir) / f"error{rank}.txt").write_text(
            f"rank {rank}:\n{traceback.format_exc()}")
        sys.stdout.flush()
        os._exit(1)


# ------------------------------------------------------------- helpers

def rows(rank: int, world: int, n: int) -> slice:
    """A rank's contiguous slice of a global batch of n."""
    return slice(rank * n // world, (rank + 1) * n // world)


def posterior_feed(noises, sl: slice):
    """A DiagonalGaussian.sample that takes the given global noises in
    turn, each cut to this rank's rows (JAX draws for the global
    batch)."""
    it = iter(noises)
    return (lambda self, generator=None: self.mean + self.std
            * torch.from_numpy(np.array(next(it)[sl])))


def feed_posterior(noises, sl: slice) -> None:
    """Patch the port's posterior sample with ``posterior_feed`` (in a
    worker process, which ends with its run)."""
    from tempo_tpu_torch.nn.distributions import DiagonalGaussian

    DiagonalGaussian.sample = posterior_feed(noises, sl)


def take(batch, sl: slice):
    if isinstance(batch, dict):
        return {k: torch.from_numpy(np.array(v[sl])) for k, v in batch.items()}
    return torch.from_numpy(np.array(batch[sl]))


def parallel_state(model, tx, mode: str, seed: int = 3):
    """A train state over ``model`` as ``mode`` says: 'ddp', 'fsdp' or
    'none' (one device)."""
    from tempo_tpu_torch.parallel import fsdp, mesh
    from tempo_tpu_torch.train import state as pstate

    state = pstate.create_train_state(model, tx, seed)
    if mode == "ddp":
        return mesh.shard_state(state, mesh.create_mesh("cpu"))
    if mode == "fsdp":
        return fsdp.shard_state_fsdp(state, mesh.create_mesh("cpu"), tx)
    return state


def gathered(model):
    from tempo_tpu_torch.parallel.fsdp import full_state_dict

    return {k: v.detach().clone() for k, v in full_state_dict(model).items()}


def vae(cfg: dict, state_dict=None, cls: str = "vae", hidden=None):
    from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from tempo_tpu_torch.models.vae_l2 import VAEWithL2Head

    if cls == "l2":
        model = VAEWithL2Head(VAEConfig(**cfg), hidden, device="cpu", seed=0)
    else:
        model = AutoencoderKL(VAEConfig(**cfg), device="cpu", seed=0)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    return model


# ------------------------------------------------------------- workers

def vae_steps(rank, world, mode, cfg, state_dict, batches, noises,
              grad_accum=1, loss="posterior"):
    """The VAE recipe (clip 1.0, AdamW lr 1e-3, decay 0.05) for
    len(batches) steps on this rank's rows of each global batch, the
    posterior fed the rows of ``noises`` (loss 'mode': the posterior's
    mode, no draw). Returns every step's metrics and the gathered
    parameters after."""
    from tempo_tpu_torch.models.vae import vae_loss
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    sl = rows(rank, world, len(batches[0]))
    if loss == "posterior":
        feed_posterior(noises, sl)
    model = vae(cfg, state_dict)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = parallel_state(model, tx, mode)
    loss_fn = pstep.vae_loss_fn(model)
    if loss == "mode":
        def loss_fn(m, batch, generator):
            recon, post = m(batch, sample_posterior=False)
            return vae_loss(batch, recon, post, m.logvar, m.config)
    step = pstep.make_train_step(loss_fn, tx, grad_accum=grad_accum)
    metrics = []
    for b in batches:
        state, m = step(state, take(b, sl))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": gathered(model),
            "sharded": sum(type(p).__name__ == "DTensor"
                           for p in model.parameters())}


def l2_step(rank, world, cfg, hidden, state_dict, batch, noises):
    """One step of the L2 recipe under DDP on this rank's rows of a dict
    batch (its NaN share differs per rank), both posterior draws fed.
    Returns the metrics and the parameters after."""
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    sl = rows(rank, world, len(batch["spectral"]))
    feed_posterior(noises, sl)
    model = vae(cfg, state_dict, "l2", hidden)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = parallel_state(model, tx, "ddp")
    step = pstep.make_train_step(pstep.vae_l2_loss_fn(model), tx)
    state, m = step(state, take(batch, sl))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": gathered(model)}


def vdm_latent_step(rank, world, vae_cfg, vae_sd, vdm_kw, score_kw, vdm_sd,
                    batches, post_noises, draws, scale):
    """The latent VDM under DDP: the frozen VAE (not wrapped) encodes this
    rank's rows with the fed posterior noise, times the scale, and the
    VDM's loss takes the rows of the fed (noise, times, noise_0); AdamW
    lr 1e-3 without clip. Returns the metrics and parameters after."""
    from tempo_tpu_torch.models.diffusion import VDM
    from tempo_tpu_torch.nn.unet import CUNet
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    sl = rows(rank, world, len(batches[0]))
    feed_posterior(post_noises, sl)
    frozen = vae(vae_cfg, vae_sd).eval().requires_grad_(False)
    model = VDM(CUNet(device="cpu", seed=0, **score_kw), seed=0, **vdm_kw)
    model.load_state_dict(vdm_sd)
    fed = iter(draws)

    def loss_fn(m, batch, generator):
        with torch.no_grad():
            z = frozen.encode(batch).sample(generator) * scale
        noise, times, noise_0 = (torch.from_numpy(np.array(a[sl]))
                                 for a in next(fed))
        loss, metrics = m.get_loss(z, noise=noise, times=times,
                                   noise_0=noise_0)
        metrics = dict(metrics)
        metrics["loss"] = metrics.pop("elbo")
        return loss, metrics

    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05,
                               max_grad_norm=None)
    state = parallel_state(model, tx, "ddp")
    step = pstep.make_train_step(loss_fn, tx)
    metrics = []
    for b in batches:
        state, m = step(state, take(b, sl))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": gathered(model)}


def gpt_steps(rank, world, cfg, state_dict, batches, lr, moments_dtype,
              mode="fsdp"):
    """GPT steps (two-group AdamW, no clip) on this rank's rows of each
    global token batch, FSDP2 by default. Returns every step's metrics,
    the parameters after and how many parameters were DTensors."""
    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.train import step as pstep

    sl = rows(rank, world, len(batches[0]))
    model = pt.Transformer(pt.TransformerConfig(**cfg), device="cpu", seed=0)
    model.load_state_dict(state_dict)
    tx = pt.make_gpt_optimizer(model, 0.1, lr, (0.9, 0.95),
                               moments_dtype=moments_dtype)
    state = parallel_state(model, tx, mode)
    sharded = sum(type(p).__name__ == "DTensor" for p in model.parameters())
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    metrics = []
    for b in batches:
        state, m = step(state, take(b, sl))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": gathered(model),
            "sharded": sharded}


def packed_weights(rank, world, cfg, batches):
    """Three FSDP2 steps of a tiny VAE; a forward pre-hook on a ResNet
    block (after FSDP2's own, so its weights are gathered) reads its first
    conv's ``packed_weight`` and a fresh pack of the same weight. Returns
    per step the largest difference, the weight's version and a checksum
    of its values."""
    from tempo_tpu_torch.nn.blocks import ResNetBlock
    from tempo_tpu_torch.ops.cuda_gn_conv import pack_conv3x3_weight
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    model = vae(cfg)
    tx = pstate.make_optimizer(lr=1e-2, weight_decay=0.05)
    state = parallel_state(model, tx, "fsdp")
    block = next(m for m in model.modules() if isinstance(m, ResNetBlock))
    conv = next(c for c in block.modules() if hasattr(c, "packed_weight"))
    seen = []

    def hook(module, args, kwargs):
        w = conv.weight
        got = conv.packed_weight(torch.float32)
        want = pack_conv3x3_weight(w, torch.float32)
        seen.append({"diff": float((got - want).abs().max()),
                     "version": w._version,
                     "checksum": float(w.detach().double().sum()),
                     "cache_packed": conv.cache_packed})

    block.register_forward_pre_hook(hook, with_kwargs=True)
    step = pstep.make_train_step(pstep.vae_loss_fn(model), tx)
    sl = rows(rank, world, len(batches[0]))
    for b in batches:
        state, _ = step(state, take(b, sl))
    return seen


def resume(rank, world, mode, cfg, batches, workdir, n_first=2):
    """Train len(batches) steps straight; then the first ``n_first``,
    a checkpoint, a fresh state that loads it, and the rest. The posterior
    draws from each rank's own generator. Returns both runs' gathered
    parameters, the checkpoint's path and the keys of this rank's fresh
    model."""
    from tempo_tpu_torch.train import checkpoint as ckpt
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    sl = rows(rank, world, len(batches[0]))

    def fresh():
        model = vae(cfg)
        tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
        state = parallel_state(model, tx, mode)
        return model, state, pstep.make_train_step(
            pstep.vae_loss_fn(model), tx)

    model, state, step = fresh()
    for b in batches:
        state, _ = step(state, take(b, sl))
    straight = gathered(model)
    model, state, step = fresh()
    for b in batches[:n_first]:
        state, _ = step(state, take(b, sl))
    path = ckpt.save_checkpoint(Path(workdir) / "ckpt", state)
    model, state, step = fresh()
    state, _, _ = ckpt.load_checkpoint(path, state)
    for b in batches[n_first:]:
        state, _ = step(state, take(b, sl))
    return {"straight": straight, "resumed": gathered(model),
            "path": str(path), "step": state.step}


def cli_run(rank, world, module: str, config: dict, env=None):
    """``tempo_tpu_torch.cli.<module>.run(config, device='cpu')`` on this
    rank (the config's ``distributed:`` section joins the group; ``env``
    is set first, as a launcher would). A rank other than 0 records every
    file it opens for writing, and every directory it makes or file it
    renames, under the run's output directory. Returns those records, the
    run's step count and, for a model that is not sharded, its state
    dict."""
    import importlib

    from tempo_tpu_torch.parallel.fsdp import is_sharded

    os.environ.update(env or {})

    out = os.path.realpath(config["output_dir"])
    written = []

    def audit(event, args):
        if event == "open" and args[0] is not None and args[1] is not None:
            path, mode = str(args[0]), str(args[1])
            if any(c in mode for c in "wax+") and os.path.realpath(
                    path).startswith(out):
                written.append(path)
        elif event in ("os.mkdir", "os.rename") and os.path.realpath(
                str(args[0])).startswith(out):
            written.append(f"{event} {args[0]}")

    if rank != 0:
        sys.addaudithook(audit)
    cli = importlib.import_module(f"tempo_tpu_torch.cli.{module}")
    trainer = cli.run(config, device="cpu")[0]
    model = trainer.state.model
    params = (None if any(is_sharded(p) for p in model.parameters())
              else {k: v.detach().clone()
                    for k, v in model.state_dict().items()})
    return {"written": list(written), "step": trainer.step,
            "params": params}


def spatial_run(rank, world, cfg, state_dict, x, granule, latent, raw,
                spectra, cli_configs=()):
    """The tiny VAE's encode and decode through parallel/spatial.py, and a
    GranuleCodec(mesh=) over the group: encode, reconstruct (the mode, then
    two posterior draws), decode of ``latent`` and normalize of ``raw``
    (its own statistics, then ``spectra``'s), each assembled whole; then
    each config of ``cli_configs`` through ``encode_granules.run`` (rank 1
    records what it writes under the run's directory)."""
    from tempo_tpu_torch.infer.granule_codec import GranuleCodec
    from tempo_tpu_torch.parallel import spatial
    from tempo_tpu_torch.parallel.mesh import create_mesh

    model = vae(cfg, state_dict).eval()
    mesh = create_mesh("cpu")
    sharding = spatial.spatial_sharding(mesh)
    lat = spatial.encode_spatially_sharded(model, x, mesh)
    out = {"sharding": (sharding.rank, sharding.world),
           "encode_share": tuple(lat.shape),
           "encode": spatial.gather_w(lat, sharding)}
    dec = spatial.decode_spatially_sharded(model, out["encode"].numpy(), mesh)
    out["decode_share"] = tuple(dec.shape)
    out["decode"] = spatial.gather_w(dec, sharding, host=True)
    codec = GranuleCodec(model, multiple=16, seed=0, device="cpu", mesh=mesh)
    share = codec.encode(granule)
    out["codec_latent_share"] = tuple(share.shape)
    out["codec_latent"] = codec.to_host(share)
    out["codec_rec"] = codec.reconstruct(granule, sample_posterior=False)
    out["codec_rec_sampled"] = [codec.reconstruct(granule) for _ in range(2)]
    out["codec_dec"] = codec.decode(latent)
    out["normalized_own"] = codec.normalize(raw)
    out["normalized_spectra"] = GranuleCodec(
        model, *spectra, multiple=16, device="cpu", mesh=mesh).normalize(raw)
    out["exchanged"] = dict(spatial.EXCHANGED)
    out["cli"] = [cli_encode(rank, config) for config in cli_configs]
    return out


def cli_encode(rank, config):
    """``encode_granules.run(config, device='cpu')`` in the live group; a
    rank other than 0 records every file it opens for writing, and every
    directory it makes, under the run's output directory."""
    from tempo_tpu_torch.cli import encode_granules

    root, written = [os.path.realpath(config["output_dir"])], []

    def audit(event, args):
        if root[0] is not None and written_under(event, args, root[0]):
            written.append(f"{event} {args[0]}")

    if rank != 0:
        sys.addaudithook(audit)  # it stays for the process's life
    try:
        summary = encode_granules.run(config, device="cpu")
    finally:
        root[0] = None
    return {"summary": summary, "written": written}


def written_under(event, args, root: str) -> bool:
    """Whether an audit event writes a file or makes or renames a
    directory entry under ``root``."""
    if event == "open":
        if args[0] is None or args[1] is None or not any(
                c in str(args[1]) for c in "wax+"):
            return False
    elif event not in ("os.mkdir", "os.rename"):
        return False
    return os.path.realpath(str(args[0])).startswith(root)
