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


def cli_runs(rank, world, runs, env=None):
    """``cli_run`` of each (module, config) of ``runs`` in turn (each
    config's ``distributed:`` section joins a group of its own)."""
    return [cli_run(rank, world, module, config, env)
            for module, config in runs]


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


# ------------------------------------------------- tensor parallelism

def tp_cases(rank, world, n_model, cases):
    """The cases of ``cases`` ({name: args}, names from TP_CASES) under
    tensor parallelism over a ('data', 'model') mesh of world / n_model x
    n_model ranks; returns this rank's axes and {name: result}."""
    from tempo_tpu_torch.parallel import tensor

    mesh = tensor.create_tp_mesh(n_model, "cpu")
    tp = tensor.tensor_parallel(mesh)
    out = {"axes": (tp.rank, tp.world, tp.data_rank, tp.data_world)}
    for name, args in cases.items():
        out[name] = TP_CASES[name.split(":")[0]](mesh, *args)
    return out


def _local_state(model, optimizer) -> dict:
    """{name: (layout kind or None, the rank's parameter, exp_avg,
    exp_avg_sq)}."""
    out = {}
    for name, p in model.named_parameters():
        st = optimizer.state.get(p, {})
        out[name] = (getattr(p, "tp_kind", None), p.detach().clone(),
                     st.get("exp_avg"), st.get("exp_avg_sq"))
    return out


def tp_vae(mesh, cfg, state_dict, batches, noises, x_encode):
    """The VAE recipe's steps under TP on this rank's data rows (the
    posterior fed them); the encode of ``x_encode`` before them. Returns
    the metrics, the gathered parameters, the rank's own parameters and
    moments, the encode and the rank's parameter + moment bytes."""
    from tempo_tpu_torch.parallel import mesh as pmesh
    from tempo_tpu_torch.parallel import tensor
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    sl = pmesh.batch_sharding(mesh).rows(len(batches[0]))
    feed_posterior(noises, sl)
    model = vae(cfg, state_dict)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = tensor.shard_state_tp(pstate.create_train_state(model, tx, 3),
                                  mesh, tx)
    with torch.no_grad():
        encoded = model.encode(torch.from_numpy(x_encode)).mean
    step = pstep.make_train_step(pstep.vae_loss_fn(model), tx)
    metrics = []
    for b in batches:
        state, m = step(state, take(b, sl))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics,
            "params": _whole(tensor.full_state_dict(model)),
            "local": _local_state(model, state.optimizer),
            "encode": encoded,
            "bytes": tensor.param_bytes(model, state.optimizer)}


def tp_l2(mesh, cfg, hidden, state_dict, batch, noises):
    """One L2 step under TP on this rank's data rows, both posterior
    draws fed. Returns the metrics and the gathered parameters."""
    from tempo_tpu_torch.parallel import mesh as pmesh
    from tempo_tpu_torch.parallel import tensor
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep

    sl = pmesh.batch_sharding(mesh).rows(len(batch["spectral"]))
    feed_posterior(noises, sl)
    model = vae(cfg, state_dict, "l2", hidden)
    tx = pstate.make_optimizer(lr=1e-3, weight_decay=0.05)
    state = tensor.shard_state_tp(pstate.create_train_state(model, tx, 3),
                                  mesh, tx)
    step = pstep.make_train_step(pstep.vae_l2_loss_fn(model), tx)
    state, m = step(state, take(batch, sl))
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": _whole(tensor.full_state_dict(model))}


def tp_gpt(mesh, cfg, state_dict, tokens, targets):
    """The mean next-token NLL of the whole batch and its gradients under
    TP (a data axis of one), the gradients gathered."""
    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.ops.losses import lm_cross_entropy
    from tempo_tpu_torch.parallel import tensor

    model = pt.Transformer(pt.TransformerConfig(**cfg), device="cpu", seed=0)
    model.load_state_dict(state_dict)
    tensor.shard_params_tp(model, mesh)
    loss = lm_cross_entropy(model(torch.from_numpy(tokens)),
                            torch.from_numpy(targets))
    loss.backward()
    grads = {n: (tensor.full_of(p.grad, p.tp_kind, p.tp_axis)
                 if tensor.is_shard(p) else p.grad)
             for n, p in model.named_parameters()}
    return {"loss": float(loss), "grads": grads,
            "exchanged": dict(tensor.EXCHANGED)}


TP_CASES = {"vae": tp_vae, "l2": tp_l2, "gpt": tp_gpt}


def _guard_gathers():
    """Make every whole-tensor gather of the port raise (a sharded save
    must not call one)."""
    from tempo_tpu_torch.parallel import fsdp, tensor

    def refuse(*args, **kwargs):
        raise AssertionError("a whole-leaf gather in a sharded save")

    saved = {}
    for mod, names in ((tensor, ("_all_gather_last", "full_of",
                                 "full_state_dict", "full_optimizer_state")),
                       (fsdp, ("full_state_dict", "full_optimizer_state",
                               "_full"))):
        for name in names:
            saved[(mod, name)] = getattr(mod, name)
            setattr(mod, name, refuse)
    return saved


def _unguard(saved) -> None:
    for (mod, name), fn in saved.items():
        setattr(mod, name, fn)


def _whole_moments(model, optimizer, full) -> dict:
    """{name: (exp_avg, exp_avg_sq)} of a gathered optimizer state."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(params[int(i)])]: (st["exp_avg"].clone(),
                                        st["exp_avg_sq"].clone())
            for i, st in full["state"].items()}


def _whole(state_dict: dict) -> dict:
    """Copies of a gathered state dict's tensors (its whole parameters
    are the live ones)."""
    return {k: v.detach().clone() for k, v in state_dict.items()}


def sharded_checkpoints(rank, world, cfg, jax_dir, msgpack, batch, workdir,
                        one_process):
    """The sharded checkpoint under TP over all ranks (a data axis of
    one): JAX's directory loaded into a fresh TP state (its state
    gathered, the rank's shapes); a step, the port's own save with every
    whole-leaf gather refused, the next step live and from a fresh state
    that loads the save (gathered, to compare); a ``.pt`` save under TP;
    one process's files ({format: path}) each resumed and stepped. Then a
    JAX ``.msgpack`` full state resumed under FSDP2 (gathered)."""
    from tempo_tpu_torch.parallel import fsdp, tensor
    from tempo_tpu_torch.parallel.mesh import create_mesh
    from tempo_tpu_torch.train import checkpoint as ckpt
    from tempo_tpu_torch.train import state as pstate
    from tempo_tpu_torch.train import step as pstep
    from tempo_tpu_torch.train.sharded_checkpoint import (
        save_checkpoint_sharded)

    mesh = tensor.create_tp_mesh(world, "cpu")
    tx = pstate.make_optimizer(lr=1e-3)

    def fresh(seed):
        state = tensor.shard_state_tp(pstate.create_train_state(
            _vae_seeded(cfg, seed), tx, seed), mesh, tx)
        state.ema = {}
        return state, pstep.make_train_step(
            pstep.vae_loss_fn(state.model), tx)

    out = {}
    state, step = fresh(5)
    state, train_m, _ = ckpt.load_checkpoint(jax_dir, state)
    out["loaded"] = _whole(tensor.full_state_dict(state.model))
    out["loaded_moments"] = _whole_moments(
        state.model, state.optimizer,
        tensor.full_optimizer_state(state.optimizer))
    out["local_shapes"] = {n: tuple(p.shape)
                           for n, p in state.model.named_parameters()}
    out["loaded_step"], out["train_metrics"] = state.step, train_m
    out["ema"] = {k: float(v) for k, v in state.ema.items()}
    x = torch.from_numpy(batch)
    state, _ = step(state, x)
    saved = _guard_gathers()
    try:
        path = save_checkpoint_sharded(Path(workdir) / "ckpt", state,
                                       [{"step": 2, "loss": 1.0}])
    finally:
        _unguard(saved)
    out["path"] = str(path)
    out["saved"] = _whole(tensor.full_state_dict(state.model))
    out["saved_moments"] = _whole_moments(
        state.model, state.optimizer,
        tensor.full_optimizer_state(state.optimizer))
    state, m = step(state, x)
    out["live"] = _whole(tensor.full_state_dict(state.model))
    out["live_metrics"] = {k: float(v) for k, v in m.items()}
    again, step2 = fresh(9)
    again, _, _ = ckpt.load_checkpoint(path, again)
    out["resumed_local_shapes"] = {
        n: tuple(p.shape) for n, p in again.model.named_parameters()}
    again, m2 = step2(again, x)
    out["resumed"] = _whole(tensor.full_state_dict(again.model))
    out["resumed_metrics"] = {k: float(v) for k, v in m2.items()}
    out["pt"] = str(ckpt.save_checkpoint(Path(workdir) / "pt", state))
    out["one_process"] = {}
    for fmt, one in one_process.items():
        st, stp = fresh(9)
        st, _, _ = ckpt.load_checkpoint(one, st)
        st, m = stp(st, x)
        out["one_process"][fmt] = {
            "loss": float(m["loss"]),
            "params": _whole(tensor.full_state_dict(st.model))}

    # a JAX .msgpack full state under FSDP2
    model = vae(cfg)
    fs = fsdp.shard_state_fsdp(pstate.create_train_state(model, tx, 3),
                               create_mesh("cpu"), tx)
    fs, _, _ = ckpt.load_checkpoint(msgpack, fs)
    out["fsdp_params"] = _whole(fsdp.full_state_dict(model))
    out["fsdp_moments"] = _whole_moments(
        model, fs.optimizer, fsdp.full_optimizer_state(fs.optimizer))
    out["fsdp_step"] = fs.step
    # FSDP2's dim-0 shards written as the sharded format and read back
    fs, _ = pstep.make_train_step(pstep.vae_loss_fn(model), tx)(fs, x)
    saved = _guard_gathers()
    try:
        fpath = save_checkpoint_sharded(Path(workdir) / "fsdp_ckpt", fs)
    finally:
        _unguard(saved)
    out["fsdp_path"] = str(fpath)
    out["fsdp_saved"] = _whole(fsdp.full_state_dict(model))
    out["fsdp_saved_moments"] = _whole_moments(
        model, fs.optimizer, fsdp.full_optimizer_state(fs.optimizer))
    model2 = _vae_seeded(cfg, 11)
    fs2 = fsdp.shard_state_fsdp(pstate.create_train_state(model2, tx, 3),
                                create_mesh("cpu"), tx)
    fs2, _, _ = ckpt.load_checkpoint(fpath, fs2)
    out["fsdp_loaded"] = _whole(fsdp.full_state_dict(model2))
    out["fsdp_loaded_moments"] = _whole_moments(
        model2, fs2.optimizer, fsdp.full_optimizer_state(fs2.optimizer))
    return out


def _vae_seeded(cfg: dict, seed: int):
    from tempo_tpu_torch.models.vae import AutoencoderKL, VAEConfig

    return AutoencoderKL(VAEConfig(**cfg), device="cpu", seed=seed)


# --------------------------------------------- expert parallelism, MoE

def _gpt(cfg: dict, state_dict):
    from tempo_tpu_torch.nn import transformer as pt

    model = pt.Transformer(pt.TransformerConfig(**cfg), device="cpu", seed=0)
    model.load_state_dict(state_dict)
    return model


def _ep_whole(model, values: dict) -> dict:
    """{name: tensor} with every expert shard's gathered."""
    from tempo_tpu_torch.parallel import expert

    params = dict(model.named_parameters())
    return {n: (expert.full_of(v, params[n].ep_axis)
                if expert.is_shard(params[n]) else v.detach().clone())
            for n, v in values.items()}


def ep_grads(rank, world, cfg, state_dict, tokens, targets):
    """Expert parallelism over the world (JAX's tests/test_moe.py EP
    case): each rank's NLL over its rows, routed over the global batch;
    the gradients before (``raw``) and after ``average_grads``, gathered,
    the global norm, the shards' shapes and the decay mask of the sharded
    model."""
    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.ops.losses import lm_cross_entropy
    from tempo_tpu_torch.parallel import expert, mesh

    model = _gpt(cfg, state_dict)
    expert.shard_params_ep(model, expert.create_ep_mesh(world, "cpu"))
    ep = expert.of(model)
    sl = rows(rank, world, len(tokens))
    loss = lm_cross_entropy(model(torch.from_numpy(tokens[sl])),
                            torch.from_numpy(targets[sl]))
    loss.backward()
    params = list(model.parameters())
    raw = _ep_whole(model, {n: p.grad for n, p in model.named_parameters()})
    expert.average_grads(params, ep)
    return {"loss": float(mesh.all_reduce_mean(loss.detach())),
            "raw": raw,
            "grads": _ep_whole(model, {n: p.grad for n, p in
                                       model.named_parameters()}),
            "norm": float(expert.global_norm(params, ep)),
            "shapes": {n: tuple(p.shape) for n, p in
                       model.named_parameters()},
            "shards": sorted(n for n, p in model.named_parameters()
                             if expert.is_shard(p)),
            "mask": pt.gpt_decay_mask(model)}


def _moe_state(cfg, state_dict, mode: str, lr: float):
    """(model, GPT optimizer recipe, train state) of an MoE GPT under
    ``mode``: 'ep' (experts over the world), 'ddp', 'fsdp' or 'tp' (a
    model axis of the world)."""
    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.parallel import expert, fsdp, tensor
    from tempo_tpu_torch.parallel import mesh as pmesh
    from tempo_tpu_torch.train import state as pstate

    model = _gpt(cfg, state_dict)
    tx = pt.make_gpt_optimizer(model, 0.1, lr, (0.9, 0.95))
    state = pstate.create_train_state(model, tx, 3)
    world = pmesh.process_count()
    if mode == "ep":
        state = expert.shard_state_ep(
            state, expert.create_ep_mesh(world, "cpu"), tx)
    elif mode == "ddp":
        state = pmesh.shard_state(state, pmesh.create_mesh("cpu"))
    elif mode == "fsdp":
        state = fsdp.shard_state_fsdp(state, pmesh.create_mesh("cpu"), tx)
    elif mode == "tp":
        state = tensor.shard_state_tp(
            state, tensor.create_tp_mesh(world, "cpu"), tx)
    return model, tx, state


def _full_params(model) -> dict:
    from tempo_tpu_torch.parallel import expert, fsdp, tensor

    if any(fsdp.is_sharded(p) for p in model.parameters()):
        sd = fsdp.full_state_dict(model)
    elif tensor.of(model) is not None:
        sd = tensor.full_state_dict(model)
    elif expert.of(model) is not None:
        sd = expert.full_state_dict(model)
    else:
        sd = model.state_dict()
    return {k: v.detach().clone() for k, v in sd.items()}


def _whole_grads(model) -> dict:
    """The parameters' gradients whole (a collective for shards)."""
    from tempo_tpu_torch.parallel import expert, fsdp, tensor

    out = {}
    for n, p in model.named_parameters():
        g = p.grad
        if fsdp.is_sharded(g):
            g = g.full_tensor()
        elif tensor.is_shard(p):
            g = tensor.full_of(g, p.tp_kind, p.tp_axis)
        elif expert.is_shard(p):
            g = expert.full_of(g, p.ep_axis)
        out[n] = g.detach().clone()
    return out


def moe_steps(rank, world, mode, cfg, state_dict, batches, lr):
    """GPT steps of an MoE model (the NLL plus 0.01 x the Switch loss,
    routed over the global batch) under ``mode`` on this rank's rows of
    each global batch (every row under 'tp'): each step's metrics, the
    first step's gradients and the parameters after, whole."""
    from tempo_tpu_torch.train import step as pstep

    model, tx, state = _moe_state(cfg, state_dict, mode, lr)
    sl = slice(None) if mode == "tp" else rows(rank, world, len(batches[0]))
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    metrics, grads = [], None
    for b in batches:
        state, m = step(state, take(b, sl))
        metrics.append({k: float(v) for k, v in m.items()})
        grads = grads or _whole_grads(model)
    return {"metrics": metrics, "grads": grads,
            "params": _full_params(model)}


def _opt_local(state) -> dict:
    """{name: (param, exp_avg, exp_avg_sq)} of this rank, cloned."""
    out = {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state.get(p, {})
        out[name] = tuple(t.detach().clone() if t is not None else None
                          for t in (p, st.get("exp_avg"),
                                    st.get("exp_avg_sq")))
    return out


def _same(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        all((x is None and y is None) or (x is not None and y is not None
                                          and torch.equal(x, y))
            for x, y in zip(a[k], b[k])) for k in a)


def ep_checkpoints(rank, world, cfg, state_dict, batches, lr, workdir):
    """An EP state after its steps written as a .pt (rank 0 gathers) and
    as a .shards directory (each rank its experts), each resumed into a
    fresh EP state: whether each rank's parameters and moments came back
    bitwise, and the paths."""
    from tempo_tpu_torch.train import checkpoint as ckpt
    from tempo_tpu_torch.train import step as pstep
    from tempo_tpu_torch.train.sharded_checkpoint import (
        save_checkpoint_sharded)

    model, tx, state = _moe_state(cfg, state_dict, "ep", lr)
    step = pstep.make_train_step(pstep.lm_loss_fn(model), tx)
    sl = rows(rank, world, len(batches[0]))
    for b in batches:
        state, _ = step(state, take(b, sl))
    live = _opt_local(state)
    pt_path = ckpt.save_checkpoint(Path(workdir) / "ep_pt", state)
    dir_path = save_checkpoint_sharded(Path(workdir) / "ep_shards", state)
    out = {"pt": str(pt_path), "shards": str(dir_path),
           "whole": _full_params(model)}
    for key, path in (("pt", pt_path), ("shards", dir_path)):
        _, _, fresh = _moe_state(cfg, state_dict, "ep", lr)
        ckpt.load_checkpoint(path, fresh)
        out[f"{key}_bitwise"] = _same(live, _opt_local(fresh))
        out[f"{key}_step"] = fresh.step
    return out


EXPERT_CASES = {"ep_grads": ep_grads, "moe_steps": moe_steps,
                "ep_checkpoints": ep_checkpoints}


def expert_cases(rank, world, cases):
    """Every case of ``cases`` ({name: args}, names from EXPERT_CASES up to
    a ':'), in order, on this rank; returns {name: result}."""
    return {name: EXPERT_CASES[name.split(":")[0]](rank, world, *args)
            for name, args in cases.items()}


# ------------------------------------------------- pipeline parallelism

def _pp_model(dims, cfg, state_dict, fsdp_experts=False):
    """A GPT placed on this rank's stage of a (data, pipe, model) mesh of
    ``dims``."""
    from tempo_tpu_torch.parallel import pipeline

    n_data, n_pipe, n_model = dims
    mesh = pipeline.create_pp_mesh(n_pipe, "cpu", n_data=n_data,
                                   n_model=n_model)
    return pipeline.place_pipeline_params(mesh, _gpt(cfg, state_dict),
                                          fsdp_experts)


def pp_apply(rank, world, dims, cfg, state_dict, tokens, n_micro):
    """The pipelined forward's logits of the whole batch on this rank."""
    from tempo_tpu_torch.parallel import pipeline

    model = _pp_model(dims, cfg, state_dict)
    pp = pipeline.of(model)
    apply = pipeline.make_pipelined_apply(model.config, dims[1], n_micro)
    sl = rows(pp.data_rank, pp.data_world, len(tokens))
    return {"logits": apply(model, torch.from_numpy(tokens[sl])),
            "stage": pp.stage, "data_rank": pp.data_rank,
            "blocks": [n for n, _ in model.named_parameters()
                       if n.startswith("transformer.h.")]}


def pp_grads(rank, world, dims, cfg, state_dict, tokens, targets, n_micro,
             fsdp_experts=False):
    """The loss and the reduced gradients of one value_and_grad through
    the pipeline (each data row its rows), whole, on stage 0; the global
    norm; the expert shards' shapes."""
    from tempo_tpu_torch.parallel import pipeline

    model = _pp_model(dims, cfg, state_dict, fsdp_experts)
    pp = pipeline.of(model)
    sl = rows(pp.data_rank, pp.data_world, len(tokens))
    loss = pipeline.make_pp_loss_fn(model.config, dims[1], n_micro
                                    ).value_and_grad(
        model, torch.from_numpy(tokens[sl]), torch.from_numpy(targets[sl]))
    pipeline.reduce_grads(model, pp)
    return {"loss": float(pipeline.mean_over_data(loss, pp)),
            "grads": pipeline.full_grads(model),
            "norm": float(pipeline.global_norm(model, pp)),
            "stage": pp.stage,
            "expert_shapes": {n: tuple(p.shape) for n, p in
                              model.named_parameters()
                              if pipeline.is_fsdp_expert(p)}}


def _pp_state(dims, cfg, state_dict, opt: str, lr: float):
    from tempo_tpu_torch.nn import transformer as pt
    from tempo_tpu_torch.parallel import pipeline
    from tempo_tpu_torch.train import state as pstate

    n_data, n_pipe, n_model = dims
    model = _gpt(cfg, state_dict)
    tx = (pt.make_gpt_optimizer(model, 0.1, lr, (0.9, 0.95)) if opt == "gpt"
          else pstate.make_optimizer(lr=lr))
    state = pipeline.shard_state_pp(
        pstate.create_train_state(model, tx, 3),
        pipeline.create_pp_mesh(n_pipe, "cpu", n_data=n_data,
                                n_model=n_model), tx)
    return model, tx, state


def pp_steps(rank, world, dims, cfg, state_dict, batches, n_micro, opt, lr,
             workdir=None):
    """Train steps through the pipeline on ``batches`` ({tokens, targets})
    (``opt``: 'gpt', the two-group AdamW, or 'clip', the VAE recipe's
    clip + AdamW): each step's metrics,
    the parameters after, whole on stage 0. With ``workdir``, the state
    also goes through a .pt and a .shards checkpoint, each resumed
    bitwise or not."""
    from tempo_tpu_torch.parallel import pipeline
    from tempo_tpu_torch.train import checkpoint as ckpt
    from tempo_tpu_torch.train import step as pstep
    from tempo_tpu_torch.train.sharded_checkpoint import (
        save_checkpoint_sharded)

    model, tx, state = _pp_state(dims, cfg, state_dict, opt, lr)
    pp = pipeline.of(model)
    pp_loss = pipeline.make_pp_loss_fn(model.config, dims[1], n_micro)

    def loss_fn(model, batch, generator):  # {tokens, targets}, as JAX's
        loss = pp_loss(model, batch["tokens"], batch["targets"])
        return loss, {"loss": loss}

    def value_and_grad(model, batch, generator):
        loss = pp_loss.value_and_grad(model, batch["tokens"],
                                      batch["targets"])
        return loss, {"loss": loss}

    loss_fn.value_and_grad = value_and_grad
    step = pstep.make_train_step(loss_fn, tx)
    sl = rows(pp.data_rank, pp.data_world, len(batches[0]["tokens"]))
    metrics = []
    for b in batches:
        state, m = step(state, take(b, sl))
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "params": pipeline.full_state_dict(model),
           "stage": pp.stage}
    if workdir is None:
        return out
    live = _opt_local(state)
    tag = "x".join(map(str, dims))
    out["pt"] = str(ckpt.save_checkpoint(Path(workdir) / f"pp_pt_{tag}",
                                         state))
    out["shards"] = str(save_checkpoint_sharded(
        Path(workdir) / f"pp_shards_{tag}", state))
    for key in ("pt", "shards"):
        _, _, fresh = _pp_state(dims, cfg, state_dict, opt, lr)
        ckpt.load_checkpoint(out[key], fresh)
        out[f"{key}_bitwise"] = _same(live, _opt_local(fresh))
        placed = ckpt.load_params(out[key], _pp_model(dims, cfg,
                                                      state_dict))
        out[f"{key}_load_params"] = all(
            torch.equal(p, live[n][0])
            for n, p in placed.named_parameters())
    return out


def pp_resume(rank, world, dims, cfg, state_dict, paths, lr):
    """Fresh pipelined states (the two-group AdamW) resumed from each of
    ``paths`` (JAX's files of a pipeline run): the step, and on stage 0
    the parameters and AdamW moments whole, by parameter name."""
    from tempo_tpu_torch.parallel import pipeline
    from tempo_tpu_torch.train import checkpoint as ckpt

    out = {}
    for path in paths:
        model, _, state = _pp_state(dims, cfg, state_dict, "gpt", lr)
        ckpt.load_checkpoint(path, state)
        opt = pipeline.full_optimizer_state(state)
        order = pipeline.one_device_order(model, state.tx)
        out[path] = {"step": state.step,
                     "params": pipeline.full_state_dict(model),
                     "moments": {order[i]: st for i, st in
                                 opt.get("state", {}).items()}}
    return out


PIPELINE_CASES = {"pp_apply": pp_apply, "pp_grads": pp_grads,
                  "pp_steps": pp_steps, "pp_resume": pp_resume}


def pipeline_cases(rank, world, cases):
    """Every case of ``cases`` ({name: args}, names from PIPELINE_CASES up
    to a ':'), in order, on this rank; returns {name: result}."""
    return {name: PIPELINE_CASES[name.split(":")[0]](rank, world, *args)
            for name, args in cases.items()}
