"""Sharded checkpoints: save and restore without any rank holding a whole
sharded leaf; counterpart of tempo_tpu/train/sharded_checkpoint.py, in its
format, so that either package reads what the other wrote.

Layout (a directory, so the ``ckpt_step=*`` globs still match):

    checkpoints/ckpt_step=NNNNNN.shards/
        index.json          # format 1, step, rng, ema, metric histories,
                            # the leaf table (key, file, shape, dtype)
        leaf_0000.npy ...   # one .npy per leaf of {params, opt_state}

The leaves are the JAX package's: flax's parameter tree and optax's AdamW
state (count, mu, nu, and a schedule's count), keyed by JAX's key strings
(``['params']['encoder']['conv_in']['kernel']``) in JAX's flatten order,
each in its JAX layout (interop/jax_layout.py: HWIO kernels, [in, out]
dense kernels, ...), dtype and shape. A bf16 first moment (``MuAdamW``) is
stored as JAX stores it, its 2-byte words under the '<V2' descriptor.

Each rank writes only its own bytes. A rank's tensor of a leaf is a box
of the JAX-layout leaf: a tensor-parallel shard (parallel/tensor.py) is
its last-axis chunk, an FSDP2 shard (parallel/fsdp.py) its dim-0 rows
mapped through the layout, an expert shard (parallel/expert.py) its rows
of the expert axis, a whole tensor the whole leaf. A pipeline run's
parameters are JAX's (rest, stage_stack), flax's {"0", "1"}: a stage's
block i of L/S a stage is the [stage, i mod L/S] box of the stacked
[S, L/S, ...] leaf (parallel/pipeline.py); ``load_params`` reads such a
directory into an unsplit model too. It goes into
its region of the file through ``np.lib.format.open_memmap(mode="r+")``,
a strided write; no leaf is gathered. The protocol is JAX's: rank 0
creates every .npy (header and zeros), all ranks sync, each writes the
regions it owns (a region's replicas on the data axis write it once, from
data rank 0), all sync, and rank 0 writes ``index.json`` last, through a
temporary file and a rename: an ``index.json`` means a complete
checkpoint. Restores read memory-mapped files, each rank only its
regions.

JAX's ``rng`` (a uint32 PRNG key) holds rank 0's generator seed as two
words (``generator_seed`` reads it back); the port's own generator states,
every rank's, go in the extra key ``torch_generators``, which JAX ignores,
so a resume in the port draws as the run would have. A directory JAX
wrote has none: the generator is then seeded from its key, as the
``.msgpack`` resume does (interop/optax_state.py).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from tempo_tpu_torch.interop import jax_layout
from tempo_tpu_torch.parallel import expert, fsdp, pipeline, tensor
from tempo_tpu_torch.parallel.mesh import (barrier, is_primary,
                                           process_count)

SHARDED_SUFFIX = ".shards"
_INDEX = "index.json"
_BF16 = np.dtype("V2")  # a bfloat16 leaf's storage, as JAX writes it


def sharded_checkpoint_path(ckpt_dir: Union[str, Path], step: int) -> Path:
    from tempo_tpu_torch.train.checkpoint import CKPT_PREFIX

    return Path(ckpt_dir) / f"{CKPT_PREFIX}{step:06d}{SHARDED_SUFFIX}"


def is_sharded_checkpoint(path: Union[str, Path]) -> bool:
    path = Path(path)
    return path.is_dir() and (path / _INDEX).exists()


def keystr(path: Tuple[str, ...]) -> str:
    """JAX's key string of a dict path."""
    return "".join(f"['{k}']" for k in path)


@dataclasses.dataclass
class _Region:
    """This rank's tensor of a leaf: ``local`` (torch layout, or the JAX
    one where ``jax_local``) is the box [lo, hi) of JAX axis ``axis``
    (None: the whole leaf); ``owner``: this rank writes it."""

    kind: str
    axis: Optional[int]
    lo: int
    hi: int
    jax_local: bool
    owner: bool
    lead: tuple = ()  # a stacked leaf's [stage, layer] (pipeline)

    def index(self, ndim: int) -> tuple:
        if self.axis is None:
            return self.lead + (Ellipsis,)
        return self.lead + tuple(
            slice(self.lo, self.hi) if a == self.axis else slice(None)
            for a in range(ndim - len(self.lead)))

    def to_jax(self, local: torch.Tensor) -> np.ndarray:
        t = local if self.jax_local else jax_layout.to_jax(self.kind, local)
        t = t.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(_BF16)
        return t.numpy()

    def from_jax(self, block: np.ndarray, like: torch.Tensor
                 ) -> torch.Tensor:
        block = np.array(block)  # this rank's box, off the read-only map
        if block.dtype == _BF16:
            t = torch.from_numpy(block.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(block)
        if not self.jax_local:
            t = jax_layout.from_jax(self.kind, t)
        return t.to(like.device, like.dtype).contiguous()


def _region(p: torch.Tensor, kind: str, pp=None,
            rest: bool = False) -> _Region:
    """Where this rank's ``p`` (a parameter; its moments share it) lies in
    its JAX leaf, and whether this rank writes it. On a pipeline stage
    (``pp``; ``rest``: a parameter outside the blocks) a region is written
    by data rank 0, of the first stage for ``rest``, of model rank 0
    where it is whole over 'model'."""
    if pp is not None:
        whole_rank = pp.tp is None or pp.tp.rank == 0
        if pipeline.is_fsdp_expert(p):
            if tensor.is_shard(p):
                raise NotImplementedError(
                    "a sharded checkpoint of fsdp_experts under tensor "
                    "parallelism is not ported")
            rows = p.shape[0]
            return _Region(kind, jax_layout.jax_axis(kind, 0, p.ndim),
                           pp.data_rank * rows, (pp.data_rank + 1) * rows,
                           False, whole_rank)
        return dataclasses.replace(
            _region(p, kind), owner=pp.data_rank == 0
            and (pp.stage == 0 or not rest)
            and (tensor.is_shard(p) or whole_rank))
    jax_ndim = len(jax_layout.jax_shape(kind, _shape(p)))
    if expert.is_shard(p):
        ep = p.ep_axis
        lo, hi = ep.bounds(p.shape[0] * ep.world)
        return _Region(kind, jax_layout.jax_axis(kind, 0, p.ndim), lo, hi,
                       False, True)
    if tensor.is_shard(p):
        tp = p.tp_axis
        width = (p.shape[-1] if kind == "up" else
                 jax_layout.jax_shape(kind, p.shape)[-1]) * tp.world
        lo, hi = tp.bounds(width)
        return _Region(kind, jax_ndim - 1, lo, hi, kind == "up",
                       tp.data_rank == 0)
    if fsdp.is_sharded(p):
        rows, mesh = p.shape[0], p.device_mesh
        per = -(-rows // mesh.size())
        lo = min(mesh.get_local_rank() * per, rows)
        hi = lo + p.to_local().shape[0]
        return _Region(kind, jax_layout.jax_axis(kind, 0, p.ndim), lo, hi,
                       False, True)
    return _Region(kind, None, 0, 0, False, is_primary())


def _shape(p: torch.Tensor) -> tuple:
    """The torch-layout shape of the whole parameter."""
    if tensor.is_shard(p):
        kind, tp = p.tp_kind, p.tp_axis
        if kind == "up":
            return (p.shape[0], p.shape[1] * tp.world // 4, 2, 2)
        d = jax_layout.torch_dim_of_last(kind, p.ndim)
        shape = list(p.shape)
        shape[d] *= tp.world
        return tuple(shape)
    if expert.is_shard(p):
        return (p.shape[0] * p.ep_axis.world,) + tuple(p.shape[1:])
    if pipeline.is_fsdp_expert(p):
        return (p.shape[0] * p.fsdp_expert,) + tuple(p.shape[1:])
    return tuple(p.shape)


def _staged(leaf, shape: tuple, staging) -> tuple:
    """(JAX path, shape, leading index) of a parameter's leaf; in a
    pipeline's (rest, stage_stack) tree where ``staging`` is (stages,
    layers a stage): a block's leaf stacked to [S, L/S, ...] under "1",
    the rest under "0"."""
    if staging is None:
        return leaf.path, shape, ()
    n_stages, per = staging
    if leaf.path[0].startswith("h_"):
        i = int(leaf.path[0][2:])
        return (("1",) + leaf.path[1:], (n_stages, per) + tuple(shape),
                (i // per, i % per))
    return ("0",) + leaf.path, shape, ()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if fsdp.is_sharded(t) else t


@dataclasses.dataclass
class _Entry:
    """A leaf: its JAX path, shape and dtype name, and what this rank
    holds of it (``tensor`` None: nothing to write, zeros)."""

    path: Tuple[str, ...]
    shape: tuple
    dtype: str
    region: Optional[_Region] = None
    tensor: Optional[torch.Tensor] = None
    param: Optional[str] = None   # the parameter name (params and moments)
    role: str = "param"           # param | mu | nu | count


def _entries(state) -> List[_Entry]:
    """Every leaf of the state's JAX {params, opt_state} in JAX's flatten
    order (sorted keys at every level)."""
    from tempo_tpu_torch.train.schedules import is_scheduled
    from tempo_tpu_torch.train.state import MuAdamW

    model, opt, tx = state.model, state.optimizer, state.tx
    layout = jax_layout.jax_layout(model)
    paths = jax_layout.optax_paths(
        model, clipped=tx is not None and tx.max_grad_norm is not None,
        scheduled=tx is not None and is_scheduled(tx.learning_rate))
    adam = ("opt_state",) + paths.adam
    mu_dtype = "bfloat16" if isinstance(opt, MuAdamW) else "float32"
    pp = pipeline.of(model)
    staging = (None if pp is None else
               (pp.n_stages, len(model.transformer["h"])))
    out = []
    for name, p in model.named_parameters():
        leaf = layout[name]
        path, shape, lead = _staged(
            leaf, jax_layout.jax_shape(leaf.kind, _shape(p)), staging)
        region = dataclasses.replace(
            _region(p, leaf.kind, pp, not leaf.path[0].startswith("h_")),
            lead=lead)
        st = opt.state.get(p, {})
        out.append(_Entry(("params",) + path, shape, "float32", region,
                          p, name))
        out.append(_Entry(adam + ("mu",) + path, shape, mu_dtype,
                          region, st.get("exp_avg"), name, "mu"))
        out.append(_Entry(adam + ("nu",) + path, shape, "float32",
                          region, st.get("exp_avg_sq"), name, "nu"))
    counts = [adam + ("count",)]
    if paths.schedule_count is not None:
        counts.append(("opt_state",) + paths.schedule_count)
    out += [_Entry(c, (), "int32", role="count") for c in counts]
    return sorted(out, key=lambda e: e.path)


def _np_dtype(name: str) -> np.dtype:
    return _BF16 if name == "bfloat16" else np.dtype(name)


def _generator_words(seed: int) -> list:
    return [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF]


def save_checkpoint_sharded(ckpt_dir: Union[str, Path], state,
                            train_metrics: Optional[List[Dict]] = None,
                            val_metrics: Optional[List[Dict]] = None
                            ) -> Path:
    """Write ``state`` (the port's TrainState: one device, DDP, FSDP2 or
    tensor-parallel) as ``ckpt_step=NNNNNN.shards/``; over a process
    group every rank calls this and writes its own regions."""
    step = int(state.step)
    path = sharded_checkpoint_path(ckpt_dir, step)
    primary = is_primary()
    entries = _entries(state)
    table, files = [], {}  # a stage's blocks share their stacked leaves
    for e in entries:
        key = keystr(e.path)
        if key not in files:
            files[key] = f"leaf_{len(table):04d}.npy"
            table.append({"key": key, "file": files[key],
                          "shape": list(e.shape), "dtype": e.dtype})
    if primary:  # phase 1: every file with its header, zero-filled
        path.mkdir(parents=True, exist_ok=True)
        for row in table:
            mm = np.lib.format.open_memmap(
                path / row["file"], mode="w+", dtype=_np_dtype(row["dtype"]),
                shape=tuple(row["shape"]))
            del mm
    barrier()
    for e in entries:  # phase 2: this rank's regions
        file = path / files[keystr(e.path)]
        if e.role == "count":
            if primary:
                mm = np.lib.format.open_memmap(file, mode="r+")
                mm[...] = np.int32(step)
                mm.flush()
                del mm
            continue
        if not e.region.owner or e.tensor is None:
            continue  # another rank's, or never stepped: optax's zeros
        mm = np.lib.format.open_memmap(file, mode="r+")
        mm[e.region.index(mm.ndim)] = e.region.to_jax(_local(e.tensor))
        mm.flush()
        del mm
    barrier()
    generators = [state.generator.get_state()]
    if process_count() > 1:
        generators = [None] * process_count()
        dist.all_gather_object(generators, state.generator.get_state())
    if primary:  # phase 3: the index, last
        index = {
            "format": 1,
            "step": step,
            "rng": _generator_words(state.generator.initial_seed()),
            "rng_dtype": "uint32",
            "ema": {k: float(v) for k, v in (state.ema or {}).items()},
            "train_metrics": train_metrics or [],
            "val_metrics": val_metrics or [],
            "leaves": table,
            "torch_generators": [g.tolist() for g in generators],
        }
        tmp = path / (_INDEX + ".tmp")
        tmp.write_text(json.dumps(index))
        tmp.replace(path / _INDEX)
    barrier()
    return path


def _read_index(path: Path) -> Dict[str, Any]:
    if not is_sharded_checkpoint(path):
        raise FileNotFoundError(f"{path}: no {_INDEX}, not a complete "
                                f"sharded checkpoint")
    return json.loads((path / _INDEX).read_text())


def _reader(path: Path, index: Dict[str, Any]):
    files = {row["key"]: row for row in index["leaves"]}

    def read(e: _Entry, like: torch.Tensor) -> torch.Tensor:
        row = files.get(keystr(e.path))
        if row is None:
            raise ValueError(f"FATAL: leaf {keystr(e.path)} missing from "
                             f"sharded checkpoint {path}")
        if tuple(row["shape"]) != tuple(e.shape):
            raise ValueError(f"FATAL: leaf {row['key']} has shape "
                             f"{row['shape']} in {path}, the model "
                             f"{list(e.shape)}")
        mm = np.load(path / row["file"], mmap_mode="r")
        return e.region.from_jax(mm[e.region.index(mm.ndim)], _local(like))

    return read


def _restore_params(model, entries: List[_Entry], read) -> None:
    with torch.no_grad():
        for e in entries:
            if e.role == "param":
                _local(e.tensor).copy_(read(e, e.tensor))


def load_checkpoint_sharded(path: Union[str, Path], state
                            ) -> Tuple[Any, List[Dict], List[Dict]]:
    """Restore ``state`` in place from a sharded directory (the port's or
    the JAX package's), each rank reading only its regions; returns it
    with the train and validation metric histories."""
    from tempo_tpu_torch.interop.optax_state import generator_seed
    from tempo_tpu_torch.train.checkpoint import restore_generator

    path = Path(path)
    index = _read_index(path)
    entries = _entries(state)
    read = _reader(path, index)
    _restore_params(state.model, entries, read)
    opt = state.optimizer
    params = {id(p): p for g in opt.param_groups for p in g["params"]}
    names = dict(state.model.named_parameters())
    count = float(index["step"])
    moments: Dict[int, Dict[str, torch.Tensor]] = {}
    for e in entries:
        if e.role not in ("mu", "nu"):
            continue
        p = names[e.param]
        if id(p) not in params:
            continue
        local = read(e, p)  # a bf16 mu widens exactly; MuAdamW narrows it
        if fsdp.is_sharded(p):
            from torch.distributed.tensor import DTensor

            local = DTensor.from_local(local, p.device_mesh, p.placements,
                                       shape=p.shape, stride=p.stride())
        moments.setdefault(id(p), {})[
            "exp_avg" if e.role == "mu" else "exp_avg_sq"] = local
    sd = opt.state_dict()
    order = [p for g in opt.param_groups for p in g["params"]]
    sd["state"] = {i: {"step": torch.tensor(count, dtype=torch.float32),
                       **moments[id(p)]}
                   for i, p in enumerate(order)}
    opt.load_state_dict(sd)
    generators = index.get("torch_generators")
    if generators is None:  # JAX's: every rank seeded from its key
        state.generator.manual_seed(generator_seed(
            np.asarray(index["rng"], dtype=index.get("rng_dtype",
                                                     "uint32"))))
    else:
        generators = [torch.tensor(g, dtype=torch.uint8) for g in generators]
    restore_generator(state, generators,
                      None if generators is None else generators[0])
    if index.get("ema"):
        device = next(state.model.parameters()).device
        state.ema = {k: torch.tensor(v, dtype=torch.float32, device=device)
                     for k, v in index["ema"].items()}
    state.step = int(index["step"])
    return (state, index.get("train_metrics", []),
            index.get("val_metrics", []))


def load_params_sharded(path: Union[str, Path], model):
    """Only the model's parameters from a sharded directory, in place
    (each rank its regions under tensor parallelism or FSDP2); the
    analysis and serving entry. A VAE takes the ``vae`` half of an
    L2-supervised checkpoint."""
    path = Path(path)
    index = _read_index(path)
    keys = {row["key"] for row in index["leaves"]}
    layout = jax_layout.jax_layout(model)
    prefix: Tuple[str, ...] = ("params",)
    first = keystr(prefix + next(iter(layout.values())).path)
    if first not in keys and keystr(prefix + ("vae",) + next(
            iter(layout.values())).path) in keys:
        prefix = ("params", "vae")
    pp = pipeline.of(model)
    staging = _staging(index) if keystr(prefix + ("0",) + next(
        iter(layout.values())).path) in keys else None
    entries = []
    for name, p in model.named_parameters():
        leaf = layout[name]
        leaf_path, shape, lead = _staged(
            leaf, jax_layout.jax_shape(leaf.kind, _shape(p)), staging)
        region = dataclasses.replace(
            _region(p, leaf.kind, pp, not leaf.path[0].startswith("h_")),
            lead=lead)
        entries.append(_Entry(prefix + leaf_path, shape, "float32", region,
                              p, name))
    _restore_params(model, entries, _reader(path, index))
    return model


def _staging(index: Dict[str, Any]) -> tuple:
    """(stages, layers a stage) of a pipeline run's directory: the leading
    axes of its stacked block leaves."""
    for row in index["leaves"]:
        if row["key"].startswith("['params']['1']"):
            return tuple(row["shape"][:2])
    raise ValueError("FATAL: a (rest, stage_stack) checkpoint without "
                     "stacked blocks")
