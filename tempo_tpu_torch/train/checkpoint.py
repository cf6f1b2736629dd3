"""Checkpointing: single-file snapshots of the train state; counterpart of
tempo_tpu/train/checkpoint.py.

Checkpoints are <output_dir>/checkpoints/ckpt_step=NNNNNN.pt (the same
``ckpt_step=*`` naming as the JAX package's .msgpack files; msgpack is not
used here) holding the step, the model's and the optimizer's state dicts,
the generator's state, the EMA and the metric histories, written through a
temporary file and an atomic rename so a preempted save never leaves a
torn checkpoint. ``load_params`` restores only the model's parameters,
for inference and analysis. The sharded and asynchronous formats are not
ported.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from tempo_tpu_torch.train.state import TrainState

CKPT_PREFIX = "ckpt_step="
CKPT_SUFFIX = ".pt"


def checkpoint_path(ckpt_dir: Union[str, Path], step: int) -> Path:
    return Path(ckpt_dir) / f"{CKPT_PREFIX}{step:06d}{CKPT_SUFFIX}"


def save_checkpoint(ckpt_dir: Union[str, Path], state: TrainState,
                    train_metrics: Optional[List[Dict]] = None,
                    val_metrics: Optional[List[Dict]] = None) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    payload: Dict[str, Any] = {
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "generator": state.generator.get_state(),
        "ema": {k: float(v) for k, v in (state.ema or {}).items()},
        "train_metrics": json.dumps(train_metrics or []),
        "val_metrics": json.dumps(val_metrics or []),
    }
    path = checkpoint_path(ckpt_dir, payload["step"])
    tmp = path.with_suffix(".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, path)  # atomic: no torn checkpoints on preemption
    return path


def load_checkpoint(path: Union[str, Path], state: TrainState
                    ) -> Tuple[TrainState, List[Dict], List[Dict]]:
    """Restore ``state`` (a state of the same model and optimizer layout)
    from ``path`` in place; returns it with the metric histories."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError("sharded checkpoints are not ported")
    device = next(state.model.parameters()).device
    # on the host: load_state_dict moves what belongs with the parameters
    # (the optimizer's step counts stay on the host, as a fresh AdamW's)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(raw["model"])
    state.optimizer.load_state_dict(raw["optimizer"])
    state.generator.set_state(raw["generator"])
    if raw["ema"]:
        state.ema = {k: torch.tensor(v, dtype=torch.float32, device=device)
                     for k, v in raw["ema"].items()}
    state.step = int(raw["step"])
    return (state, json.loads(raw["train_metrics"]),
            json.loads(raw["val_metrics"]))


def load_params(path: Union[str, Path], model: torch.nn.Module
                ) -> torch.nn.Module:
    """Load only the model's parameters from ``path`` into ``model`` (in
    place, strict) and return it; counterpart of
    tempo_tpu/train/checkpoint.py ``load_params``.

    Takes the port's checkpoints (``model`` of save_checkpoint's payload,
    from train_vae or train_vae_l2) and reference torch checkpoints (a bare
    state dict, or the trainer schema's ``model_state_dict``): the port's
    parameter names are the reference's. A model without an L2 head takes
    the ``vae.*`` half of an L2-supervised checkpoint."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"{path}: sharded checkpoint directories wait for the sharded "
            f"checkpoint format (ROADMAP Queue 1, M13), which is not ported")
    if path.suffix == ".msgpack":
        raise NotImplementedError(
            f"{path}: the JAX package's .msgpack checkpoints need the "
            f"checkpoint bridge (ROADMAP Queue 1, M11), which is not ported; "
            f"give a .pt checkpoint")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if "model" in raw and isinstance(raw["model"], dict):
        raw = raw["model"]
    state_dict = raw.get("model_state_dict", raw)
    if not any(k.startswith("vae.") for k in model.state_dict()):
        nested = {k[4:]: v for k, v in state_dict.items()
                  if k.startswith("vae.")}
        state_dict = nested or state_dict
    model.load_state_dict(state_dict)
    return model


def list_checkpoints(ckpt_dir: Union[str, Path]) -> List[Path]:
    """Every checkpoint in a directory (the port's and reference ``.pt``
    files alike), sorted by step."""
    return sorted(Path(ckpt_dir).glob(f"{CKPT_PREFIX}*{CKPT_SUFFIX}"),
                  key=checkpoint_step)


def latest_checkpoint(ckpt_dir: Union[str, Path]) -> Optional[Path]:
    """Highest-step checkpoint in a directory, or None (the auto-resume
    hook, ``training.resume_from: auto``)."""
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def wants_auto_resume(train_cfg: dict) -> bool:
    """True when ``training.resume_from: auto``: the CLI may then re-enter
    an existing output dir."""
    return train_cfg.get("resume_from") == "auto"


def resolve_resume_from(train_cfg: dict,
                        output_dir: Union[str, Path]) -> Optional[Path]:
    """An explicit ``training.resume_from`` path as it is; 'auto' resolves
    to the run's own latest checkpoint (None + a notice when there is none
    yet: a fresh start)."""
    resume_from = train_cfg.get("resume_from")
    if resume_from == "auto":
        resume_from = latest_checkpoint(Path(output_dir) / "checkpoints")
        if resume_from is None:
            print("\nresume_from: auto — no checkpoint found, starting fresh")
    return resume_from


def checkpoint_step(path: Union[str, Path]) -> int:
    """The step of ckpt_step=NNNNNN.<ext>, for any extension."""
    return int(Path(path).stem[len(CKPT_PREFIX):])
