"""Device resolution for the port's entry points."""

from __future__ import annotations

import os

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means CUDA: ``cuda:LOCAL_RANK`` in a process that torchrun
    started (one process per GPU), the current CUDA device otherwise.
    Asking for CUDA where there is none raises; the CPU is used only when
    the caller names it."""
    if device is None:
        local = os.environ.get("LOCAL_RANK")
        device = "cuda" if local is None else f"cuda:{int(local)}"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
