"""Launch counts that hold across CUDA graph replays.

Each kernel wrapper counts its launches in its module's ``LAUNCHES`` dict
through ``count``. A call made while a CUDA graph is being captured does
not launch its kernel: it records it into the graph. So inside a
``tally()`` block ``count`` notes the launch in the capture's tally
instead, and whoever replays the graph adds the tally with ``replay`` at
each replay, where the kernels really run (infer/graphs.py).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch

Tally = List[Tuple[Dict[str, int], str]]
_TALLIES: List[Tally] = []  # the captures in progress, innermost last


def count(launches: Dict[str, int], name: str) -> None:
    """One launch of ``name`` (a key of ``launches``), or, while a capture
    is recorded inside ``tally()``, one launch of it at each replay."""
    if _TALLIES and torch.cuda.is_current_stream_capturing():
        _TALLIES[-1].append((launches, name))
    else:
        launches[name] += 1


@contextlib.contextmanager
def tally() -> Iterator[Tally]:
    """Collect the launches that the wrappers record during a capture."""
    t: Tally = []
    _TALLIES.append(t)
    try:
        yield t
    finally:
        _TALLIES.pop()


def replay(t: Tally) -> None:
    """Add one replay's launches to the wrappers' counts."""
    for launches, name in t:
        launches[name] += 1
