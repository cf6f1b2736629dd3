"""CUDA graphs of the fixed-shape serving calls.

The JAX package serves from compiled programs (``jax.jit``, and
``jax.export`` for the artifacts of infer/export_lm.py): a decode step, or
a scan of K of them, is one dispatch. PyTorch runs eagerly, about a
thousand operator dispatches a GPT-2 decode step, so the port captures
each fixed-shape call once as a CUDA graph and replays it.

``CapturedCall`` captures one function of tensors with fixed shapes;
``GraphSet`` holds the captured calls of one loaded model on one device,
keyed by call, batch, k and the caches they update, in one memory pool.
Nothing is captured on the CPU: there the callers run their functions
eagerly, because the caller asked for the CPU. On a CUDA device a capture
or replay error raises; no call falls back to running eagerly.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence, Tuple

import torch

from tempo_tpu_torch.ops import launches

# Graphs one GraphSet keeps: a server captures a few (one per call it
# makes); a caller that keeps making caches would otherwise hold one each.
MAX_GRAPHS = 32


class CapturedCall:
    """``fn(*inputs)`` captured once as a CUDA graph over static inputs.

    Construction allocates the static inputs (the shapes and types of
    ``example``, on its device) and copies ``example`` into them, runs
    ``fn`` on them once eagerly on ``stream`` (the warm-up: the kernel
    library loads, weights are cast, the decode kernel's counters are made,
    so nothing is set up inside the capture), then captures ``fn`` on the
    same stream into ``pool``. The warm-up's effects on state that ``fn``
    updates in place (a KV cache) are real: a call that writes a cache
    writes it again identically at its first replay.

    Each call copies its inputs into the static ones (an input that is the
    static tensor itself is not copied), replays the graph on the current
    stream and returns the static outputs. ALIASING: the outputs are the
    same tensors at every call and the next replay overwrites them, so a
    caller copies what must outlive the next call. Tensors that ``fn``
    closes over (weights, caches) are used at the addresses they had at
    capture. Launches of the kernels inside count at each replay
    (ops/launches.py)."""

    def __init__(self, fn: Callable, example: Sequence[torch.Tensor] = (),
                 pool=None, stream: Optional[torch.cuda.Stream] = None):
        if not example and stream is None:
            raise ValueError("CapturedCall needs example inputs or a stream")
        self.inputs = tuple(
            torch.empty_like(x, memory_format=torch.contiguous_format)
            .copy_(x) for x in example)
        caller = torch.cuda.current_stream()
        self.stream = stream or torch.cuda.Stream(self.inputs[0].device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            fn(*self.inputs)
        caller.wait_stream(self.stream)
        self.graph = torch.cuda.CUDAGraph()
        with launches.tally() as self.tally:
            with torch.cuda.graph(self.graph, pool=pool, stream=self.stream):
                self.outputs = fn(*self.inputs)

    def __call__(self, *inputs: torch.Tensor):
        for static, x in zip(self.inputs, inputs):
            if x is not static:
                static.copy_(x)
        self.graph.replay()
        launches.replay(self.tally)
        return self.outputs


def cache_key(cache) -> Tuple:
    """Identity of a cache (a sequence of per-layer tensor tuples): the
    address, shape and type of each of its tensors."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype)
                 for layer in cache for t in layer)


class GraphSet:
    """The captured calls of one loaded model on one CUDA device: one
    memory pool and one side stream for warm-ups and captures, graphs keyed
    by (call, batch, k, cache identity). Replays run one after another on
    the caller's stream, so the pool may be shared: a graph's outputs stay
    allocated while it lives, and only intermediates are reused across
    graphs. At most ``MAX_GRAPHS`` are kept, the oldest dropped first."""

    def __init__(self, device: torch.device):
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.calls: "OrderedDict[Tuple, CapturedCall]" = OrderedDict()
        self.captures = 0

    def run(self, key: Tuple, fn: Callable, inputs: Sequence[torch.Tensor]):
        """Replay the graph of ``key``, capturing ``fn`` on ``inputs``
        first if there is none. Returns the graph's static outputs."""
        call = self.calls.get(key)
        if call is None:
            with torch.cuda.device(self.device):
                call = CapturedCall(fn, inputs, self.pool, self.stream)
            self.captures += 1
            self.calls[key] = call
            while len(self.calls) > MAX_GRAPHS:
                self.calls.popitem(last=False)
        return call(*inputs)
