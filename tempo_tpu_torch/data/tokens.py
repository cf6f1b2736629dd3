"""Token-stream loading for language-model training (cli/train_gpt.py);
a numpy copy of tempo_tpu/data/tokens.py, so a seed gives the same
batches, bit for bit, in both packages.

One flat int array on disk (memory-mapped) or made by make_token_stream;
batches are random (block_size+1)-long windows gathered on the host into
one contiguous [B, T+1] int32 array per step: inputs = window[:-1],
targets = window[1:].
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Optional, Union

import numpy as np


def make_token_stream(vocab_size: int, length: int, seed: int = 0,
                      noise: float = 0.1) -> np.ndarray:
    """Synthetic LEARNABLE token stream: an affine walk
    x_{t+1} = (a·x_t + b) mod V with `noise` fraction of uniform
    replacements. A model that learns the transition map reaches
    ~noise·log(V) loss; a non-learner stays at log(V) — so a decreasing
    loss certifies real learning, not bookkeeping."""
    rng = np.random.default_rng(seed)
    a, b = 5, 3
    x = np.empty(length, np.int32)
    x[0] = rng.integers(vocab_size)
    for t in range(1, length):
        x[t] = (a * int(x[t - 1]) + b) % vocab_size
    flips = rng.random(length) < noise
    x[flips] = rng.integers(0, vocab_size, int(flips.sum()))
    return x


class TokenLoader:
    """Infinite iterator of [batch, block_size+1] int32 windows drawn
    uniformly from the stream."""

    def __init__(self, stream: Union[np.ndarray, str, Path],
                 batch_size: int, block_size: int, seed: int = 0):
        if isinstance(stream, (str, Path)):
            stream = np.load(stream, mmap_mode="r")
        assert stream.ndim == 1, f"token stream must be 1-D, got {stream.shape}"
        assert len(stream) > block_size + 1, (
            f"stream length {len(stream)} <= block_size+1")
        self.stream = stream
        self.batch_size = batch_size
        self.block_size = block_size
        self._rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[np.ndarray]:
        window = self.block_size + 1
        while True:
            starts = self._rng.integers(0, len(self.stream) - window,
                                        self.batch_size)
            yield np.stack([np.asarray(self.stream[s:s + window])
                            for s in starts]).astype(np.int32)
