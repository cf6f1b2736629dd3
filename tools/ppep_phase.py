#!/usr/bin/env python3
"""chip_smoke.py's phase 18 alone on one CUDA GPU: the kernel library
built from the sources, then expert and pipeline parallelism over two rank
processes sharing the card over gloo (18a-c), every gate as in the whole
script.

    python3 tools/ppep_phase.py

Prints the card's name and power limit, the build's seconds, phase 18's
result line and its seconds, and K5's phase-18 launches.
"""

from __future__ import annotations

import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tempo_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs on a GPU")
    print(chip_smoke.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    rows = {k: {} for k in ("K5f", "K5dkv", "K5dq")}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        chip_smoke.ppep_path(dev, rows, Path(root))
        seconds = time.perf_counter() - t0
    print(f"[time] phase 18 {seconds:.1f} s", flush=True)
    print(json.dumps({k: r["launches_phase18"] for k, r in rows.items()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
