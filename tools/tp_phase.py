#!/usr/bin/env python3
"""chip_smoke.py's phase 17 alone on one CUDA GPU: the kernel library
built from the sources, then tensor parallelism over two rank processes
sharing the card over gloo and the sharded checkpoint (17a-c), every gate
as in the whole script.

    python3 tools/tp_phase.py
    python3 tools/tp_phase.py --beside-16

Prints the card's name and power limit, the build's seconds, phase 17's
result line and its seconds, and each kernel's phase-17 launches.
``--beside-16`` makes phase 16's granule (the host data process) and then
runs phases 16 and 17 three times: phase 17's rank processes started
beside phase 16 (so their imports overlap it, as the whole script does),
started by phase 17 itself, and beside phase 16 again; it prints each
round's phase 16 and 17 seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from tempo_tpu_torch.ops import _build  # noqa: E402

KERNELS = ("K1a", "K1b", "K2", "K3", "K4", "K5f", "K5dkv", "K5dq")


def phases_16_17(dev, granule: Path, beside: bool) -> dict:
    """Phase 16 then phase 17, phase 17's ranks started before phase 16
    (``beside``) or by phase 17; the seconds of each."""
    rows = {k: {} for k in KERNELS}
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED + 16)
    with tempfile.TemporaryDirectory() as tp_root, \
            tempfile.TemporaryDirectory() as tmp:
        started = chip_smoke.tp_start(dev, Path(tp_root)) if beside else None
        t0 = time.perf_counter()
        chip_smoke.spatial_path(dev, gen, rows, Path(tmp), granule)
        t16 = time.perf_counter() - t0
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        chip_smoke.tp_path(dev, rows, Path(tp_root), started)
        t17 = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return {"ranks_of_17_started": "beside 16" if beside else "by 17",
            "16": t16, "17": t17, "16+17": t16 + t17}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--beside-16", action="store_true",
                        help="time phases 16 and 17 with phase 17's ranks "
                             "started beside phase 16 and by phase 17")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        chip_smoke.fail("no CUDA device: this script runs on a GPU")
    print(chip_smoke.smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    if args.beside_16:
        with tempfile.TemporaryDirectory() as host_root:
            host = chip_smoke.HostData(Path(host_root))
            granule = host.granule_path()
            print(f"[host data] {json.dumps(host.wait())}", flush=True)
            rounds = [phases_16_17(dev, granule, beside)
                      for beside in (True, False, True)]
            host.stop()
        print(f"[overlap] phases 16 and 17, s: {json.dumps(rounds)}",
              flush=True)
        return 0
    rows = {k: {} for k in KERNELS}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.tp_path(dev, rows, Path(tmp))
    print(f"[tp] phase 17 {time.perf_counter() - t0:.1f} s", flush=True)
    print(json.dumps({k: v["launches_phase17"] for k, v in rows.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
