"""Device selection and memory observability; counterpart of
tempo_tpu/utils/devices.py over CUDA.

``device_memory_summary`` lists each CUDA device with its free and total
memory from ``torch.cuda.mem_get_info`` (the device-wide view: ``bytes_in_use``
is total minus free, every process's allocations included, where the JAX
package reports its own allocator's). ``get_freer_device`` picks the CUDA
device with the most free memory, the lowest index among ties. Both raise
where CUDA is not available unless the caller asks for ``"cpu"``, whose
one record reports no memory (as JAX's CPU devices) and which is returned
only when asked for.
"""

from __future__ import annotations

from typing import Dict, List, Union

import torch

from tempo_tpu_torch.device import resolve_device

Device = Union[str, torch.device, None]


def _record(dev: torch.device) -> Dict:
    if dev.type == "cpu":
        return {"id": 0, "platform": "cpu", "name": "cpu",
                "bytes_limit": None, "bytes_in_use": None, "bytes_free": None}
    free, total = torch.cuda.mem_get_info(dev)
    return {"id": dev.index, "platform": "gpu",
            "name": torch.cuda.get_device_name(dev), "bytes_limit": total,
            "bytes_in_use": total - free, "bytes_free": free}


def _candidates(device: Device) -> List[torch.device]:
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev]
    if dev.index is not None:
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def device_memory_summary(device: Device = None) -> List[Dict]:
    """One record per device (None: every CUDA device): id, platform,
    name, and free / total / in-use bytes (None on the CPU)."""
    return [_record(d) for d in _candidates(device)]


def get_freer_device(verbose: bool = False,
                     device: Device = None) -> torch.device:
    """The CUDA device with the most free memory (ties: the lowest index);
    ``device="cpu"`` returns the CPU."""
    records = device_memory_summary(device)
    best = max(records, key=lambda r: (r["bytes_free"] or 0, -r["id"]))
    if verbose:
        for rec in records:
            marker = " <- selected" if rec is best else ""
            print(f"device {rec['id']} [{rec['platform']}] "
                  f"free={rec['bytes_free']}{marker}")
    if best["platform"] == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", best["id"])
