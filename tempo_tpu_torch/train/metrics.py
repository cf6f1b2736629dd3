"""Running metrics, metric sinks and metrics.json output; counterpart of
tempo_tpu/train/metrics.py.

``RunningMetrics`` is EMA(alpha) smoothing on the host (the first update
seeds the average); the trainer keeps its own EMA on the device
(train/step.py). ``JsonlSink`` is the trainer's pluggable sink: it appends
one JSON line per emission, ``{"step", "kind", **metrics}``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union


class RunningMetrics:
    """EMA-smoothed metrics; the first update seeds the average (alpha 0
    on the first step)."""

    def __init__(self, alpha: float = 0.99):
        self.alpha = alpha
        self.values: Dict[str, float] = {}

    def update(self, metrics: Dict[str, float]) -> Dict[str, float]:
        alpha = self.alpha if self.values else 0.0
        for k, v in metrics.items():
            self.values[k] = (alpha * self.values.get(k, 0.0)
                              + (1 - alpha) * float(v))
        return dict(self.values)

    def snapshot(self) -> Dict[str, float]:
        return dict(self.values)


def save_metrics(output_dir: Union[str, Path], train_metrics: List[Dict],
                 val_metrics: List[Dict]) -> Path:
    """Write {"train": [...], "val": [...]} to output_dir/metrics.json."""
    path = Path(output_dir) / "metrics.json"
    with open(path, "w") as f:
        json.dump({"train": train_metrics, "val": val_metrics}, f, indent=2)
    return path


class JsonlSink:
    """Appends one JSON line per emission to a .jsonl file. Pass instances
    as Trainer(metric_sinks=[...]); called as sink(step, metrics, kind)
    with kind in {'train', 'val'}."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def __call__(self, step: int, metrics: Dict[str, float],
                 kind: str) -> None:
        record = {"step": step, "kind": kind, **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
