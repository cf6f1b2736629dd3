"""metrics.json output; counterpart of tempo_tpu/train/metrics.py."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Union


def save_metrics(output_dir: Union[str, Path], train_metrics: List[Dict],
                 val_metrics: List[Dict]) -> Path:
    """Write {"train": [...], "val": [...]} to output_dir/metrics.json."""
    path = Path(output_dir) / "metrics.json"
    with open(path, "w") as f:
        json.dump({"train": train_metrics, "val": val_metrics}, f, indent=2)
    return path
