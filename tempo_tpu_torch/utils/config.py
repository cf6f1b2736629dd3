"""YAML config loading with fail-fast validation.

Every CLI entry point follows the reference's contract (reference:
docs/repo_usage.md:35-42): exactly `config_path [--overwrite] [--debug]`,
required keys raise before any work starts, and the config is copied into the
output directory for reproducibility.

Copy of tempo_tpu/utils/config.py for the port; ``yaml`` is imported inside
the functions that read or write YAML, so the package imports where PyYAML
is absent. There ``load_config`` reads JSON, which is YAML too (the port
writes the configs and infos of its runs as JSON).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from pathlib import Path
from typing import Any, Dict, Iterable, Union


def load_config(config_path: Union[str, Path]) -> Dict[str, Any]:
    config_path = Path(config_path)
    if not config_path.exists():
        raise ValueError(f"FATAL: config file doesn't exist: {config_path}")
    text = config_path.read_text()
    try:
        import yaml
    except ImportError:
        config = json.loads(text)
    else:
        config = yaml.safe_load(text)
    if not isinstance(config, dict):
        raise ValueError(f"FATAL: config must be a mapping: {config_path}")
    return _expand_env(config)


_ENV_REF = re.compile(r"\$\$|\$\{(\w+)\}|\$(\w+)")


def _expand_env(node: Any) -> Any:
    """Expand ${VAR} / $VAR in string values, fail-fast on unset ${VAR}.

    A hand-rolled substitution rather than os.path.expandvars: expandvars
    silently passes unset brace-less '$VAR' through as a literal string,
    which would defeat the documented fail-fast contract (portable configs
    — e.g. configs/demo/ — anchor paths on DATA_DIR and must error loudly
    when it is missing). Strictness is per form:
      - ${VAR}: the explicit env-reference syntax — unset raises.
      - $VAR: expands only when the variable is set; otherwise it stays a
        literal (config values like shell snippets or '$1' field refs must
        not be rejected).
      - $$: escapes to a literal '$'."""
    if isinstance(node, dict):
        return {k: _expand_env(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_expand_env(v) for v in node]
    if isinstance(node, str) and "$" in node:
        def _sub(m: re.Match) -> str:
            if m.group(0) == "$$":
                return "$"
            braced, bare = m.group(1), m.group(2)
            var = braced or bare
            if var in os.environ:
                return os.environ[var]
            if braced:
                raise ValueError(
                    f"FATAL: unset environment variable '{var}' in config "
                    f"value: {node}")
            return m.group(0)

        return _ENV_REF.sub(_sub, node)
    return node


def require_keys(config: Dict[str, Any], keys: Iterable[str], where: str = "config") -> None:
    """Fail-fast validation: each key may be dotted ('data.train_dir')."""
    for dotted in keys:
        node: Any = config
        for part in dotted.split("."):
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"FATAL: '{dotted}' is required in {where}")
            node = node[part]


def copy_config(config_path: Union[str, Path], output_dir: Union[str, Path]) -> Path:
    dst = Path(output_dir) / "config.yaml"
    shutil.copy2(config_path, dst)
    return dst


def save_yaml(obj: Any, path: Union[str, Path]) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.dump(obj, f)


def save_json_yaml(obj: Any, path: Union[str, Path]) -> None:
    """A YAML file written as JSON: YAML readers read it, and no YAML
    writer is needed (the card's machine has none)."""
    Path(path).write_text(json.dumps(obj, indent=2) + "\n")
