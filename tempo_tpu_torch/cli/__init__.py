"""CLI entry points.

Every script follows the reference's contract (reference:
docs/repo_usage.md:35-42): `python -m tempo_tpu_torch.cli.<script> config.yaml
[--overwrite] [--debug]`; required config keys fail fast; the config is
copied into the output directory; --debug shrinks the run to minutes.
"""

from __future__ import annotations

import argparse
from typing import Callable


def run_cli(main: Callable[[str, bool, bool], None], description: str = "") -> None:
    parser = argparse.ArgumentParser(description=description)
    parser.add_argument("config_path", type=str, help="Path to YAML config")
    parser.add_argument("--overwrite", action="store_true",
                        help="Overwrite existing output directory")
    parser.add_argument("--debug", action="store_true",
                        help="Debug mode with reduced work")
    args = parser.parse_args()
    main(args.config_path, args.overwrite, args.debug)
