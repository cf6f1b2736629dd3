"""Minimal .env loader (python-dotenv is not a dependency).

Mirrors the contract the reference relies on (reference: src/utils.py:31 uses
dotenv.load_dotenv to populate DATA_DIR): parse KEY=VALUE lines from a .env
file found in the current directory or any parent, and export them into
os.environ without overriding existing values.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def find_dotenv(start: Optional[Path] = None) -> Optional[Path]:
    """Walk up from `start` (default cwd) looking for a .env file."""
    cur = Path(start or os.getcwd()).resolve()
    for parent in [cur, *cur.parents]:
        candidate = parent / ".env"
        if candidate.is_file():
            return candidate
    return None


def load_dotenv(path: Optional[Path] = None, override: bool = False) -> bool:
    """Load KEY=VALUE pairs from a .env file into os.environ.

    Returns True if a file was found and parsed.
    """
    dotenv_path = Path(path) if path is not None else find_dotenv()
    if dotenv_path is None or not dotenv_path.is_file():
        return False
    for raw_line in dotenv_path.read_text().splitlines():
        line = raw_line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip().strip("'\"")
        if not key:
            continue
        if override or key not in os.environ:
            os.environ[key] = value
    return True
