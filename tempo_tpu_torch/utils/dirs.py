"""Safe output-directory initialization.

Capability parity with the reference's init_directory contract
(reference: src/utils.py:12-71): a fresh output directory is created for every
run; an existing directory is only removed when --overwrite is passed AND the
directory lives under the DATA_DIR safety prefix (loaded from .env / the
environment). This prevents accidental deletion outside the data tree.
"""

from __future__ import annotations

import os
import shutil
import sys
from pathlib import Path
from typing import Union

from tempo_tpu_torch.utils.env import load_dotenv


class DirectoryExistsError(SystemExit):
    pass


def init_directory(directory: Union[str, Path], overwrite: bool = False,
                   allow_existing: bool = False) -> Path:
    """Create `directory`, enforcing the overwrite safety contract.

    - If it does not exist: create it (with parents) and return it.
    - If it exists and overwrite=False: exit with an error — unless
      allow_existing=True (the preemption auto-resume path, which must
      re-enter its own output directory), in which case it is returned
      untouched.
    - If it exists and overwrite=True: require DATA_DIR to be set and to be a
      path prefix of the resolved directory, then rm -rf and recreate.
    """
    load_dotenv()
    directory = Path(directory)

    if directory.exists():
        if allow_existing and not overwrite:
            return directory
        if not overwrite:
            print(f"Error: Directory {directory} already exists!")
            print("Use --overwrite to remove it, or choose a different path.")
            sys.exit(1)

        safe_prefix = os.environ.get("DATA_DIR")
        if not safe_prefix:
            print("Error: DATA_DIR not set (in .env or environment)!")
            print("Cannot use --overwrite without DATA_DIR for safety.")
            sys.exit(1)

        safe_prefix_resolved = Path(safe_prefix).resolve()
        dir_resolved = directory.resolve()
        try:
            dir_resolved.relative_to(safe_prefix_resolved)
        except ValueError:
            print(f"Error: Cannot overwrite {dir_resolved}")
            print(f"Directory must live under DATA_DIR: {safe_prefix_resolved}")
            sys.exit(1)

        print(f"Removing existing directory: {dir_resolved}")
        shutil.rmtree(dir_resolved)

    directory.mkdir(parents=True, exist_ok=False)
    return directory
