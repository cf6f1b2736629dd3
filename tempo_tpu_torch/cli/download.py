#!/usr/bin/env python3
"""Download TEMPO granules from NASA Earthdata; the port's own copy of
tempo_tpu/cli/download.py (it runs no model and no kernel; the port
imports nothing of the JAX package).

    python -m tempo_tpu_torch.cli.download config.yaml [--overwrite] [--debug]

One script covers all five reference downloaders: the config's optional
`product` key derives L2 URLs from the RAD URL list by the RAD_L1 ->
<PRODUCT>_L2 substitution and writes the rad->l2 filename mapping yaml.
Auth uses ~/.netrc + ~/.urs_cookies; each file is fetched by a `wget`
subprocess; partially-downloaded files are removed on failure, and the
run exits 1 when any file failed. Config keys: output_dir, file_list,
product, max_files (3 with --debug).
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from tempo_tpu_torch.cli import run_cli
from tempo_tpu_torch.utils.config import (copy_config, load_config,
                                          require_keys, save_yaml)
from tempo_tpu_torch.utils.dirs import init_directory


def main(config_path: str, overwrite: bool = False, debug: bool = False) -> None:
    config = load_config(config_path)
    require_keys(config, ["output_dir", "file_list"])

    file_list = Path(config["file_list"])
    if not file_list.exists():
        raise ValueError(f"FATAL: {file_list} doesn't exist")

    output_dir = init_directory(config["output_dir"], overwrite=overwrite)
    raw_dir = output_dir / "raw"
    raw_dir.mkdir(exist_ok=True)
    copy_config(config_path, output_dir)

    with open(file_list) as f:
        rad_urls = [line.strip() for line in f if line.strip()]

    product = config.get("product")  # e.g. NO2 / O3TOT / HCHO / CLDO4
    if product:
        urls = [u.replace("RAD_L1", f"{product}_L2") for u in rad_urls]
        mapping = {Path(r).name: Path(u).name for r, u in zip(rad_urls, urls)}
        save_yaml(mapping, output_dir / f"rad_to_{product.lower()}_mapping.yaml")
    else:
        urls = rad_urls

    max_files = config.get("max_files")
    if debug:
        max_files = 3
    if max_files:
        urls = urls[:max_files]
    print(f"Downloading {len(urls)} files")

    if not (Path.home() / ".netrc").exists():
        print("ERROR: ~/.netrc required for NASA Earthdata")
        sys.exit(1)
    cookies = Path.home() / ".urs_cookies"
    cookies.touch(mode=0o600, exist_ok=True)

    failed = []
    for i, url in enumerate(urls, 1):
        filename = Path(url).name
        output_path = raw_dir / filename
        if output_path.exists():
            print(f"[{i}/{len(urls)}] EXISTS: {filename}")
            continue
        print(f"[{i}/{len(urls)}] Downloading: {filename}")
        cmd = [
            "wget", "-q",
            "--load-cookies", str(cookies),
            "--save-cookies", str(cookies),
            "--keep-session-cookies",
            "--no-check-certificate",
            "-O", str(output_path),
            url,
        ]
        result = subprocess.run(cmd)
        if result.returncode != 0:
            print("  FAILED")
            output_path.unlink(missing_ok=True)  # no partial files
            failed.append(url)

    print(f"\nDone. Failed: {len(failed)}")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    run_cli(main, "Download TEMPO granules (L1 or derived L2)")
