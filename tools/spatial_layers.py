#!/usr/bin/env python3
"""Where a spatially sharded encode departs from one process, layer by
layer, on one CUDA GPU.

    python3 tools/spatial_layers.py

The flagship AutoencoderKL in bf16 (chip_smoke.py's seed-0 weights, the
zero-initialized output convs re-drawn) encodes a structured granule
[131, 2048, 1028] (cropped to [128, 2048]) in this process, then in two
rank processes that share the card over gloo (tempo_tpu_torch/parallel/
spatial.py through GranuleCodec(mesh=)). Both encode the same normalized
granule. Forward hooks record each listed encoder module's output; rank
0's share is held against the same columns of the one-process output, and
one line a module prints its rel L2 and its largest per-column error.
Then the latent of rank 0's own sharded normalize (the granule's own
statistics summed in float64 over the ranks) against the one-process
latent, and the normalize's largest difference.
"""

from __future__ import annotations

import datetime
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

ROOT_DIR = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT_DIR))

import chip_smoke as cs  # noqa: E402
from tempo_tpu_torch.data.synthetic import structured_granule  # noqa: E402
from tempo_tpu_torch.infer.granule_codec import GranuleCodec  # noqa: E402
from tempo_tpu_torch.parallel.mesh import create_mesh  # noqa: E402

MODULES = ["conv_in", "downs.0.resnet_blocks.0", "downs.0.down",
           "downs.1.resnet_blocks.0", "downs.1.down", "downs.2", "mid1",
           "mid_attn1.norm", "mid_attn1.q", "mid_attn1", "mid2", ""]
WORLD = 2


def _setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _hooked(model, out: dict) -> list:
    """Hooks that keep each module's output (fp32, on the host)."""
    handles = []
    for name in MODULES:
        mod = model.encoder.get_submodule(name) if name else model.encoder

        def hook(m, args, o, name=name):
            out[name or "encoder"] = o.detach().float().cpu()

        handles.append(mod.register_forward_hook(hook))
    return handles


def child(root: Path, rank: int) -> None:
    """One rank: its own normalize, then the hooked encode of the saved
    normalized granule; rank 0 saves its shares."""
    _setup()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{root}/store",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=300))
    gt = np.load(root / "gt.npy", mmap_mode="r")
    rad = np.load(root / "rad.npy", mmap_mode="r")
    model = cs.par_vae(dev, cs.VAE_MODEL).eval()
    codec = GranuleCodec(model, seed=cs.SEED, device=dev,
                         mesh=create_mesh(dev))
    with torch.inference_mode():
        share = codec.normalize_tensor(rad)
        lo = rank * share.shape[1]
        want = torch.from_numpy(np.array(gt[:, lo:lo + share.shape[1]]))
        res = {"normalize_max_abs": float(
            (share.cpu() - want).abs().max())}
        out = {"latent_own_normalize": codec.encode(share).float().cpu()}
        handles = _hooked(model, out)
        out["latent"] = codec.encode(gt).float().cpu()
    for h in handles:
        h.remove()
    if rank == 0:
        torch.save(out, root / "rank0.pt")
        (root / "res0.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def main() -> None:
    _setup()
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        rad, _ = structured_granule(np.random.default_rng(cs.SEED),
                                    *cs.SPATIAL["granule"])
        np.save(root / "rad.npy", rad)
        model = cs.par_vae(dev, cs.VAE_MODEL).eval()
        codec = GranuleCodec(model, seed=cs.SEED, device=dev)
        gt = codec.normalize(rad)
        np.save(root / "gt.npy", gt)
        out = {}
        handles = _hooked(model, out)
        with torch.inference_mode():
            out["latent"] = codec.encode(gt).float().cpu()
        for h in handles:
            h.remove()
        del model, codec
        torch.cuda.empty_cache()
        procs = [subprocess.Popen([sys.executable, __file__, "child", tmp,
                                   str(r)]) for r in range(WORLD)]
        for p in procs:
            p.wait(timeout=600)
        if any(p.returncode for p in procs):
            sys.exit(f"a rank failed: {[p.returncode for p in procs]}")
        got = torch.load(root / "rank0.pt")
        res = json.loads((root / "res0.json").read_text())
    print(cs.smi_line(), flush=True)
    for name, g in got.items():
        w = out["latent" if name == "latent_own_normalize" else name]
        if g.dim() == 3:
            g, w = g[None], w[None]
        w = w[:, :, :g.shape[2]]
        col = (g - w).abs().amax(dim=(0, 1, 3))
        print(json.dumps({"module": name, "share": list(g.shape),
                          "rel_l2": float((g - w).norm() / w.norm()),
                          "max_abs": float(col.max()),
                          "worst_column": int(col.argmax())}), flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["child"]:
        child(Path(sys.argv[2]), int(sys.argv[3]))
    else:
        main()
