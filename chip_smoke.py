#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tempo_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. build   compile the CUDA kernels from tempo_tpu_torch/csrc with nvcc;
  2. kernels hold each kernel against its plain PyTorch version on the card
             at the shapes the main path gives it (discovered by running the
             tile batch and the granule once each), and time kernel, plain
             version and library calls;
  3. main    the flagship AutoencoderKL (27,289,893 parameters, bf16
             compute, weights from a seed): encode -> mode -> decode of an
             [8,64,64,1028] tile batch and GranuleCodec.reconstruct_raw of a
             [131,2048,1028] raw granule, with every launch counter set to 0
             just before and read just after; then its timings, and the tile
             and granule reconstructions against the same model run through
             the plain versions.
Prints the card's name and power limit first, one {"kernels": [...]} line,
and as the last line {"ok": true, "device": {...}}. Exits non-zero, with no
result, when there is no CUDA device or the package is not beside it.
"""

from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12          # H100 SXM memory rate
PEAK_FLOPS = {"bfloat16": 989e12,  # dense tensor-core rate
              "float32": 67e12}    # CUDA-core fp32 rate
SEED = 0

# Tolerances, kernel vs plain from the same inputs on the card:
# - bf16 outputs: both sides compute in fp32 and round once to bf16, so an
#   element may land one bf16 ulp apart (<= 2^-7 relative); the sums inside
#   differ only in fp32 order.
BF16_TOL = {"atol": 5e-3, "rtol": 2.0 ** -7}
# - fp32 statistics: fp32 sums in another order over up to 262,144 terms.
STATS_TOL = {"atol": 1e-5, "rtol": 1e-4}
# - fp32 kernel paths (TF32 off on the plain side): K2 sums 9*C products in
#   another order.
F32_TOL = {"atol": 1e-4, "rtol": 1e-4}
# - whole model, bf16: ~30 layers each rounding activations to bf16, with
#   one-ulp flips between the two paths compounding: relative L2 error.
MODEL_BF16_REL_L2 = 5e-2
# - whole model, fp32, one tile: fp32 sum order only.
MODEL_F32_REL_L2 = 1e-4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median device time of one call, by CUDA events around each call, with
    the 50 MB L2 flushed before each (the path's callers find it cold)."""
    import torch

    flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(iters):
        flush.zero_()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def max_err(got, want, tol) -> tuple[float, bool]:
    """(max |got - want|, whether every element is within atol + rtol*|want|)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    ok = bool(torch_all_finite(g)) and bool(
        (diff <= tol["atol"] + tol["rtol"] * w.abs()).all())
    return float(diff.max()), ok


def torch_all_finite(t) -> bool:
    import torch

    return bool(torch.isfinite(t).all())


def rel_l2(got, want) -> float:
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the plain versions of K1 and K2 (on the card)
    for the comparison; the port itself never does this."""
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv
    from tempo_tpu_torch.ops.norms import group_norm

    saved = (cuda_gn.fused_group_norm_act, cuda_gn_conv.gn_act_conv3x3)

    def gn_plain(x, scale, bias, num_groups, eps=1e-6, act="gelu"):
        return group_norm(x, num_groups, scale, bias, eps, act)

    def conv_plain(x, scale, bias, weight, conv_bias, num_groups, eps=1e-6,
                   act="gelu", packed=None):
        return cuda_gn_conv.gn_act_conv3x3_plain(
            x, scale, bias, weight, conv_bias, num_groups, eps, act)

    cuda_gn.fused_group_norm_act = gn_plain
    cuda_gn_conv.gn_act_conv3x3 = conv_plain
    try:
        yield
    finally:
        cuda_gn.fused_group_norm_act, cuda_gn_conv.gn_act_conv3x3 = saved


@contextlib.contextmanager
def recording(calls: dict, run: str):
    """Record the argument shapes of every kernel call the path makes, each
    tagged with the run (tile batch or granule) that made it."""
    from tempo_tpu_torch.ops import cuda_gn, cuda_gn_conv

    saved = (cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3)

    def stats(x, num_groups, eps=1e-6):
        calls["K1a"].append(((tuple(x.shape), num_groups, eps), run))
        return saved[0](x, num_groups, eps)

    def apply(x, st, scale, bias, act=None):
        calls["K1b"].append(((tuple(x.shape), act), run))
        return saved[1](x, st, scale, bias, act)

    def conv(x, scale, bias, weight, conv_bias, num_groups, eps=1e-6,
             act="gelu", packed=None):
        calls["K2"].append(((tuple(x.shape), weight.shape[0], num_groups, eps,
                             act), run))
        return saved[2](x, scale, bias, weight, conv_bias, num_groups, eps,
                        act, packed)

    cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3 = (
        stats, apply, conv)
    try:
        yield
    finally:
        cuda_gn.gn_stats, cuda_gn.gn_apply, cuda_gn_conv.gn_act_conv3x3 = saved


def nudge_zero_init(model, generator) -> None:
    """Random weights in place of the zero-initialized output convs, so the
    reconstruction depends on every layer."""
    import torch

    with torch.no_grad():
        for p in model.parameters():
            if p.ndim and not p.any():
                fan_in = math.prod(p.shape[1:]) if p.ndim > 1 else 512
                bound = 1.0 / math.sqrt(fan_in)
                p.uniform_(-bound, bound, generator=generator)


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        from tempo_tpu_torch.infer.granule_codec import GranuleCodec
        from tempo_tpu_torch.models.vae import build_vae
        from tempo_tpu_torch.ops import _build, cuda_gn, cuda_gn_conv
        from tempo_tpu_torch.ops.norms import ACTIVATIONS
    except ImportError as e:
        fail(f"the tempo_tpu_torch package is not beside this script: {e}")

    print(smi_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # ------------------------------------------------------------ 1. build
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s (sources: "
          f"{[p.name for p in _build._sources()]})", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # ------------------------------------ model and inputs of the main path
    model, cfg = build_vae({}, device=dev, seed=SEED)
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != 27_289_893:
        fail(f"flagship parameter count {n_params} != 27,289,893")
    nudge_zero_init(model, gen)
    model.eval()
    tiles = torch.randn((8, 64, 64, 1028), generator=gen, device=dev)
    rng_raw = torch.Generator().manual_seed(SEED)
    raw = torch.exp(3.0 + 0.5 * torch.randn(
        (131, 2048, 1028), generator=rng_raw)).numpy()
    codec = GranuleCodec(model, seed=SEED, device=dev)

    def encode_decode():
        return model.decode(model.encode(tiles).mode())

    gt = codec.normalize(raw)                  # [128, 2048, 1028] on the host

    def granule_forward():
        return codec.reconstruct(gt, sample_posterior=False)

    # ------------------------------------------------------ 2. kernels
    # The shapes of both runs of the main path: the tile batch and the
    # granule (B=1, up to 128x2048 pixels) give the kernels different grids.
    calls = {"K1a": [], "K1b": [], "K2": []}
    with torch.inference_mode():
        with recording(calls, "tile"):
            encode_decode()
        with recording(calls, "granule"):
            granule_forward()
    torch.cuda.synchronize()
    print(f"[kernels] calls per main-path run: "
          f"{ {k: len(v) for k, v in calls.items()} }", flush=True)

    def affine(c):
        scale = 1 + 0.1 * torch.randn(c, generator=gen, device=dev)
        bias = 0.1 * torch.randn(c, generator=gen, device=dev)
        return scale, bias

    def nchw(t):
        return t.permute(0, 3, 1, 2)

    def act_fn(act):
        return ACTIVATIONS[act] if act else (lambda t: t)

    rows = {}
    checks_ok = True

    def row(name, source, replaces, library, **extra):
        return rows.setdefault(name, dict({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": 0, "max_abs_err": 0.0,
            "tol": BF16_TOL if name != "K1a" else STATS_TOL,
            "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": None,
            "library_ms": None, "library": library,
            "per": "one main-path run (an [8,64,64,1028] encode+decode and "
                   "a [128,2048,1028] granule reconstruct): sum over the "
                   "kernel's calls there, each timed alone with a cold L2",
            "ms_by_run": {"tile": 0.0, "granule": 0.0}, "shapes": []},
            **extra))

    def add(r, shape_info, n, err, ok, ms, plain_ms, bound_ms, bound_by,
            lib_ms, extra=None):
        """Add one shape's readings to row ``r``; ``n`` is its calls per
        run ({"tile": ., "granule": .}); ``extra`` holds more times, each
        summed into the row's key of the same name."""
        total = sum(n.values())
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += total * ms
        r["plain_ms"] += total * plain_ms
        r["bound_ms"] += total * bound_ms
        r["bound_by"] = bound_by
        for run, k in n.items():
            r["ms_by_run"][run] += k * ms
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + total * lib_ms
        for key, value in (extra or {}).items():
            if key in r:
                r[key] += total * value
        r["shapes"].append(dict(shape_info, calls=n, ok=ok, max_abs_err=err,
                                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                library_ms=lib_ms, **(extra or {})))

    def count(lst):
        out = {}
        for key, run in lst:
            out.setdefault(key, {"tile": 0, "granule": 0})[run] += 1
        return out

    with torch.inference_mode():
        # K1a: statistics at every shape the path gives it.
        r = row("K1a", "tempo_tpu_torch/csrc/gn.cu",
                "tempo_tpu/ops/pallas_gn.py:66",
                "torch.var_mean over the [B,HW,G,C/G] view")
        for (shape, groups, eps), n in count(calls["K1a"]).items():
            b, c = shape[0], shape[-1]
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            got = cuda_gn.gn_stats(x, groups, eps)
            want = cuda_gn.gn_stats_plain(x, groups, eps)
            err, ok = max_err(got, want, STATS_TOL)
            checks_ok &= ok
            nbytes = x.numel() * 2 + got.numel() * 4
            xg = x.view(b, -1, groups, c // groups)
            add(r, {"x": list(shape)}, n, err, ok,
                time_ms(lambda: cuda_gn.gn_stats(x, groups, eps)),
                time_ms(lambda: cuda_gn.gn_stats_plain(x, groups, eps)),
                1e3 * nbytes / HBM_BYTES_PER_S, "bytes",
                time_ms(lambda: torch.var_mean(xg, dim=(1, 3),
                                               correction=0)))

        # K1b: apply from given statistics at the path's shapes and at the
        # two shapes asked of K1. The library GroupNorm computes the
        # statistics too, so it stands beside K1 whole (K1a + K1b).
        r = row("K1b", "tempo_tpu_torch/csrc/gn.cu",
                "tempo_tpu/ops/pallas_gn.py:105",
                "F.group_norm + activation: statistics and apply; compare "
                "with k1_whole_ms", k1_whole_ms=0.0)
        k1_shapes = count(calls["K1b"])
        for key in [((8, 64, 64, 512), "gelu"), ((8, 16, 16, 128), None)]:
            k1_shapes.setdefault(key, {"tile": 0, "granule": 0})
        for (shape, act), n in k1_shapes.items():
            c = shape[-1]
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            scale, bias = affine(c)
            st = cuda_gn.gn_stats_plain(x, 8, 1e-6)
            want = cuda_gn.gn_apply_plain(x, st, scale, bias, act)
            err, ok = max_err(cuda_gn.gn_apply(x, st, scale, bias, act), want,
                              BF16_TOL)
            whole_err, whole_ok = max_err(
                cuda_gn.fused_group_norm_act(x, scale, bias, 8, 1e-6, act),
                want, BF16_TOL)
            checks_ok &= ok and whole_ok
            sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            nbytes = 2 * x.numel() * 2 + st.numel() * 4 + 2 * c * 4
            add(r, {"x": list(shape), "act": act}, n, max(err, whole_err),
                ok and whole_ok,
                time_ms(lambda: cuda_gn.gn_apply(x, st, scale, bias, act)),
                time_ms(lambda: cuda_gn.gn_apply_plain(x, st, scale, bias,
                                                       act)),
                1e3 * nbytes / HBM_BYTES_PER_S, "bytes",
                time_ms(lambda: act_fn(act)(torch.nn.functional.group_norm(
                    nchw(x), 8, sb, bb, 1e-6))),
                {"k1_whole_ms": time_ms(
                    lambda: cuda_gn.fused_group_norm_act(x, scale, bias, 8,
                                                         1e-6, act))})

        # K2 at every distinct shape of the path. The check holds the whole
        # wrapper (K1a statistics, then K2) against the plain chain; "ms"
        # times the K2 launch alone from precomputed statistics, beside the
        # plain version of that step and cuDNN's conv of the activated input.
        # The library chain computes the statistics too, so it stands beside
        # whole_ms (K1a + K2).
        r = row("K2", "tempo_tpu_torch/csrc/gn_conv.cu",
                "tempo_tpu/ops/pallas_gn_conv.py:53",
                "F.group_norm + activation + F.conv2d (cuDNN); compare with "
                "whole_ms", whole_ms=0.0, library_conv_ms=0.0)
        for (shape, f, groups, eps, act), n in count(calls["K2"]).items():
            b, h, w, c = shape
            x = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
            scale, bias = affine(c)
            weight = torch.empty((f, c, 3, 3), device=dev).uniform_(
                -(9 * c) ** -0.5, (9 * c) ** -0.5, generator=gen)
            cb = 0.01 * torch.randn(f, generator=gen, device=dev)
            packed = cuda_gn_conv.pack_conv3x3_weight(weight, torch.bfloat16)
            got = cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight, cb,
                                              groups, eps, act, packed)
            want = cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight,
                                                     cb, groups, eps, act)
            err, ok = max_err(got, want, BF16_TOL)
            checks_ok &= ok
            del got, want
            st = cuda_gn.gn_stats(x, groups, eps)
            flops = 2 * b * h * w * 9 * c * f
            nbytes = ((x.numel() + packed.numel() + b * h * w * f) * 2
                      + st.numel() * 4)
            by = ("operations" if flops / PEAK_FLOPS["bfloat16"]
                  >= nbytes / HBM_BYTES_PER_S else "bytes")
            bound = 1e3 * max(flops / PEAK_FLOPS["bfloat16"],
                              nbytes / HBM_BYTES_PER_S)
            sb, bb = scale.to(torch.bfloat16), bias.to(torch.bfloat16)
            wb, cbb = weight.to(torch.bfloat16), cb.to(torch.bfloat16)
            activated = nchw(cuda_gn.gn_apply_plain(x, st, scale, bias, act))
            ms = time_ms(lambda: cuda_gn_conv.conv3x3_from_stats(
                x, st, scale, bias, weight, cb, act, packed))
            add(r, {"x": list(shape), "f": f}, n, err, ok, ms,
                time_ms(lambda: cuda_gn_conv.conv3x3_from_stats_plain(
                    x, st, scale, bias, weight, cb, act)),
                bound, by,
                time_ms(lambda: torch.nn.functional.conv2d(
                    act_fn(act)(torch.nn.functional.group_norm(
                        nchw(x), groups, sb, bb, eps)), wb, cbb, padding=1)),
                {"whole_ms": time_ms(lambda: cuda_gn_conv.gn_act_conv3x3(
                    x, scale, bias, weight, cb, groups, eps, act, packed)),
                 "library_conv_ms": time_ms(
                     lambda: torch.nn.functional.conv2d(activated, wb, cbb,
                                                        padding=1)),
                 "gflop": flops / 1e9, "tflops": flops / ms / 1e9})
            del x, activated

        # fp32 kernel paths at one shape each (the plain side without TF32).
        x = torch.randn((8, 16, 16, 128), generator=gen, device=dev)
        scale, bias = affine(128)
        weight = torch.empty((128, 128, 3, 3), device=dev).uniform_(
            -0.03, 0.03, generator=gen)
        cb = 0.01 * torch.randn(128, generator=gen, device=dev)
        for name, got, want in [
            ("K1 f32", cuda_gn.fused_group_norm_act(x, scale, bias, 8),
             cuda_gn.gn_apply_plain(x, cuda_gn.gn_stats_plain(x, 8), scale,
                                    bias, "gelu")),
            ("K2 f32", cuda_gn_conv.gn_act_conv3x3(x, scale, bias, weight,
                                                   cb, 8),
             cuda_gn_conv.gn_act_conv3x3_plain(x, scale, bias, weight, cb,
                                               8))]:
            err, ok = max_err(got, want, F32_TOL)
            print(f"[kernels] {name} [8,16,16,128]: max_abs_err={err:.3e} "
                  f"tol={F32_TOL} ok={ok}", flush=True)
            checks_ok &= ok
    torch.cuda.synchronize()
    for r in rows.values():
        for s in r["shapes"]:
            print(f"[kernels] {r['name']} {json.dumps(s)}", flush=True)
    if not checks_ok:
        fail("a kernel disagrees with its plain version beyond tolerance")

    # ---------------------------------------------------------- 3. main path
    with torch.inference_mode():
        encode_decode()                        # warm: cuDNN plans, caches
        granule_forward()
        torch.cuda.synchronize()

        counters = {"K1a": (cuda_gn.LAUNCHES, "gn_stats"),
                    "K1b": (cuda_gn.LAUNCHES, "gn_apply"),
                    "K2": (cuda_gn_conv.LAUNCHES, "gn_act_conv3x3")}
        for table, key in counters.values():
            table[key] = 0
        post = model.encode(tiles)
        recon = model.decode(post.mode())
        gt, grecon = codec.reconstruct_raw(raw, sample_posterior=False)
        torch.cuda.synchronize()
        launches = {k: table[key] for k, (table, key) in counters.items()}
        print(f"[main] launches in the main-path run: {launches}", flush=True)
        for name, n in launches.items():
            rows[name]["launches"] = n
            if n == 0:
                fail(f"kernel {name} was not launched on the main path")
            if n != len(calls[name]):
                fail(f"kernel {name}: {n} launches, {len(calls[name])} "
                     f"calls recorded for phase 2")

        if recon.shape != tiles.shape or not torch_all_finite(recon):
            fail(f"tile reconstruction bad: {tuple(recon.shape)}")
        if post.mean.shape != (8, 16, 16, 32):
            fail(f"latent shape {tuple(post.mean.shape)}")
        if gt.shape != (128, 2048, 1028) or grecon.shape != gt.shape:
            fail(f"granule shapes {gt.shape} {grecon.shape}")
        if not (np_all_finite(grecon)):
            fail("granule reconstruction is not finite")

        t_encdec = time_ms(encode_decode, iters=5, warmup=1)
        t_enc = time_ms(lambda: model.encode(tiles), iters=5, warmup=1)
        t0 = time.perf_counter()
        codec.reconstruct_raw(raw, sample_posterior=False)
        t_granule = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        t_granule_fwd = time_ms(granule_forward, iters=3, warmup=0)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"[main] tile batch 8: encode {t_enc:.2f} ms "
              f"({8e3 / t_enc:.1f} patches/s), encode+decode "
              f"{t_encdec:.2f} ms ({8e3 / t_encdec:.1f} patches/s)", flush=True)
        print(f"[main] granule [131,2048,1028]: reconstruct_raw "
              f"{t_granule * 1e3:.1f} ms host wall (incl. host normalize); "
              f"reconstruct of the normalized crop {t_granule_fwd:.1f} ms "
              f"device (incl. copies); peak device memory {peak_gb:.1f} GB",
              flush=True)

        with plain_kernels():
            recon_plain = model.decode(model.encode(tiles).mode())
            grecon_plain = granule_forward()
        err_bf16 = rel_l2(recon, recon_plain)
        err_granule = rel_l2(torch.from_numpy(grecon),
                             torch.from_numpy(grecon_plain))
        del grecon_plain
    model32, _ = build_vae({}, compute_dtype="float32", device=dev)
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        one = tiles[:1]
        r32 = model32.reconstruct(one, sample_posterior=False)
        with plain_kernels():
            r32_plain = model32.reconstruct(one, sample_posterior=False)
        err_f32 = rel_l2(r32, r32_plain)
    print(f"[main] reconstruction vs plain path, rel L2: bf16 tile batch 8 "
          f"{err_bf16:.3e}, bf16 granule {err_granule:.3e} (tol "
          f"{MODEL_BF16_REL_L2} each); fp32 one tile {err_f32:.3e} (tol "
          f"{MODEL_F32_REL_L2})", flush=True)
    if not err_bf16 <= MODEL_BF16_REL_L2:
        fail("bf16 tile reconstruction disagrees with the plain path")
    if not err_granule <= MODEL_BF16_REL_L2:
        fail("bf16 granule reconstruction disagrees with the plain path")
    if not err_f32 <= MODEL_F32_REL_L2:
        fail("fp32 reconstruction disagrees with the plain path")

    for r in rows.values():
        r.pop("shapes")
    print(json.dumps({"kernels": list(rows.values()), "main": {
        "encode_ms_b8": t_enc, "encode_patches_per_s": 8e3 / t_enc,
        "encode_decode_ms_b8": t_encdec,
        "granule_reconstruct_raw_s": t_granule,
        "granule_reconstruct_ms": t_granule_fwd, "peak_device_gb": peak_gb,
        "recon_rel_l2_bf16": err_bf16, "recon_rel_l2_granule": err_granule,
        "recon_rel_l2_f32": err_f32}}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def np_all_finite(a) -> bool:
    import numpy as np

    return bool(np.isfinite(a).all())


if __name__ == "__main__":
    sys.exit(main())
