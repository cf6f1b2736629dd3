"""K1: GroupNorm statistics (K1a) and GroupNorm + activation apply (K1b).

Counterpart of tempo_tpu/ops/pallas_gn.py (``_stats_kernel`` and
``_apply_kernel``); the CUDA source is csrc/gn.cu, whose header says what
bounds the kernels on the H100 and how they are laid out.

K1a is one launch: ``choose_stats_split`` cuts each sample's rows into
blocks from (HW, C, dtype) alone, each block writes its per-group partial
sums, and the last block of a sample to arrive (a per-sample counter, kept
per stream at zero between calls) folds them in block order.

K1a's sums mode is the same launch, split and fold writing each group's
[Σx, Σx²] instead of mean and rstd (``tempo::gn_sums``): a sample held in
pieces (spatial sharding, parallel/spatial.py) adds its pieces' sums over
the ranks and finishes them with ``stats_from_sums``, K1a's own formula.

K1a, its sums mode and K1b are the ``torch.library`` ops
``tempo::gn_stats``, ``tempo::gn_sums`` and ``tempo::gn_apply``: their CPU
kernel is the plain PyTorch version beside it, their CUDA kernel launches
the hand-written kernel or raises, and their fake gives the output's shape
and type from the inputs' alone, so ``torch.export`` traces them with a
symbolic batch. Everything that reads a concrete value (pointers, the
stream, the split) stays inside the CUDA kernel. The wrappers
``gn_stats``, ``gn_sums`` and ``gn_apply`` call the ops; the CUDA
kernels count their launches in ``LAUNCHES``. The ops have no backward:
with grad mode on and an input that requires grad, their kernels raise
NotImplementedError on either device. ``fused_group_norm_act`` builds a
graph through ``GroupNormActFn``, whose forward is K1a then K1b and whose
backward recomputes the plain GroupNorm + act and takes its
vector-Jacobian product (tempo_tpu/ops/pallas_gn.py ``_fwd``/``_bwd``).
"""

from __future__ import annotations

import sys
from typing import Optional

import torch

from tempo_tpu_torch.ops import _build
from tempo_tpu_torch.ops.norms import ACTIVATIONS

ACT_CODES = {None: 0, "gelu": 1, "relu": 2, "silu": 3}
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/gn.cu's constants: threads a block, the largest C K1a folds in
# shared memory.
THREADS = 256
MAX_CHANNELS = 8192
# K1a's split of a sample: at least BLOCK_BYTES of x a block, at most
# MAX_BLOCKS blocks (one wave at 4 blocks an SM on the H100's 132 SMs). A
# sample larger than one block gets at least MIN_BLOCKS blocks where each
# still holds MIN_BLOCK_BYTES, so that a batch of small samples does not
# walk each in a few long blocks.
BLOCK_BYTES = 64 << 10
MIN_BLOCKS, MIN_BLOCK_BYTES = 16, 16 << 10
MAX_BLOCKS = 4 * 132
# Launches of each kernel, counted by its wrapper where it launches it.
LAUNCHES = {"gn_stats": 0, "gn_apply": 0, "gn_sums": 0}
_COUNTERS: dict = {}


# ----------------------------------------------------------- plain versions

def accumulation_dtype(x: torch.Tensor) -> torch.dtype:
    """fp32 for bf16, fp16 and fp32 inputs; float64 stays float64 (the
    gradient checks run the plain versions in float64)."""
    return torch.promote_types(x.dtype, torch.float32)


def gn_sums_plain(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """x [B, ..., C] -> [B, 2, G] (fp32 for bf16 and fp32 x): each group's
    sum of x, then its sum of x², over the rows x holds."""
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    cg = c // num_groups
    x32 = x.to(accumulation_dtype(x)).reshape(b, -1, c)
    sum_g = x32.sum(1).view(b, num_groups, cg).sum(-1)
    sumsq_g = x32.square().sum(1).view(b, num_groups, cg).sum(-1)
    return torch.stack([sum_g, sumsq_g], dim=1)


def stats_from_sums(sums: torch.Tensor, n: int, c: int,
                    eps: float = 1e-6) -> torch.Tensor:
    """Group sums [B, 2, G] over ``n`` elements a group (rows x C/G) -> [B,
    2, C]: each channel's group mean and rstd, by K1a's formula: var =
    max(E[x²] - E[x]², 0), rstd = rsqrt(var + eps)."""
    cg = c // sums.shape[-1]
    mean = sums[:, 0] / n
    var = torch.clamp(sums[:, 1] / n - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    return torch.stack([mean.repeat_interleave(cg, 1),
                        rstd.repeat_interleave(cg, 1)], dim=1)


def gn_stats_plain(x: torch.Tensor, num_groups: int,
                   eps: float = 1e-6) -> torch.Tensor:
    """x [B, ..., C] -> [B, 2, C] fp32: each channel's group mean and rstd."""
    b, c = x.shape[0], x.shape[-1]
    n = (x.numel() // (b * c)) * (c // num_groups)
    return stats_from_sums(gn_sums_plain(x, num_groups), n, c, eps)


def gn_apply_plain(x: torch.Tensor, stats: torch.Tensor,
                   scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                   act: Optional[str] = None) -> torch.Tensor:
    """act((x - mean) * rstd * scale + bias) in fp32, out in x's type."""
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    acc = accumulation_dtype(x)
    y = (x.to(acc) - stats[:, 0].view(shape)) * stats[:, 1].view(shape)
    if scale is not None:
        y = y * scale.to(acc)
    if bias is not None:
        y = y + bias.to(acc)
    if act is not None:
        y = ACTIVATIONS[act](y)
    return y.to(x.dtype)


# ------------------------------------------------------------ CUDA wrappers

def check_cuda_input(t: torch.Tensor, name: str) -> None:
    """Device, type and layout checks shared by the kernel wrappers."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA or CPU tensor, got {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def wants_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Whether a call would build a graph through one of ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(*tensors: Optional[torch.Tensor]) -> None:
    """A raw kernel launcher has no backward; refuse to build a graph (the
    autograd Functions call the launchers with grad mode off)."""
    if wants_grad(*tensors):
        raise NotImplementedError(
            "the raw CUDA kernel launchers have no backward: call the "
            "fused wrappers, which differentiate, or run under "
            "torch.no_grad() or torch.inference_mode()")


def recompute_vjp(plain, inputs: tuple, needs: tuple,
                  grad_out: torch.Tensor) -> list:
    """The vector-Jacobian product of ``plain(*inputs)`` at ``grad_out``,
    recomputed with grad on: one gradient per input, None where ``needs``
    says it is not wanted (or the input is None)."""
    with torch.enable_grad():
        leaves = [None if t is None else t.detach().requires_grad_(n)
                  for t, n in zip(inputs, needs)]
        out = plain(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if t is not None and n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out))
    return [next(grads) if t is not None and n else None
            for t, n in zip(leaves, needs)]


def f32_param(t: Optional[torch.Tensor], n: int, fill: float,
              like: torch.Tensor) -> torch.Tensor:
    """A [n] fp32 contiguous vector on x's device (fill when None)."""
    if t is None:
        return torch.full((n,), fill, dtype=torch.float32, device=like.device)
    if t.shape != (n,) or t.device != like.device:
        raise ValueError(f"expected a [{n}] vector on {like.device}, got "
                         f"{tuple(t.shape)} on {t.device}")
    return t.float().contiguous()


def choose_stats_split(hw: int, c: int, dtype: torch.dtype
                       ) -> tuple[int, int]:
    """K1a's split of one sample, from (HW, C, dtype) alone and never from
    B: (blocks_per_sample, rows_per_block). Block j sums rows
    [j * rows_per_block, min(HW, (j + 1) * rows_per_block))."""
    sample_bytes = hw * c * (2 if dtype == torch.bfloat16 else 4)
    want = -(-sample_bytes // BLOCK_BYTES)
    if want > 1:
        want = max(want, min(MIN_BLOCKS, -(-sample_bytes // MIN_BLOCK_BYTES)))
    want = max(1, min(MAX_BLOCKS, hw, want))
    rows = -(-hw // want)
    return -(-hw // rows), rows


def stats_vectorized(c: int, dtype: torch.dtype, ptr: int) -> bool:
    """Whether K1a loads 16-byte packs: C a whole number of packs, a block's
    pass (THREADS packs) a whole number of rows, and x 16-byte aligned.
    Otherwise the same kernel loads element by element."""
    vec = 16 // (2 if dtype == torch.bfloat16 else 4)
    return c % vec == 0 and (THREADS * vec) % c == 0 and ptr % 16 == 0


def count_launch(module: str, kernel: str) -> None:
    """Add one to ``kernel``'s count in the ``LAUNCHES`` of ``module`` as it
    stands in sys.modules now: the dispatcher keeps the kernels of the
    module's first import, and they count in the table callers read after
    a re-import."""
    sys.modules[module].LAUNCHES[kernel] += 1


def _counters(device: torch.device, stream: int, numel: int) -> torch.Tensor:
    """K1a's per-sample arrival counters for calls on ``stream``: zeroed
    once, left at zero by every call."""
    cnt = _COUNTERS.get((device, stream))
    if cnt is None or cnt.numel() < numel:
        cnt = torch.zeros(numel, dtype=torch.int32, device=device)
        _COUNTERS[(device, stream)] = cnt
    return cnt


def _launch_k1a(x: torch.Tensor, num_groups: int, out: torch.Tensor,
                eps: Optional[float]) -> torch.Tensor:
    """One launch of K1a into ``out``: mean and rstd [B, 2, C], or with
    ``eps`` None the sums mode's [B, 2, G]."""
    check_cuda_input(x, "x")
    refuse_grad(x)
    b, c = x.shape[0], x.shape[-1]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if c > MAX_CHANNELS or b > 65535:
        raise ValueError(f"K1a takes C <= {MAX_CHANNELS} and B <= 65535, got "
                         f"C {c}, B {b}")
    hw = x.numel() // (b * c)
    blocks, rows = choose_stats_split(hw, c, x.dtype)
    partial = torch.empty(b * blocks * 2 * num_groups, dtype=torch.float32,
                          device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), partial.data_ptr(),
            _counters(x.device, stream, b).data_ptr(), out.data_ptr(),
            DTYPE_CODES[x.dtype], b, hw, c, num_groups, blocks, rows,
            int(stats_vectorized(c, x.dtype, x.data_ptr())))
    if eps is None:
        _build.check(_build.library().tempo_gn_sums(*args, stream),
                     "tempo_gn_sums")
        count_launch(__name__, "gn_sums")
    else:
        _build.check(_build.library().tempo_gn_stats(*args, float(eps),
                                                     stream),
                     "tempo_gn_stats")
        count_launch(__name__, "gn_stats")
    return out


def _gn_stats_cuda(x: torch.Tensor, num_groups: int, eps: float
                   ) -> torch.Tensor:
    """tempo::gn_stats's CUDA kernel: one launch of K1a."""
    out = torch.empty((x.shape[0], 2, x.shape[-1]), dtype=torch.float32,
                      device=x.device)
    return _launch_k1a(x, num_groups, out, eps)


def _gn_sums_cuda(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """tempo::gn_sums's CUDA kernel: one launch of K1a's sums mode."""
    out = torch.empty((x.shape[0], 2, num_groups), dtype=torch.float32,
                      device=x.device)
    return _launch_k1a(x, num_groups, out, None)


def _gn_sums_cpu(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """tempo::gn_sums's CPU kernel: the plain version, refusing a graph as
    the CUDA kernel does."""
    refuse_grad(x)
    return gn_sums_plain(x, num_groups)


def _gn_sums_fake(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    return x.new_empty((x.shape[0], 2, num_groups),
                       dtype=accumulation_dtype(x))


def _gn_stats_cpu(x: torch.Tensor, num_groups: int, eps: float
                  ) -> torch.Tensor:
    """tempo::gn_stats's CPU kernel: the plain version, refusing a graph as
    the CUDA kernel does."""
    refuse_grad(x)
    return gn_stats_plain(x, num_groups, eps)


def _gn_stats_fake(x: torch.Tensor, num_groups: int, eps: float
                   ) -> torch.Tensor:
    return x.new_empty((x.shape[0], 2, x.shape[-1]),
                       dtype=accumulation_dtype(x))


def _gn_apply_cuda(x: torch.Tensor, stats: torch.Tensor,
                   scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                   act: Optional[str]) -> torch.Tensor:
    """tempo::gn_apply's CUDA kernel: one launch of K1b."""
    check_cuda_input(x, "x")
    refuse_grad(x, scale, bias)
    b, c = x.shape[0], x.shape[-1]
    hw = x.numel() // (b * c)
    if (stats.shape != (b, 2, c) or stats.dtype != torch.float32
            or stats.device != x.device or not stats.is_contiguous()):
        raise ValueError("stats must be a contiguous fp32 [B, 2, C] tensor "
                         "on x's device")
    if act not in ACT_CODES:
        raise ValueError(f"unknown activation {act!r}")
    if b > 65535:
        raise ValueError(f"K1b takes B <= 65535, got {b}")
    scale32 = f32_param(scale, c, 1.0, x)
    bias32 = f32_param(bias, c, 0.0, x)
    out = torch.empty_like(x)
    vec = 16 // x.element_size()
    vectorized = (c % vec == 0 and x.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
    lib = _build.library()
    err = lib.tempo_gn_apply(
        x.data_ptr(), stats.data_ptr(), scale32.data_ptr(),
        bias32.data_ptr(), out.data_ptr(), DTYPE_CODES[x.dtype], b, hw, c,
        ACT_CODES[act], int(vectorized),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "tempo_gn_apply")
    count_launch(__name__, "gn_apply")
    return out


def _gn_apply_cpu(x, stats, scale, bias, act):
    """tempo::gn_apply's CPU kernel: the plain version, refusing a graph as
    the CUDA kernel does."""
    refuse_grad(x, scale, bias)
    return gn_apply_plain(x, stats, scale, bias, act)


def _gn_apply_fake(x, stats, scale, bias, act):
    return torch.empty_like(x)


# ----------------------------------------------------------------- the ops

# One library fragment of the ``tempo`` namespace for the port's ops; a
# module executed again (importlib.reload) keeps the one it made.
LIBRARY = globals().get("LIBRARY") or torch.library.Library("tempo",
                                                            "FRAGMENT")


def register(name: str, schema: str, cpu, cuda, fake) -> None:
    """Define the op ``tempo::<name>`` with its CPU, CUDA and fake kernels,
    once a process: where it is defined already, nothing is registered."""
    if hasattr(torch.ops.tempo, name):
        return
    LIBRARY.define(schema)
    LIBRARY.impl(name, cpu, "CPU")
    LIBRARY.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"tempo::{name}", fake, lib=LIBRARY)


register("gn_stats", "gn_stats(Tensor x, int num_groups, float eps) -> Tensor",
         _gn_stats_cpu, _gn_stats_cuda, _gn_stats_fake)
register("gn_sums", "gn_sums(Tensor x, int num_groups) -> Tensor",
         _gn_sums_cpu, _gn_sums_cuda, _gn_sums_fake)
register("gn_apply", "gn_apply(Tensor x, Tensor stats, Tensor? scale, "
         "Tensor? bias, str? act) -> Tensor",
         _gn_apply_cpu, _gn_apply_cuda, _gn_apply_fake)


def gn_stats(x: torch.Tensor, num_groups: int, eps: float = 1e-6
             ) -> torch.Tensor:
    """K1a: x [B, ..., C] -> [B, 2, C] fp32 per-channel (mean, rstd),
    through ``tempo::gn_stats``."""
    return torch.ops.tempo.gn_stats(x, num_groups, eps)


def gn_sums(x: torch.Tensor, num_groups: int) -> torch.Tensor:
    """K1a's sums mode: x [B, ..., C] -> [B, 2, G] fp32, each group's Σx
    and Σx² over the rows x holds, through ``tempo::gn_sums``."""
    return torch.ops.tempo.gn_sums(x, num_groups)


def gn_apply(x: torch.Tensor, stats: torch.Tensor,
             scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
             act: Optional[str] = None) -> torch.Tensor:
    """K1b: act((x - mean) * rstd * scale + bias), out in x's type,
    through ``tempo::gn_apply``."""
    return torch.ops.tempo.gn_apply(x, stats, scale, bias, act)


class GroupNormActFn(torch.autograd.Function):
    """K1a then K1b forward; the backward recomputes the plain GroupNorm +
    act from the saved (x, scale, bias) and returns its vector-Jacobian
    product. On the CPU the forward is the plain version."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.config = (num_groups, eps, act)
        return gn_apply(x, gn_stats(x, num_groups, eps), scale, bias, act)

    @staticmethod
    def backward(ctx, grad_out):
        from tempo_tpu_torch.ops.norms import group_norm

        num_groups, eps, act = ctx.config

        def plain(x, scale, bias):
            return group_norm(x, num_groups, scale, bias, eps, act)

        grads = recompute_vjp(plain, ctx.saved_tensors,
                              ctx.needs_input_grad[:3], grad_out)
        return (*grads, None, None, None)


def fused_group_norm_act(x: torch.Tensor, scale: Optional[torch.Tensor],
                         bias: Optional[torch.Tensor], num_groups: int,
                         eps: float = 1e-6,
                         act: Optional[str] = "gelu") -> torch.Tensor:
    """GroupNorm + activation: K1a then K1b (plain pieces on the CPU),
    through ``GroupNormActFn`` when a graph is being built."""
    if wants_grad(x, scale, bias):
        return GroupNormActFn.apply(x, scale, bias, num_groups, eps, act)
    return gn_apply(x, gn_stats(x, num_groups, eps), scale, bias, act)
