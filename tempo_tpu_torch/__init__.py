"""PyTorch/CUDA port of tempo_tpu for one NVIDIA H100.

The JAX package ``tempo_tpu`` is the reference; this package keeps its
module layout and names. It imports torch and numpy, never JAX or anything
of ``tempo_tpu``. Entry points take ``device=None``, which means CUDA, and
raise when CUDA is absent unless the caller passes ``device="cpu"``.
"""

from tempo_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
