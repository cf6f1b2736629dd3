"""analysis of the PyTorch/CUDA port (counterpart of tempo_tpu.analysis)."""
