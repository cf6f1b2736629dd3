"""Config, directory and environment helpers of the port (copies of
tempo_tpu.utils' numpy-free modules)."""
