"""Hand-written CUDA kernels of the port, each beside its plain version:
``elastic`` (the fused elastic update) and ``flash_attention`` (forward,
dQ and dK/dV); ``ring_attention`` holds the dense reference."""

from mpit_tpu_torch.ops.elastic import elastic_update, elastic_update_leaves  # noqa: F401
