"""Hand-written CUDA kernels of the port, each beside its plain version."""

from mpit_tpu_torch.ops.elastic import elastic_update  # noqa: F401
