"""Hand-written CUDA kernels of the port, each beside its plain version:
``elastic`` (the fused elastic update) and ``flash_attention`` (forward,
dQ and dK/dV); ``ring_attention`` (ring attention over a stacked sequence
ring, and the dense reference) and ``ulysses`` are PyTorch operations, as
the reference's are jnp; ``products`` multiplies bf16 operands into float32
(cuBLAS on the card), as the reference's ``preferred_element_type``
contractions do."""

from mpit_tpu_torch.ops.elastic import elastic_update, elastic_update_leaves  # noqa: F401
