"""Data: MNIST (or its synthetic stand-in), batches, device prefetch."""

from mpit_tpu_torch.data.datasets import (  # noqa: F401
    Batches,
    cast_input_dtype,
    load_mnist,
    shard_for_worker,
)
from mpit_tpu_torch.data.prefetch import prefetch_to_device  # noqa: F401
from mpit_tpu_torch.data.synthetic import synthetic_image_classification  # noqa: F401
