"""Data: MNIST, CIFAR-10, ImageNet-like images and PTB (or their synthetic
stand-ins), batches, device prefetch."""

from mpit_tpu_torch.data.datasets import (  # noqa: F401
    Batches,
    cast_input_dtype,
    has_real_dataset,
    load_cifar10,
    load_imagenet_like,
    load_mnist,
    load_ptb,
    shard_for_worker,
)
from mpit_tpu_torch.data.prefetch import DeviceBatches, prefetch_to_device  # noqa: F401
from mpit_tpu_torch.data.synthetic import (  # noqa: F401
    synthetic_image_classification,
    synthetic_lm_corpus,
)
