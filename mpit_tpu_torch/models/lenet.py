"""LeNet-5-style MNIST model; counterpart of ``mpit_tpu/models/lenet.py``.

The public input is NHWC ``(N, 28, 28, 1)`` as in the reference. Inside,
the convs run NCHW (``F.conv2d``) in NCHW memory, with or without vmap, and the activations are permuted back to
NHWC before the flatten, so ``Dense_0``'s 3136 input rows are in flax's
order. Activations compute in ``compute_dtype`` (bf16 by default); the
parameters stay float32 and the logits come out float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import Conv, Dense, Model


class LeNet(Model):
    def __init__(
        self,
        num_classes: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.Conv_0 = Conv(1, 32, 5, compute_dtype, device)
        self.Conv_1 = Conv(32, 64, 5, compute_dtype, device)
        self.Dense_0 = Dense(7 * 7 * 64, 256, compute_dtype, device)
        self.Dense_1 = Dense(256, num_classes, compute_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW, copied into NCHW strides: with one channel the
        # permuted view is also channels-last, and the conv would pick its
        # channels-last algorithm here but the NCHW one under vmap (the
        # collective trainers), which rounds differently
        x = x.to(self.compute_dtype).permute(0, 3, 1, 2).clone(
            memory_format=torch.contiguous_format
        )
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flatten as NHWC
        x = F.relu(self.Dense_0(x))
        return self.Dense_1(x).float()
