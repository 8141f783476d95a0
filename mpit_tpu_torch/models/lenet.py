"""LeNet-5-style MNIST model; counterpart of ``mpit_tpu/models/lenet.py``.

The public input is NHWC ``(N, 28, 28, 1)`` as in the reference (another
``in_shape`` sizes the first conv and ``Dense_0``, which flax infers).
Inside, the convs run NCHW (``F.conv2d``) in NCHW memory, with or without
vmap, and the activations are permuted back to NHWC before the flatten, so
``Dense_0``'s 3136 input rows are in flax's order. Activations compute in ``compute_dtype`` (bf16 by default); the
parameters stay float32 and the logits come out float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import Conv, Dense, Model, flatten_nhwc, nchw


class LeNet(Model):
    def __init__(
        self,
        num_classes: int = 10,
        compute_dtype: torch.dtype = torch.bfloat16,
        in_shape: Sequence[int] = (28, 28, 1),
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        h, w, cin = in_shape
        self.Conv_0 = Conv(cin, 32, 5, compute_dtype, device)
        self.Conv_1 = Conv(32, 64, 5, compute_dtype, device)
        self.Dense_0 = Dense(h // 4 * (w // 4) * 64, 256, compute_dtype, device)
        self.Dense_1 = Dense(256, num_classes, compute_dtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x, self.compute_dtype)
        x = F.max_pool2d(F.relu(self.Conv_0(x)), 2, 2)
        x = F.max_pool2d(F.relu(self.Conv_1(x)), 2, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x).float()
