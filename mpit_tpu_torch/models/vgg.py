"""VGG-small for CIFAR-10; counterpart of ``mpit_tpu/models/vgg.py``.

Three blocks of widths (64, 128, 256), each two bias-free 3×3 ``"SAME"``
convs with GroupNorm(32) and ReLU, then a 2×2/2 max-pool; the features
flattened as NHWC (so ``Dense_0``'s rows are in flax's order), Dense 512,
ReLU, Dense 10. Activations in ``compute_dtype`` (bf16 by default), float32
parameters and logits. The public input is NHWC; the convs run NCHW.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    Conv, Dense, GroupNorm, Model, flatten_nhwc, max_pool, nchw,
)


class VGGSmall(Model):
    def __init__(
        self,
        num_classes: int = 10,
        widths: Sequence[int] = (64, 128, 256),
        convs_per_block: int = 2,
        compute_dtype: torch.dtype = torch.bfloat16,
        in_shape: Sequence[int] = (32, 32, 3),
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        dt = self.compute_dtype = compute_dtype
        self.convs_per_block = convs_per_block
        self.num_convs = len(widths) * convs_per_block
        h, w, cin = in_shape
        i = 0
        for width in widths:
            for _ in range(convs_per_block):
                self.add_module(f"Conv_{i}", Conv(cin, width, 3, dt, device,
                                                  use_bias=False))
                self.add_module(f"GroupNorm_{i}", GroupNorm(width, dt, device))
                cin, i = width, i + 1
            h, w = h // 2, w // 2
        self.Dense_0 = Dense(h * w * cin, 512, dt, device)
        self.Dense_1 = Dense(512, num_classes, dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = nchw(x, self.compute_dtype)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"GroupNorm_{i}")(getattr(self, f"Conv_{i}")(x)))
            if (i + 1) % self.convs_per_block == 0:
                x = max_pool(x, 2, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(x).float()
