"""AlexNet for the ImageNet Downpour config; counterpart of
``mpit_tpu/models/alexnet.py``.

The 11×11/4 stem (padding 2, bias; ``stem="conv"`` or the same function
through space-to-depth, ``mpit_tpu_torch.ops.stem``), 3×3/2 ``"VALID"``
max-pools, a 5×5 conv with padding 2, three 3×3 convs with padding 1, each
with ReLU; the features flattened as NHWC (6·6·256 = 9,216 rows at 224²),
then Dense 4096, 4096 and ``num_classes``. No norm layer. Activations in
``compute_dtype``, float32 parameters and logits. The input size is fixed
at construction (flax infers ``Dense_0``'s rows at ``init``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    Conv, Dense, Model, flatten_nhwc, max_pool, nchw, window_out,
)
from mpit_tpu_torch.ops.stem import add_stem, reset_stem, stem_conv

# (features, kernel, padding) of the convs after the stem
_CONVS = ((192, 5, 2), (384, 3, 1), (256, 3, 1), (256, 3, 1))
_POOL_AFTER = (0, 1, 4)  # conv indices, the stem as 0, followed by a max-pool


class AlexNet(Model):
    def __init__(
        self,
        num_classes: int = 1000,
        compute_dtype: torch.dtype = torch.bfloat16,
        stem: str = "conv",
        in_shape: Sequence[int] = (224, 224, 3),
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        dt = self.compute_dtype = compute_dtype
        self.stem = stem
        h, w, cin = in_shape
        add_stem(self, cin, 64, 11, 4, 2, stem, dt, device, use_bias=True)
        self.convs = []
        size = [window_out(n, 11, 4, 2) for n in (h, w)]
        cin = 64
        for j, (features, k, pad) in enumerate(_CONVS, start=1):
            if j - 1 in _POOL_AFTER:
                size = [window_out(n, 3, 2) for n in size]
            conv = Conv(cin, features, k, dt, device, padding=pad)
            self.convs.append(f"Conv_{j - (stem != 'conv')}")
            self.add_module(self.convs[-1], conv)
            cin = features
        size = [window_out(n, 3, 2) for n in size]
        self.Dense_0 = Dense(size[0] * size[1] * cin, 4096, dt, device)
        self.Dense_1 = Dense(4096, 4096, dt, device)
        self.Dense_2 = Dense(4096, num_classes, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_stem(self, generator)
        super().reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = F.relu(stem_conv(self, nchw(x, dt), 4, 2, self.stem, dt))
        x = max_pool(x, 3, 2)
        for j, name in enumerate(self.convs, start=1):
            x = F.relu(getattr(self, name)(x))
            if j in _POOL_AFTER:
                x = max_pool(x, 3, 2)
        x = F.relu(self.Dense_0(flatten_nhwc(x)))
        x = F.relu(self.Dense_1(x))
        return self.Dense_2(x).float()
