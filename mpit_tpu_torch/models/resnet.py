"""ResNet-50 for the large-tensor collective config; counterpart of
``mpit_tpu/models/resnet.py`` (``Bottleneck`` and ``ResNet50``).

Bottleneck v1.5 (the stride in the 3×3), GroupNorm(32) in place of
BatchNorm, bias-free convs, NCHW inside an NHWC interface, activations in
``compute_dtype`` with float32 parameters and logits. The 7×7/2 stem
(padding 3) is ``stem="conv"`` or the same function through space-to-depth
(``mpit_tpu_torch.ops.stem``), then GroupNorm, ReLU and a 3×3/2 ``"SAME"``
max-pool, whose -inf pad splits (0, 1) on an even size as ``lax`` splits
it; a stride-2 ``"SAME"`` 3×3 conv does the same with zeros. The global
mean over H and W sums in float32 and returns ``compute_dtype``, as
``jnp.mean`` of a bf16 array does. ``remat`` recomputes each Bottleneck's
activations on the backward pass (``layers.rematerialized``); the
parameter names stay the same.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    Conv, Dense, GroupNorm, Model, max_pool, nchw, rematerialized, reset_children,
)
from mpit_tpu_torch.ops.stem import add_stem, reset_stem, space_to_depth_conv, stem_conv


def space_to_depth_stem(x, kernel, dt):
    """ResNet's 7×7/2 stem (padding 3) through the space-to-depth
    reformulation (:func:`mpit_tpu_torch.ops.stem.space_to_depth_conv`):
    the function of a stride-2 conv with ``kernel``, on ``x`` (B, C, H, W)
    and ``kernel`` (O, C, 7, 7), in ``dt``, as
    ``mpit_tpu/models/resnet.py``'s ``space_to_depth_stem`` computes it on
    NHWC and HWIO."""
    return space_to_depth_conv(x, kernel, stride=2, padding=3, dt=dt)


class Bottleneck(nn.Module):
    """1×1, 3×3 (stride here), 1×1 ×4 convs, each with GroupNorm; a
    projection shortcut (``Conv_3``, ``GroupNorm_3``) where the block
    changes the shape."""

    def __init__(self, cin: int, features: int, stride: int, dt, device):
        super().__init__()
        out = 4 * features
        self.Conv_0 = Conv(cin, features, 1, dt, device, use_bias=False)
        self.GroupNorm_0 = GroupNorm(features, dt, device)
        self.Conv_1 = Conv(features, features, 3, dt, device, stride=stride,
                           use_bias=False)
        self.GroupNorm_1 = GroupNorm(features, dt, device)
        self.Conv_2 = Conv(features, out, 1, dt, device, use_bias=False)
        self.GroupNorm_2 = GroupNorm(out, dt, device)
        self.project = cin != out or stride != 1
        if self.project:
            self.Conv_3 = Conv(cin, out, 1, dt, device, stride=stride, use_bias=False)
            self.GroupNorm_3 = GroupNorm(out, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = F.relu(self.GroupNorm_1(self.Conv_1(y)))
        y = self.GroupNorm_2(self.Conv_2(y))
        residual = self.GroupNorm_3(self.Conv_3(x)) if self.project else x
        return F.relu(y + residual)


class ResNet50(Model):
    def __init__(
        self,
        num_classes: int = 1000,
        stage_sizes: Sequence[int] = (3, 4, 6, 3),
        compute_dtype: torch.dtype = torch.bfloat16,
        stem: str = "conv",
        remat: bool = False,
        in_shape: Sequence[int] = (224, 224, 3),
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        dt = self.compute_dtype = compute_dtype
        self.stem = stem
        self.remat = remat
        add_stem(self, in_shape[-1], 64, 7, 2, 3, stem, dt, device)
        self.GroupNorm_0 = GroupNorm(64, dt, device)
        self.blocks = []
        cin = 64
        for stage, blocks in enumerate(stage_sizes):
            for block in range(blocks):
                features = 64 * 2**stage
                stride = 2 if stage > 0 and block == 0 else 1
                self.blocks.append(f"Bottleneck_{len(self.blocks)}")
                self.add_module(self.blocks[-1],
                                Bottleneck(cin, features, stride, dt, device))
                cin = 4 * features
        self.Dense_0 = Dense(cin, num_classes, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_stem(self, generator)
        super().reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        x = stem_conv(self, nchw(x, dt), 2, 3, self.stem, dt)
        x = max_pool(F.relu(self.GroupNorm_0(x)), 3, 2, "SAME")
        for name in self.blocks:
            block = getattr(self, name)
            x = rematerialized(block, x) if self.remat else block(x)
        x = x.float().mean((2, 3)).to(dt)
        return self.Dense_0(x).float()
