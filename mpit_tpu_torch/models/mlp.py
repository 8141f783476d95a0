"""Small MLP classifier; counterpart of ``mpit_tpu/models/mlp.py``."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import Dense, Model


class MLP(Model):
    """Dense layers with ReLU between them. The input size is fixed at
    construction (flax infers it at ``init``); the default is MNIST's
    28 x 28 x 1."""

    def __init__(
        self,
        num_classes: int = 10,
        hidden: Sequence[int] = (128,),
        compute_dtype: torch.dtype = torch.bfloat16,
        in_shape: Sequence[int] = (28, 28, 1),
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.compute_dtype = compute_dtype
        widths = [math.prod(in_shape), *hidden, num_classes]
        for i, (fin, fout) in enumerate(zip(widths[:-1], widths[1:])):
            self.add_module(f"Dense_{i}", Dense(fin, fout, compute_dtype, device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype).reshape(x.shape[0], -1)
        layers = list(self.children())
        for layer in layers[:-1]:
            x = F.relu(layer(x))
        return layers[-1](x).float()
