"""Flax-shaped layers and the functional model interface.

Each layer holds ``kernel`` and ``bias`` like ``flax.linen``'s ``Conv`` and
``Dense``, so a model's parameters form the flax tree
(``{"Conv_0": {"bias", "kernel"}, ...}``). Layouts:

- ``Conv.kernel`` is OIHW, PyTorch's own, for ``F.conv2d``; flax keeps HWIO.
- ``Dense.kernel`` is ``(in, out)``, flax's own, and the layer computes
  ``x @ kernel``. So a Dense leaf is the same array in both packages.

``mpit_tpu_torch.convert`` maps the two trees. Initialisation mirrors
flax's defaults: lecun-normal kernels (truncated at two standard
deviations) and zero biases, drawn on the CPU from a ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

# flax's variance_scaling "truncated_normal": the stddev of a unit normal
# truncated to [-2, 2], divided out so the kernel's variance is 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    draw = torch.empty(t.shape, dtype=torch.float32)
    nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.copy_(draw * (math.sqrt(1.0 / fan_in) / _TRUNC_STD))


class Conv(nn.Module):
    """``nn.Conv(features, (k, k), padding="SAME")`` on NCHW, stride 1."""

    def __init__(self, cin: int, cout: int, k: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, math.prod(self.kernel.shape[1:]), generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        k = self.kernel.shape[-1]
        return F.conv2d(
            x, self.kernel.to(self.dtype), self.bias.to(self.dtype),
            padding=k // 2,
        )


class Dense(nn.Module):
    """``nn.Dense(features)``: ``x @ kernel + bias`` with kernel (in, out)."""

    def __init__(self, fin: int, fout: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(fin, fout, device=device))
        self.bias = nn.Parameter(torch.zeros(fout, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        return x @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)


class Model(nn.Module):
    """A model whose parameters also travel as a flax-keyed tree.

    ``init(generator)`` draws fresh parameters and returns them as the tree
    (flax's ``model.init(rng)["params"]``); ``apply(params, x)`` runs the
    forward pass on a given tree (flax's ``model.apply``), which is what
    the trainers ``vmap`` over the stacked workers."""

    def init(self, generator: torch.Generator) -> dict:
        for layer in self.children():
            layer.reset_parameters(generator)
        return {
            name: {k: p.detach().clone() for k, p in layer.named_parameters()}
            for name, layer in self.named_children()
        }

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        flat = {
            f"{layer}.{k}": v for layer, leaves in params.items()
            for k, v in leaves.items()
        }
        return torch.func.functional_call(self, flat, (x,))
