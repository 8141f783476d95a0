"""Flax-shaped layers and the functional model interface.

Each layer holds the leaves of its ``flax.linen`` counterpart under the same
names (``Conv``/``Dense``: ``kernel``, ``bias``; ``LayerNorm``: ``scale``,
``bias``; ``Embed``: ``embedding``), so a model's parameters form the flax
tree (``{"Conv_0": {"bias", "kernel"}, ...}``, nested as deep as the model
nests its layers). Layouts:

- ``Conv.kernel`` is OIHW, PyTorch's own, for ``F.conv2d``; flax keeps HWIO.
- ``Dense.kernel`` is ``(in, out)``, flax's own, and the layer computes
  ``x @ kernel``. So a Dense leaf is the same array in both packages.

``mpit_tpu_torch.convert`` maps the two trees. Initialisation mirrors
flax's defaults, drawn on the CPU from a ``torch.Generator``: lecun-normal
kernels (truncated at two standard deviations), zero biases, unit norm
scales, and embeddings normal with variance 1 / features.
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
    """``nn.Dense(features, use_bias)``: ``x @ kernel (+ bias)`` with
    kernel (in, out)."""

    def __init__(self, fin: int, fout: int, dtype, device, use_bias: bool = True):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(fin, fout, device=device))
        self.bias = (nn.Parameter(torch.zeros(fout, device=device))
                     if use_bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        lecun_normal_(self.kernel, self.kernel.shape[0], generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        y = x @ self.kernel.to(self.dtype)
        return y if self.bias is None else y + self.bias.to(self.dtype)


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=dtype)`` over the last dim: epsilon 1e-6 (torch's
    default is 1e-5), mean and the fast variance ``E[x²] − E[x]²`` (clipped
    at 0) in float32, the affine map in float32, the result in ``dtype``."""

    def __init__(self, features: int, dtype, device, epsilon: float = 1e-6):
        super().__init__()
        self.dtype = dtype
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        x = x.float()
        mu = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mu) * mul + self.bias).to(self.dtype)


class Embed(nn.Module):
    """``nn.Embed(num, features, dtype=dtype)``: rows of ``embedding``
    (num, features), gathered and returned in ``dtype``."""

    def __init__(self, num: int, features: int, dtype, device):
        super().__init__()
        self.dtype = dtype
        self.embedding = nn.Parameter(torch.zeros(num, features, device=device))

    def reset_parameters(self, generator: torch.Generator) -> None:
        # variance_scaling(1, "fan_in", "normal", out_axis=0): fan_in = features
        draw = torch.randn(self.embedding.shape, generator=generator)
        with torch.no_grad():
            self.embedding.copy_(draw / math.sqrt(self.embedding.shape[1]))

    def forward(self, tokens):
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)


def reset_children(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise each child layer in registration order."""
    for layer in module.children():
        layer.reset_parameters(generator)


def params_tree(module: nn.Module) -> dict:
    """The module's parameters as the nested flax-keyed tree (copies)."""
    tree: dict = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = p.detach().clone()
    return tree


def _flat_names(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_names(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


class Model(nn.Module):
    """A model whose parameters also travel as a flax-keyed tree.

    ``init(generator)`` draws fresh parameters and returns them as the tree
    (flax's ``model.init(rng)["params"]``); ``apply(params, x)`` runs the
    forward pass on a given tree (flax's ``model.apply``), which is what
    the trainers ``vmap`` over the stacked workers."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def init(self, generator: torch.Generator) -> dict:
        self.reset_parameters(generator)
        return params_tree(self)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """Forward pass on ``params``, a flax-keyed tree of any depth."""
        return torch.func.functional_call(self, dict(_flat_names(params)), (x,))
