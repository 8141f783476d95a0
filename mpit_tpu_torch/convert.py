"""Weights carried across between the flax tree and the port's tree.

The trees have the same keys. Leaves differ in one layout only:

- a conv ``kernel`` (4-D) is HWIO in flax and OIHW in the port;
- a Dense ``kernel`` is ``(in, out)`` in both (the port computes
  ``x @ kernel``), and biases, LayerNorm scales, embeddings and the
  transformer's ``pos_embedding`` are the same arrays. The transformer's
  tree has no 4-D leaf, so every leaf carries across unchanged.

Both directions go through numpy, so a test hands the JAX package's
arrays to the port and back without either package importing the other.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.utils.params import tree_map


def from_flax(params_np: Any, device=None) -> Any:
    """Flax parameter tree (numpy or array-likes) -> the port's tree of
    float tensors on ``device`` (the card unless it names the CPU)."""
    dev = resolve_device(device)

    def leaf(a):
        a = np.asarray(a)
        if a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        return torch.tensor(a, device=dev)

    return tree_map(leaf, params_np)


def to_flax(params: Any) -> Any:
    """The port's tree -> the flax layout as numpy arrays."""

    def leaf(t):
        a = t.detach().cpu().numpy()
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        return np.ascontiguousarray(a)

    return tree_map(leaf, params)
