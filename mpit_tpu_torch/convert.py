"""Weights carried across between the flax tree and the port's tree.

The trees have the same keys. Leaves differ in one layout only:

- a conv ``kernel`` (4-D) is HWIO in flax and OIHW in the port, and a
  stacked one (5-D, the W workers on dim 0 as the τ-round trainers keep
  them, or a ring of centers) is ``(W, kh, kw, I, O)`` in flax and ``(W,
  O, I, kh, kw)`` in the port: the same map behind the leading dim;
- a Dense ``kernel`` is ``(in, out)`` in both (the port computes
  ``x @ kernel``), and biases, LayerNorm scales, embeddings and the
  transformer's ``pos_embedding`` are the same arrays. The transformer's
  tree has no 4-D leaf, so every leaf carries across unchanged.

No model of either package has a 3-D leaf, so a 4-D leaf is always an
unstacked conv kernel and a 5-D one a stacked conv kernel. The optimizer
states' trees (momentum trace, Adam's moments) have the params' shapes and
carry across the same way. A decode model's cache tree carries across unchanged
(:func:`cache_from_flax`).

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

    return tree_map(lambda a: torch.tensor(leaf_from_flax(a), device=dev),
                    params_np)


def leaf_from_flax(a) -> np.ndarray:
    """One leaf, flax layout -> the port's (numpy, C-contiguous, as the
    port's own init lays a leaf out: ``torch.tensor`` keeps a view's
    strides, and a conv on other strides may sum in another order)."""
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    elif a.ndim == 5:
        a = a.transpose(0, 4, 3, 1, 2)  # W,HWIO -> W,OIHW
    return _c_order(a)


def _c_order(a: np.ndarray) -> np.ndarray:
    """``a`` in C order, 0-d staying 0-d (``np.ascontiguousarray`` makes it
    1-d)."""
    return a if a.flags.c_contiguous else a.copy(order="C")


def leaf_to_flax(t: torch.Tensor) -> np.ndarray:
    """One leaf, the port's layout -> flax's (a C-contiguous numpy copy
    on the host)."""
    a = t.detach().cpu().numpy()
    if a.ndim == 4:
        a = a.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    elif a.ndim == 5:
        a = a.transpose(0, 3, 4, 2, 1)  # W,OIHW -> W,HWIO
    return _c_order(a)


def flax_flat(t: torch.Tensor, lead: int = 0) -> torch.Tensor:
    """``t`` flattened behind its first ``lead`` dims, its elements in the
    flax layout's order (a conv kernel, 4-D behind the lead, read as HWIO):
    a flat vector that means what the reference's ``ravel_pytree`` means,
    so its chunks, blocks and checkpoint bytes are the reference's."""
    if t.dim() - lead == 4:
        t = t.permute(*range(lead), lead + 2, lead + 3, lead + 1, lead)
    return t.reshape(*t.shape[:lead], -1)


def from_flax_flat(flat: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of :func:`flax_flat` for one leaf of the port's
    ``shape``, C-contiguous."""
    if len(shape) == 4:
        o, i, kh, kw = shape
        return flat.reshape(kh, kw, i, o).permute(3, 2, 0, 1).contiguous()
    return flat.reshape(shape)


def to_flax(params: Any) -> Any:
    """The port's tree -> the flax layout as numpy arrays."""
    return tree_map(leaf_to_flax, params)


def cache_from_flax(cache_np: Any, device=None) -> Any:
    """A decode model's flax ``cache`` collection (numpy or array-likes)
    -> the port's cache tree on ``device``. Cache leaves keep their layout
    (the 4-D ``cached_key``/``cached_value`` are (B, L, H, D) in both), and
    an LSTM's ``(c, h)`` carries stay tuples."""
    dev = resolve_device(device)
    return tree_map(lambda a: _cache_leaf(np.asarray(a)).to(dev), cache_np)


def _cache_leaf(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: carry the bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.tensor(_c_order(a))


def cache_to_flax(cache: Any) -> Any:
    """The port's cache tree -> numpy arrays in flax's layout (bf16 leaves
    as float32, which holds them exactly)."""
    return tree_map(
        lambda t: (t.float() if t.dtype == torch.bfloat16 else t).detach().cpu().numpy(),
        cache)
