"""Local optimizer: SGD with momentum exactly as ``optax.sgd`` does it.

``optax.sgd(lr, momentum)`` keeps a trace ``t ← g + μ·t`` (``t₀ = 0``) and
applies ``p ← p + (−lr)·t``. The functions below compute the same on every
leaf of a tree, stacked ``(W, ...)`` leaves included: the update is
elementwise, so W workers update in one tensor op per leaf. They return
new tensors and leave their inputs as they were.

Adam, AdamW and the learning-rate schedules are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from mpit_tpu_torch.utils.params import tree_map


def sgd_init(params: Any) -> Any:
    """The zero momentum trace (``optax.trace``'s initial state)."""
    return tree_map(torch.zeros_like, params)


def sgd_update(
    params: Any, grads: Any, trace: Any, lr: float, momentum: float
) -> tuple[Any, Any]:
    """One step; returns ``(new_params, new_trace)``."""
    trace = tree_map(lambda g, t: g + momentum * t, grads, trace)
    params = tree_map(lambda p, t: p + (-lr) * t, params, trace)
    return params, trace


@dataclasses.dataclass(frozen=True)
class SGD:
    """The optimizer a trainer is given: its hyperparameters and the two
    functions above bound to them."""

    lr: float
    momentum: float = 0.0

    def init(self, params: Any) -> Any:
        return sgd_init(params)

    def update(self, params: Any, grads: Any, trace: Any) -> tuple[Any, Any]:
        return sgd_update(params, grads, trace, self.lr, self.momentum)
