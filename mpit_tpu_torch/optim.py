"""Local optimizers and learning-rate schedules, as ``optax`` computes them.

``optax.sgd(lr, momentum)`` keeps a trace ``t ← g + μ·t`` (``t₀ = 0``) and
applies ``p ← p + (−lr)·t``. ``optax.adam``/``optax.adamw`` chain
``scale_by_adam`` (bias-corrected moments, eps outside the root),
``add_decayed_weights`` (adamw only, on every leaf) and
``scale_by_learning_rate``::

    m ← b1·m + (1−b1)·g            v ← b2·v + (1−b2)·g²       c ← c + 1
    u = m/(1−b1^c) / (√(v/(1−b2^c) + eps_root) + eps) + wd·p
    p ← p − lr(c − 1)·u

The schedule is read at the count *before* the step, so a warmup that
starts at 0 makes the first update exactly 0, weight decay included.
``torch.optim.AdamW`` is not this function: it decays the weights before
the moment step and reads its schedule elsewhere.

The functions compute the same on every leaf of a tree, stacked
``(W, ...)`` leaves included, and return new tensors, leaving their inputs
as they were. Adam runs each of its elementwise passes as one
``torch._foreach_*`` call over all leaves, so a step launches a few dozen
kernels, not a few per leaf. Schedules are evaluated on the host in
float32, as optax evaluates them. Gradient clipping (``clip_norm``) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Union

import numpy as np
import torch

from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten

Schedule = Callable[[int], float]
_F32 = np.float32


def constant_schedule(value: float) -> Schedule:
    return lambda count: float(_F32(value))


def cosine_decay_schedule(
    init_value: float, decay_steps: int, alpha: float = 0.0
) -> Schedule:
    """``optax.cosine_decay_schedule``: ``init·((1−α)·½(1+cos(π·c/T)) + α)``
    with c clipped at T."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        c = _F32(min(count, decay_steps))
        cos = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(decay_steps)))
        return float(_F32(init_value) * ((_F32(1) - _F32(alpha)) * cos + _F32(alpha)))

    return schedule


def linear_schedule(
    init_value: float, end_value: float, transition_steps: int
) -> Schedule:
    """``optax.linear_schedule`` (from count 0)."""
    if transition_steps <= 0:
        return constant_schedule(init_value)

    def schedule(count: int) -> float:
        c = _F32(min(max(count, 0), transition_steps))
        frac = _F32(1) - c / _F32(transition_steps)
        return float((_F32(init_value) - _F32(end_value)) * frac + _F32(end_value))

    return schedule


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0,
) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then cosine to ``end_value`` at
    ``decay_steps`` (which counts the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    cos = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else cos(count - warmup_steps)


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


@dataclasses.dataclass
class AdamState:
    """``count`` is the number of updates made so far (a host int, as the
    schedule is read on the host); ``mu``/``nu`` are trees like the params."""

    count: int
    mu: Any
    nu: Any


def adam_init(params: Any) -> AdamState:
    return AdamState(0, tree_map(torch.zeros_like, params),
                     tree_map(torch.zeros_like, params))


def adam_update(
    params: Any, grads: Any, state: AdamState, lr: Schedule,
    b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    eps_root: float = 0.0, weight_decay: float = 0.0,
) -> tuple[Any, AdamState]:
    """One Adam (``weight_decay`` 0) or AdamW step; returns
    ``(new_params, new_state)``."""
    p, g = tree_leaves(params), tree_leaves(grads)
    mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
    count = state.count + 1
    fe = torch
    mu = fe._foreach_add(fe._foreach_mul(g, 1 - b1), fe._foreach_mul(mu, b1))
    nu = fe._foreach_add(fe._foreach_mul(fe._foreach_mul(g, g), 1 - b2),
                         fe._foreach_mul(nu, b2))
    bc1 = float(_F32(1) - _F32(b1) ** _F32(count))
    bc2 = float(_F32(1) - _F32(b2) ** _F32(count))
    den = fe._foreach_add(
        fe._foreach_sqrt(fe._foreach_add(fe._foreach_div(nu, bc2), eps_root)), eps
    )
    upd = fe._foreach_div(fe._foreach_div(mu, bc1), den)
    if weight_decay:
        upd = fe._foreach_add(upd, fe._foreach_mul(p, weight_decay))
    new_p = fe._foreach_add(p, fe._foreach_mul(upd, -lr(state.count)))
    return tree_unflatten(params, new_p), AdamState(
        count, tree_unflatten(params, mu), tree_unflatten(params, nu)
    )


@dataclasses.dataclass(frozen=True)
class Adam:
    """``optax.adam(lr)``, or ``optax.adamw(lr, weight_decay)`` when
    ``weight_decay`` is set; ``lr`` is a float or a schedule."""

    lr: Union[float, Schedule]
    weight_decay: float = 0.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params: Any) -> AdamState:
        return adam_init(params)

    def update(self, params: Any, grads: Any, state: AdamState):
        lr = self.lr if callable(self.lr) else constant_schedule(self.lr)
        return adam_update(params, grads, state, lr, self.b1, self.b2,
                           self.eps, self.eps_root, self.weight_decay)


def AdamW(lr: Union[float, Schedule], weight_decay: float = 1e-4) -> Adam:
    """``optax.adamw(lr, weight_decay)`` with optax's defaults."""
    return Adam(lr, weight_decay=weight_decay)
