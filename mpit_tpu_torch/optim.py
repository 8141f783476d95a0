"""Local optimizers, gradient clipping and learning-rate schedules, as
``optax`` computes them, with optax's state layout.

An optimizer is a chain of transforms, each with the state optax keeps for
it, so a checkpoint of the state (``utils/checkpoint.py``) has the layout
``flax.serialization.to_state_dict`` gives the reference's:

- ``sgd(lr, momentum)`` = ``trace(momentum)`` (none when momentum is None),
  then ``scale_by_learning_rate(lr)``: ``t ← g + μ·t``, ``u = −lr·t``;
- ``adam(lr)`` = ``scale_by_adam``, then ``scale_by_learning_rate``;
  ``adamw`` puts ``add_decayed_weights`` (on every leaf) between them::

      m ← b1·m + (1−b1)·g            v ← b2·v + (1−b2)·g²       c ← c + 1
      u = m/(1−b1^c) / (√(v/(1−b2^c) + eps_root) + eps) + wd·p

- ``chain(clip_by_global_norm(max_norm), opt)`` scales the gradient first:
  ``t if ‖g‖ < max_norm else (t / ‖g‖) · max_norm``, ``‖g‖`` the square
  root of the sum of squares over all leaves;
- ``p ← p + u``.

``scale_by_learning_rate`` with a schedule keeps a ``count`` and reads the
schedule at the count *before* the step, so a warmup that starts at 0
makes the first update exactly 0, weight decay included. Counts are host
ints, as the schedule and Adam's bias corrections are evaluated on the
host in float32, as optax evaluates them; the moments are multiplied by
the corrections' float32 reciprocals, which is how PyTorch divides by a
host float on the card. A captured step (a CUDA graph,
``parallel/capture.py``) cannot read them there: it passes
``update(..., scalars=...)``, 0-dim float32 device tensors holding the
values :meth:`Chain.host_scalars` gives for the step (the same float32
bits), and advances the counts afterwards with :meth:`Chain.advance`. ``torch.optim.AdamW`` is not
this function: it decays the weights before the moment step.

The functions compute the same on every leaf of a tree, stacked ``(W,
...)`` leaves included, and return new tensors, leaving their inputs as
they were; ``update(..., inplace=True)`` writes the new params and state
into the given ones instead (the trainers' ``donate_state``), with the
same operations in the same order, so the bits are the same. In place,
a transform may also write over the gradient tensors it is handed (the
step's own temporaries) and hand its update on in them. ``update(..., per_worker=True)`` says that dim 0 of every leaf
indexes workers, as the τ-round trainers stack them: each worker's state
and update stay its own (the reference's vmapped worker optimizer), and
the clip's norm is taken per worker, over that worker's leaves only. The
elementwise passes run as ``torch._foreach_*`` calls over all leaves, so
a step launches a few dozen kernels, not a few per leaf; the norm's sums
of squares are one ``_foreach_norm`` pass.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Union

import numpy as np
import torch

from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten

Schedule = Callable[[int], float]
_F32 = np.float32
fe = torch


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


# ---------------------------------------------------------------- states
# optax's state classes, field for field: a checkpoint writes them as
# flax writes optax's (a dataclass as the dict of its fields, a chain's
# tuple as {"0": ..., "1": ...}, a count as an int32 array).


@dataclasses.dataclass(frozen=True)
class EmptyState:
    """``optax.EmptyState``: a transform without state."""


@dataclasses.dataclass(frozen=True)
class TraceState:
    """``optax.TraceState``: the momentum trace, a tree like the params."""

    trace: Any


@dataclasses.dataclass(frozen=True)
class ScaleByScheduleState:
    """``optax.ScaleByScheduleState``: updates made so far."""

    count: int


@dataclasses.dataclass(frozen=True)
class ScaleByAdamState:
    """``optax.ScaleByAdamState``: ``count`` updates made so far;
    ``mu``/``nu`` trees like the params."""

    count: int
    mu: Any
    nu: Any


# ------------------------------------------------------------ transforms
# Each works on the leaf lists of the gradient (``u``) and the params
# (``p``) and returns (new u, new state). ``scalars``, when given, is an
# iterator of 0-dim device tensors from which a transform takes, in
# order, the values its ``host_scalars`` lists, instead of computing them
# on the host.


class Transform:
    """The default of every transform: no value read on the host."""

    def host_scalars(self, state, ahead: int = 0) -> list:
        """The float32 values :meth:`transform` reads on the host at
        ``state`` advanced by ``ahead`` updates, in the order it takes
        them from ``scalars``."""
        return []


def _zeros(params: Any) -> Any:
    return tree_map(torch.zeros_like, params)


@dataclasses.dataclass(frozen=True)
class ClipByGlobalNorm(Transform):
    """``optax.clip_by_global_norm(max_norm)``."""

    max_norm: float

    def init(self, params):
        return EmptyState()

    def transform(self, u, state, p, per_worker, inplace=False, scalars=None):
        if not u:
            return u, state
        if per_worker:
            w = u[0].shape[0]
            norms = fe._foreach_norm([g[i] for g in u for i in range(w)])
            norm = torch.stack(norms).reshape(len(u), w).square().sum(0).sqrt()
        else:
            norm = torch.stack(fe._foreach_norm(u)).square().sum().sqrt()
        clip = norm >= self.max_norm
        # t / 1 * 1 is t exactly; else (t / norm) * max_norm, optax's order
        den = torch.where(clip, norm, torch.ones_like(norm))
        mul = torch.where(clip, torch.full_like(norm, self.max_norm),
                          torch.ones_like(norm))
        if per_worker:
            den = [den.view(-1, *[1] * (g.dim() - 1)) for g in u]
            mul = [mul.view(-1, *[1] * (g.dim() - 1)) for g in u]
        if inplace:
            fe._foreach_div_(u, den)
            fe._foreach_mul_(u, mul)
            return u, state
        return fe._foreach_mul(fe._foreach_div(u, den), mul), state


@dataclasses.dataclass(frozen=True)
class Trace(Transform):
    """``optax.trace(decay)``: ``t ← g + decay·t``; the update is ``t``."""

    decay: float

    def init(self, params):
        return TraceState(_zeros(params))

    def transform(self, u, state, p, per_worker, inplace=False, scalars=None):
        t = tree_leaves(state.trace)
        if inplace:
            # t·decay + g is g + t·decay: one rounding each, as below
            fe._foreach_mul_(t, self.decay)
            fe._foreach_add_(t, u)
            fe._foreach_copy_(u, t)
            return u, TraceState(state.trace)
        t = fe._foreach_add(u, fe._foreach_mul(t, self.decay))
        return t, TraceState(tree_unflatten(state.trace, t))


@dataclasses.dataclass(frozen=True)
class ScaleByAdam(Transform):
    """``optax.scale_by_adam``."""

    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    eps_root: float = 0.0

    def init(self, params):
        return ScaleByAdamState(0, _zeros(params), _zeros(params))

    def host_scalars(self, state, ahead: int = 0) -> list:
        """The float32 reciprocals of the bias corrections ``1 − b1^c``
        and ``1 − b2^c`` of the update that makes the count ``c``. The
        moments are multiplied by them: that is how PyTorch divides a
        tensor by a host float on the card (the CPU divides), so the card
        computes what it did when the update divided by the correction,
        and a reciprocal read from a 0-dim device tensor gives the same
        bits on either device."""
        count = _F32(state.count + ahead + 1)
        return [_F32(1) / (_F32(1) - _F32(b) ** count) for b in (self.b1, self.b2)]

    def _corrections(self, state, scalars):
        if scalars is not None:
            return next(scalars), next(scalars)
        return tuple(map(float, self.host_scalars(state)))

    def transform(self, u, state, p, per_worker, inplace=False, scalars=None):
        if inplace:
            return self._transform_(u, state, scalars)
        b1, b2 = self.b1, self.b2
        mu = fe._foreach_add(fe._foreach_mul(u, 1 - b1),
                             fe._foreach_mul(tree_leaves(state.mu), b1))
        nu = fe._foreach_add(fe._foreach_mul(fe._foreach_mul(u, u), 1 - b2),
                             fe._foreach_mul(tree_leaves(state.nu), b2))
        count = state.count + 1
        inv1, inv2 = self._corrections(state, scalars)
        den = fe._foreach_add(fe._foreach_sqrt(
            fe._foreach_add(fe._foreach_mul(nu, inv2), self.eps_root)), self.eps)
        out = fe._foreach_div(fe._foreach_mul(mu, inv1), den)
        return out, ScaleByAdamState(count, tree_unflatten(state.mu, mu),
                                     tree_unflatten(state.nu, nu))

    def _transform_(self, u, state, scalars=None):
        """:meth:`transform` into ``state``'s moments (``u`` is scratch),
        with the same operations in the same order."""
        b1, b2 = self.b1, self.b2
        mu, nu = tree_leaves(state.mu), tree_leaves(state.nu)
        sq = fe._foreach_mul(u, u)
        fe._foreach_mul_(sq, 1 - b2)
        fe._foreach_mul_(nu, b2)
        fe._foreach_add_(nu, sq)
        del sq
        fe._foreach_mul_(u, 1 - b1)
        fe._foreach_mul_(mu, b1)
        fe._foreach_add_(mu, u)
        count = state.count + 1
        inv1, inv2 = self._corrections(state, scalars)
        den = fe._foreach_mul(nu, inv2)
        fe._foreach_add_(den, self.eps_root)
        fe._foreach_sqrt_(den)
        fe._foreach_add_(den, self.eps)
        out = fe._foreach_mul(mu, inv1)
        fe._foreach_div_(out, den)
        return out, ScaleByAdamState(count, state.mu, state.nu)


@dataclasses.dataclass(frozen=True)
class AddDecayedWeights(Transform):
    """``optax.add_decayed_weights(weight_decay)``: ``u + wd·p``."""

    weight_decay: float

    def init(self, params):
        return EmptyState()

    def transform(self, u, state, p, per_worker, inplace=False, scalars=None):
        if inplace:
            fe._foreach_add_(u, fe._foreach_mul(p, self.weight_decay))
            return u, state
        return fe._foreach_add(u, fe._foreach_mul(p, self.weight_decay)), state


@dataclasses.dataclass(frozen=True)
class ScaleByLearningRate(Transform):
    """``optax.scale_by_learning_rate(lr)``: ``u·(−lr)``; a schedule is
    read at the count before the step and keeps that count."""

    lr: Union[float, Schedule]

    def init(self, params):
        return ScaleByScheduleState(0) if callable(self.lr) else EmptyState()

    def host_scalars(self, state, ahead: int = 0) -> list:
        """``−lr`` at the count the update reads, for a schedule (a
        constant needs none)."""
        return [-_F32(self.lr(state.count + ahead))] if callable(self.lr) else []

    def transform(self, u, state, p, per_worker, inplace=False, scalars=None):
        if not callable(self.lr):
            neg = -self.lr
        else:
            neg = next(scalars) if scalars is not None else -self.lr(state.count)
            state = ScaleByScheduleState(state.count + 1)
        if inplace:
            fe._foreach_mul_(u, neg)
            return u, state
        return fe._foreach_mul(u, neg), state


class Chain:
    """``optax.chain(*transforms)``: the state is the tuple of theirs.

    ``init(params)`` builds the state; ``update(params, grads, state,
    per_worker=False, inplace=False, scalars=None)`` returns
    ``(new_params, new_state)``: new tensors, or with ``inplace`` the given
    params and state tensors written over (and the gradient tensors used
    as scratch), under ``torch.no_grad()``. ``scalars`` are 0-dim device
    tensors holding :meth:`host_scalars` of ``state``, read in their
    place; :meth:`advance` moves the counts as that many updates do."""

    def __init__(self, *transforms):
        self.transforms = tuple(transforms)

    def __repr__(self) -> str:
        return f"Chain{self.transforms!r}"

    def init(self, params: Any) -> tuple:
        return tuple(t.init(params) for t in self.transforms)

    def host_scalars(self, state: tuple, ahead: int = 0) -> list:
        return [v for t, s in zip(self.transforms, state, strict=True)
                for v in t.host_scalars(s, ahead)]

    def advance(self, state: tuple, n: int) -> tuple:
        """``state`` with every count moved on by ``n`` updates; the
        tensors are the same objects."""
        return _advance(state, n)

    def transform(self, u, state, p, per_worker, inplace=False, scalars=None):
        new = []
        for t, s in zip(self.transforms, state, strict=True):
            u, s = t.transform(u, s, p, per_worker, inplace, scalars)
            new.append(s)
        return u, tuple(new)

    def update(self, params: Any, grads: Any, state: tuple,
               per_worker: bool = False, inplace: bool = False,
               scalars=None) -> tuple[Any, tuple]:
        p = tree_leaves(params)
        it = None if scalars is None else iter(scalars)
        if not inplace:
            u, state = self.transform(tree_leaves(grads), state, p, per_worker,
                                      scalars=it)
            return tree_unflatten(params, fe._foreach_add(p, u)), state
        with torch.no_grad():
            u, state = self.transform(tree_leaves(grads), state, p, per_worker, True, it)
            fe._foreach_add_(p, u)
        return params, state


def _advance(state, n: int):
    if isinstance(state, tuple):
        return tuple(_advance(s, n) for s in state)
    if isinstance(state, (ScaleByAdamState, ScaleByScheduleState)):
        return dataclasses.replace(state, count=state.count + n)
    return state


def chain(*transforms) -> Chain:
    return Chain(*transforms)


def clip_by_global_norm(max_norm: float) -> ClipByGlobalNorm:
    return ClipByGlobalNorm(float(max_norm))


def SGD(lr: Union[float, Schedule], momentum: Optional[float] = None) -> Chain:
    """``optax.sgd(lr, momentum)``: no trace when ``momentum`` is None, a
    trace for any float (0.0 included), as optax builds it."""
    scale = ScaleByLearningRate(lr)
    if momentum is None:
        return Chain(scale)
    return Chain(Trace(float(momentum)), scale)


def Adam(lr: Union[float, Schedule], weight_decay: Optional[float] = None,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         eps_root: float = 0.0) -> Chain:
    """``optax.adam(lr)``, or ``optax.adamw(lr, weight_decay)`` when
    ``weight_decay`` is given; ``lr`` is a float or a schedule."""
    adam = ScaleByAdam(b1, b2, eps, eps_root)
    if weight_decay is None:
        return Chain(adam, ScaleByLearningRate(lr))
    return Chain(adam, AddDecayedWeights(float(weight_decay)),
                 ScaleByLearningRate(lr))


def AdamW(lr: Union[float, Schedule], weight_decay: float = 1e-4) -> Chain:
    """``optax.adamw(lr, weight_decay)`` with optax's defaults."""
    return Adam(lr, weight_decay=weight_decay)
