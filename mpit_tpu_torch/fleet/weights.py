# mpit-analysis: protocol-role[serving_router->serving_replica]
"""Live weight streaming into serving replicas (router side); the port's
counterpart of ``mpit_tpu/fleet/weights.py``.

Reuses the PS fetch *shapes* — named ndarray/QuantArray leaves with a
version counter — without the PS machinery: serving is read-only, so
there is no error feedback, no push path, and a missed refresh costs
staleness, not correctness. The publisher answers replica
``WEIGHT_SUB`` subscriptions (and explicit rolling pushes) with one
``WEIGHT_PUSH`` carrying ``(version, names, arrays)``; quantization
(``bf16``/``int8`` per :mod:`mpit_tpu_torch.quant`) amortizes refresh
bytes exactly like the quantized PARAM fetch does for training pulls.

A params tree is the port's nested dict of tensors. Its leaves go in the
order jax flattens the same tree (dict keys sorted, depth first) and are
named as ``jax.tree_util.keystr`` names them
(``['Block_0']['Dense_0']['kernel']``), so a push from either package
installs into the other's replicas. The replica rebuilds against its OWN
tree (same architecture by construction) and cross-checks the names, so a
publisher/replica model mismatch fails loudly instead of silently
scattering weights.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mpit_tpu_torch.fleet.replica import TAG_WEIGHT_PUSH
from mpit_tpu_torch.quant import QUANT_MODES, QuantArray, dequantize, quantize


def _leaves_with_names(tree, prefix: str = ""):
    """``[(name, leaf), ...]`` in jax's flatten order (sorted dict keys),
    each name the leaf's ``keystr`` path."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for key in sorted(tree):
        out += _leaves_with_names(tree[key], f"{prefix}[{key!r}]")
    return out


def _host(leaf) -> np.ndarray:
    """A tensor leaf as a host ndarray (bfloat16, which numpy lacks, as
    float32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def flatten_named(params) -> tuple:
    """``(names, arrays)`` — one host ndarray per leaf of the params tree,
    in jax's leaf order, named by their ``keystr`` paths."""
    leaves = _leaves_with_names(params)
    return [name for name, _ in leaves], [_host(leaf) for _, leaf in leaves]


def unflatten_like(template, names, arrays):
    """Rebuild a params tree with ``template``'s structure from a
    ``(names, arrays)`` pair, dequantizing any QuantArray leaves; each
    leaf lands on its template leaf's device."""
    want = _leaves_with_names(template)
    if list(names) != [name for name, _ in want]:
        diff = next(
            ((a, b) for a, b in zip(names, (n for n, _ in want)) if a != b),
            (len(names), len(want)),
        )
        raise ValueError(
            "weight push names do not match this replica's model "
            f"(first difference: {diff})"
        )
    leaves = iter(
        torch.from_numpy(np.array(
            dequantize(a) if isinstance(a, QuantArray) else a
        )).to(ref.device)
        for a, (_, ref) in zip(arrays, want)
    )

    def rebuild(tree):
        if not isinstance(tree, dict):
            return next(leaves)
        return {key: rebuild(tree[key]) for key in sorted(tree)}

    return rebuild(template)


class StaticWeightSource:
    """A versioned in-memory weight source (checkpoint stand-in).

    ``version`` starts at 1 so a fresh replica (construction-time
    weights = version 0) always has something to pull; :meth:`bump`
    installs new params under the next version — what rolls a refresh
    out in tests and soaks. A PServer-backed source is the same
    two-method surface (``version``/``current``) over the versioned
    PARAM fetch."""

    def __init__(self, params, version: int = 1):
        if version < 1:
            raise ValueError("version must be >= 1")
        self._params = params
        self.version = int(version)

    def current(self) -> tuple:
        return self.version, self._params

    def bump(self, params) -> int:
        self._params = params
        self.version += 1
        return self.version


class WeightPublisher:
    """Serve versioned weights to replicas over the router's transport.

    ``quant``: ``off``/``bf16``/``int8`` — the wire precision of pushed
    leaves (error feedback deliberately absent: each push is a fresh
    quantization of the source truth, so refresh error never
    accumulates across versions)."""

    def __init__(self, transport, source, quant: str = "off"):
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}")
        self.transport = transport
        self.source = source
        self.quant = quant
        #: rank -> last version pushed (audit surface for the harness)
        self.pushed: dict[int, int] = {}

    def _encode(self, params) -> tuple:
        names, arrays = flatten_named(params)
        if self.quant != "off":
            arrays = [
                # Each push is a fresh full snapshot, not an accumulating
                # stream — residual state would correct nothing.
                # mpit-analysis: ef-off[serving push is a fresh snapshot]
                quantize(np.asarray(a, np.float32), self.quant)
                for a in arrays
            ]
        return names, arrays

    def publish_to(self, rank: int) -> int:
        """Push the current source version to one replica; returns the
        version pushed."""
        version, params = self.source.current()
        names, arrays = self._encode(params)
        self.transport.send(
            rank, TAG_WEIGHT_PUSH, (int(version), names, arrays)
        )
        self.pushed[rank] = int(version)
        return int(version)

    def on_sub(self, rank: int, have_version: int) -> Optional[int]:
        """Answer one WEIGHT_SUB: push iff the source is newer than what
        the replica reports serving. Returns the pushed version or
        None."""
        if int(have_version) >= self.source.version:
            return None
        return self.publish_to(rank)

    def push_all(self, ranks) -> dict:
        """Rolling refresh: push the current version to every rank, one
        at a time (the one-at-a-time order is what keeps a fleet serving
        through a refresh — at most one replica pays install latency at
        any moment)."""
        return {r: self.publish_to(r) for r in ranks}
