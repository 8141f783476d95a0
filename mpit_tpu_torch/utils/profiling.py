"""Completion barrier for timed regions.

Counterpart of ``mpit_tpu/utils/profiling.py``'s :func:`force_completion`.
PyTorch returns from a CUDA call before the card has finished it, so a
host clock read without a barrier times the enqueue. The barrier is
``torch.cuda.synchronize()`` plus one host fetch of a scalar that depends
on the outputs, which proves the work ran and not only that it was queued.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.utils.params import tree_leaves


def force_completion(*results) -> float:
    """Proof of execution of every argument; returns the fetched scalar.

    For EACH positional argument the smallest floating-point leaf is
    summed; the per-argument sums are added into one scalar and fetched
    once. Pass a step's state and its metrics as separate arguments, so
    each gets its own proof leaf. Non-tensor and non-floating leaves are
    skipped."""
    total = None
    cuda = False
    for result in results:
        leaves = [
            leaf
            for leaf in tree_leaves(result)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
        ]
        if not leaves:
            continue
        small = min(leaves, key=lambda leaf: leaf.numel())
        cuda = cuda or small.is_cuda
        term = small.sum(dtype=torch.float32)
        total = term if total is None else total + term
    if cuda:
        torch.cuda.synchronize()
    return float(total) if total is not None else 0.0
