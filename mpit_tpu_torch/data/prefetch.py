"""Device-prefetching input pipeline.

Counterpart of ``mpit_tpu/data/prefetch.py``: ``prefetch_to_device`` and
:class:`DeviceBatches`. Upcoming items are staged on the device while the current step runs: each
host array is copied into pinned (page-locked) memory and sent with
``non_blocking=True``, so the copy runs on the card's copy engine, ordered
on the current stream before the step that reads it, while the host goes
on queueing work. PyTorch's pinned-memory allocator keeps each pinned
buffer until its copy has finished.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional

import torch

from mpit_tpu_torch.utils.params import tree_map


def _stage(a, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t.to(device)
    return t.contiguous().pin_memory().to(device, non_blocking=True)


def prefetch_to_device(
    it: Iterable[Any], device: torch.device, depth: int = 2
) -> Iterator[Any]:
    """Yield the items of ``it`` (trees of numpy arrays or CPU tensors) as
    tensors on ``device``, ``depth`` items ahead of the consumer;
    ``depth=0`` stages each item as it is asked for. Peak input memory on
    the device is ``depth + 1`` items."""
    if depth < 0:  # validate eagerly, not at first next()
        raise ValueError(f"depth must be >= 0, got {depth}")
    return _prefetch_gen(it, torch.device(device), depth)


def _prefetch_gen(it, device, depth) -> Iterator[Any]:
    buf: deque = deque()
    for item in it:
        buf.append(tree_map(lambda a: _stage(a, device), item))
        if len(buf) > depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


class DeviceBatches:
    """A :class:`~mpit_tpu_torch.data.Batches`-shaped epoch iterator whose
    batches arrive already on the trainer's device (``topo.device``),
    ``depth`` ahead.

    Wraps any object with ``epoch(i)`` / ``steps_per_epoch()`` (the Batches
    protocol). An optional ``transform(x, y) -> item`` reshapes each host
    batch before staging (e.g. a τ-round regrouping); by default items are
    the ``(x, y)`` pairs unchanged.
    """

    def __init__(self, batches, topo, depth: int = 2,
                 transform: Optional[Callable] = None):
        if depth < 0:
            raise ValueError(f"depth must be >= 0, got {depth}")
        self.batches = batches
        self.topo = topo
        self.depth = int(depth)
        self.transform = transform

    def steps_per_epoch(self) -> int:
        return self.batches.steps_per_epoch()

    def epoch(self, epoch_index: int) -> Iterator[Any]:
        it = self.batches.epoch(epoch_index)
        if self.transform is not None:
            it = (self.transform(x, y) for x, y in it)
        return prefetch_to_device(it, self.topo.device, depth=self.depth)
