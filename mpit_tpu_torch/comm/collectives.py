"""Collectives over the stacked worker dim.

Counterpart of ``mpit_tpu/comm/collectives.py``'s ``psum``/``pmean``/
``allreduce``. In the JAX package they run inside ``shard_map`` and each
worker gets the reduced value back. Here the W workers are stacked on dim
:data:`~mpit_tpu_torch.comm.topology.WORKER_DIM` of one tensor, so the
reduction is a sum over that dim and the result — the value every worker
would hold — has the worker dim removed. All functions take a tree (dict,
list, tuple or tensor) like the reference's pytree-aware collectives.
"""

from __future__ import annotations

from typing import Any

from mpit_tpu_torch.comm.topology import WORKER_DIM
from mpit_tpu_torch.utils.params import tree_map

SUM = "sum"
AVG = "avg"


def psum(tree: Any) -> Any:
    return tree_map(lambda a: a.sum(WORKER_DIM), tree)


def pmean(tree: Any) -> Any:
    return tree_map(lambda a: a.mean(WORKER_DIM), tree)


def allreduce(tree: Any, op: str = SUM) -> Any:
    """``mpiT.Allreduce`` over the workers: SUM or AVG. MAX/MIN/PROD and
    the quantized exchange are not ported yet."""
    if op == SUM:
        return psum(tree)
    if op == AVG:
        return pmean(tree)
    raise ValueError(f"unknown or unported reduction op: {op!r}; have sum, avg")
