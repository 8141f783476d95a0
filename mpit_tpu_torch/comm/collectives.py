"""Collectives over the stacked worker dim.

Counterpart of ``mpit_tpu/comm/collectives.py``. In the JAX package they
run inside ``shard_map`` and each worker gets its result back. Here the
workers of a process are stacked on dim
:data:`~mpit_tpu_torch.comm.topology.WORKER_DIM` of one tensor, so a
reduction is a reduction over that dim, and a result that every worker
holds alike comes back once, with the worker dim removed; a result that
differs per worker (``allgather``'s tiles, ``reduce_scatter``'s shards)
comes back stacked. In a world of several processes each collective
reduces the local dim first, then makes one ``torch.distributed`` call
across the processes. All functions take a tree (dict, list, tuple or
tensor), as the reference's pytree-aware collectives do.

The quantized exchange (``allreduce(quant=...)``, ``quantized_allreduce``,
``quantized_psum_scatter``) is ROADMAP.md item A6 and raises naming it.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mpit_tpu_torch.comm.topology import WORKER_DIM, current_process, in_process_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.utils.params import tree_map

# Reduction ops, mirroring mpiT.SUM/PROD/MAX/MIN (AVG is SUM / W)
SUM = "sum"
PROD = "prod"
MAX = "max"
MIN = "min"
AVG = "avg"


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to mpit_tpu_torch yet (ROADMAP.md, {item})"
    )


def _across(t: torch.Tensor, op: str) -> torch.Tensor:
    """``t`` reduced over the world's processes (itself without a process
    group)."""
    if not in_process_group():
        return t
    import torch.distributed as dist

    ops = {SUM: dist.ReduceOp.SUM, PROD: dist.ReduceOp.PRODUCT,
           MAX: dist.ReduceOp.MAX, MIN: dist.ReduceOp.MIN}
    t = t.contiguous().clone()
    dist.all_reduce(t, ops[op])
    return t


def _local_reducer(op: str):
    return {SUM: lambda a: a.sum(WORKER_DIM), PROD: lambda a: a.prod(WORKER_DIM),
            MAX: lambda a: a.amax(WORKER_DIM), MIN: lambda a: a.amin(WORKER_DIM)}[op]


def _reduce(tree: Any, op: str) -> Any:
    local = _local_reducer(op)
    return tree_map(lambda a: _across(local(a), op), tree)


def psum(tree: Any) -> Any:
    return _reduce(tree, SUM)


def pmean(tree: Any) -> Any:
    if not in_process_group():
        return tree_map(lambda a: a.mean(WORKER_DIM), tree)
    w = _current_topology().num_workers
    return tree_map(lambda s: s / w, psum(tree))


def pmax(tree: Any) -> Any:
    return _reduce(tree, MAX)


def pmin(tree: Any) -> Any:
    return _reduce(tree, MIN)


def allreduce(tree: Any, op: str = SUM, quant: Optional[str] = None) -> Any:
    """``mpiT.Allreduce`` over the workers: SUM, AVG, MAX, MIN or PROD
    (exact for any sign)."""
    if quant not in (None, "off"):
        raise _not_ported(f"allreduce(quant={quant!r})", "item A6")
    if op == AVG:
        return pmean(tree)
    if op not in (SUM, PROD, MAX, MIN):
        raise ValueError(f"unknown reduction op: {op!r}")
    return _reduce(tree, op)


def _gather(a: torch.Tensor) -> torch.Tensor:
    """The world's stacked workers: this process's W, then the others' in
    process order, on dim 0."""
    if not in_process_group():
        return a
    import torch.distributed as dist

    a = a.contiguous()
    parts = [torch.empty_like(a) for _ in range(current_process()[1])]
    dist.all_gather(parts, a)
    return torch.cat(parts, WORKER_DIM)


def allgather(tree: Any, tiled: bool = False) -> Any:
    """Every worker's leaf, stacked on a new leading dim in worker order
    (every worker holds the same, so it comes back once), or concatenated
    along dim 0 when ``tiled``."""

    def leaf(a):
        g = _gather(a)
        return g.reshape(-1, *g.shape[2:]) if tiled else g

    return tree_map(leaf, tree)


def bcast(tree: Any, root: int = 0) -> Any:
    """``mpiT.Bcast``: every worker receives worker ``root``'s value, bit
    for bit."""
    topo = _current_topology()
    if not 0 <= root < topo.num_workers:
        raise ValueError(
            f"bcast root={root} out of range for {topo.num_workers} workers"
        )
    owner, local = divmod(root, topo.local_workers)

    def leaf(a):
        x = a[local].clone()
        if in_process_group():
            import torch.distributed as dist

            dist.broadcast(x, src=owner)
        return x

    return tree_map(leaf, tree)


def reduce_scatter(tree: Any, scatter_dimension: int = 0, tiled: bool = True) -> Any:
    """Sum over the workers; worker ``i`` keeps shard ``i`` of the sum along
    ``scatter_dimension`` (of the per-worker shape), returned stacked. With
    ``tiled`` the dim is cut into W equal tiles; without, its size is W and
    it goes away, as in ``lax.psum_scatter``."""
    topo = _current_topology()
    w, mine = topo.num_workers, topo.local_slice(topo.num_workers)

    def leaf(a):
        total = psum(a)
        n = total.shape[scatter_dimension]
        if n % w if tiled else n != w:
            raise ValueError(
                f"dim {scatter_dimension} of size {n} does not split over "
                f"{w} workers"
            )
        shards = (total.chunk(w, scatter_dimension) if tiled
                  else total.unbind(scatter_dimension))
        return torch.stack(shards[mine], WORKER_DIM)

    return tree_map(leaf, tree)


def device_barrier() -> torch.Tensor:
    """A reduction of one per worker that every process must reach:
    ``mpiT.Barrier`` inside the step. Returns the world's worker count."""
    topo = _current_topology()
    ones = torch.ones(topo.local_workers, dtype=torch.int32, device=topo.device)
    return psum(ones)


def barrier(name: str = "mpit_barrier") -> None:
    """Host-level barrier across processes (``mpiT.Barrier`` outside a
    step); a no-op in one process. ``name`` labels the point, as in the
    reference."""
    del name
    if in_process_group():
        import torch.distributed as dist

        dist.barrier()


def quantized_allreduce(*args, **kwargs):
    raise _not_ported("quantized_allreduce", "item A6")


def quantized_psum_scatter(*args, **kwargs):
    raise _not_ported("quantized_psum_scatter", "item A6")


def ppermute_ring(tree: Any, shift: int = 1, axis_name: Optional[str] = None) -> Any:
    """Ring neighbour exchange over the mesh axis ``axis_name`` (default
    the worker axis): worker ``i`` on that axis sends to ``(i + shift) %
    n``, its place on the other axes kept; bit for bit, returned stacked.
    On one process that is ``torch.roll`` over the stacked dim (per axis of
    the mesh); across processes the world's stack is gathered, rolled, and
    this process keeps its own workers' slice."""
    topo = _current_topology()
    names, shape = topo.axis_names, topo.mesh_shape
    axis = names[0] if axis_name is None else axis_name
    if axis not in names:
        raise ValueError(f"unknown mesh axis {axis_name!r}; have {names}")
    dim = names.index(axis)
    mine = topo.local_slice(topo.num_workers)

    def leaf(a):
        if a.shape[WORKER_DIM] != topo.local_workers:
            raise ValueError(
                f"leaf of shape {tuple(a.shape)} does not stack this "
                f"process's {topo.local_workers} workers on dim {WORKER_DIM}"
            )
        g = _gather(a)
        g = torch.roll(g.reshape(*shape, *g.shape[1:]), shift, dims=dim)
        return g.reshape(topo.num_workers, *g.shape[len(shape):])[mine]

    return tree_map(leaf, tree)
