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
``quantized_psum_scatter``) is the reference's two-hop scheme: each worker's
flat leaf cut into W destination rows, each row quantized against its own
scale (``quant.quantize_rows_torch``), an all-to-all of the codes (on the
stacked dim a transpose of ``(W_src, W_dst, chunk)``; across processes one
``all_to_all_single``), an f32 sum of the dequantized rows in source order,
one re-quantization of each reduced chunk and an all-gather of its codes.
They take the world's W from the stacked dim and the process count, so a
trainer's own ``Topology`` needs no global one.
bf16 codes cross processes as bytes: neither gloo nor NCCL carries
``uint16``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mpit_tpu_torch import quant as _quant
from mpit_tpu_torch.comm.topology import WORKER_DIM, current_process, in_process_group
from mpit_tpu_torch.comm.topology import topology as _current_topology
from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten

# Reduction ops, mirroring mpiT.SUM/PROD/MAX/MIN (AVG is SUM / W)
SUM = "sum"
PROD = "prod"
MAX = "max"
MIN = "min"
AVG = "avg"


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
    (exact for any sign).

    ``quant="bf16"|"int8"`` runs the quantized scheme
    (:func:`quantized_allreduce`) instead: SUM/AVG only, and lossy per
    call (one rounding a hop, not fed back at this level). A caller that
    reduces one stream repeatedly holds the residuals and calls
    :func:`quantized_allreduce` itself, as ``parallel/sync.py`` does."""
    if quant not in (None, "off"):
        if op not in (SUM, AVG):
            raise ValueError(f"quantized allreduce supports SUM/AVG, not {op!r}")
        return quantized_allreduce(tree, mode=quant, mean=(op == AVG))[0]
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

    dtype = a.dtype
    a = _on_wire(a.contiguous())
    parts = [torch.empty_like(a) for _ in range(current_process()[1])]
    dist.all_gather(parts, a)
    return torch.cat(parts, WORKER_DIM).view(dtype)


def _on_wire(a: torch.Tensor) -> torch.Tensor:
    """``a`` as gloo and NCCL carry it: uint16 (bf16 codes) as its bytes."""
    return a.view(torch.int8) if a.dtype == torch.uint16 else a


def _all_to_all(a: torch.Tensor) -> torch.Tensor:
    """The reference's ``lax.all_to_all(split_axis=0, concat_axis=0)`` over
    the world's workers: ``a`` is ``(W_local, W, ...)``, row ``j`` of each
    source worker bound for worker ``j``; returns ``(W_local, W, ...)``,
    each local worker's rows from every source worker in world order."""
    if not in_process_group():
        return a.transpose(0, 1).contiguous()
    import torch.distributed as dist

    procs = current_process()[1]
    wl, tail = a.shape[0], a.shape[2:]
    # (src, dst process, dst, ...) -> (dst process, dst, src, ...)
    send = a.reshape(wl, procs, wl, *tail).permute(1, 2, 0, *range(3, a.dim() + 1))
    send = send.contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(_on_wire(recv), _on_wire(send))
    # (src process, dst, src, ...) -> (dst, src process, src, ...)
    recv = recv.permute(1, 0, 2, *range(3, a.dim() + 1))
    return recv.reshape(wl, procs * wl, *tail)


def _fold_sum(a: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over ``dim`` as a left fold in index order: the order in
    which the reference's reduction sums its rows on XLA:CPU, so the
    residuals that depend on the sum agree to the bit."""
    parts = a.unbind(dim)
    acc = parts[0]
    for part in parts[1:]:
        acc = acc + part
    return acc


def _check_mode(mode: str, what: str) -> None:
    if mode not in ("bf16", "int8"):
        raise ValueError(f"quantized {what} mode {mode!r}: expected 'bf16' or 'int8'")


def quantized_rows_encode(c: torch.Tensor, mode: str):
    """Encode phase of the quantized exchange on ``c`` (W_local, W·chunk):
    each worker's W destination rows quantized against their own scales.
    Returns ``(codes (W_local, W, chunk), scales (W_local, W, 1), sent)``,
    ``sent`` (W_local, W·chunk) what each worker sends, dequantized."""
    wl, n = c.shape
    w = wl * current_process()[1]
    codes, scales = _quant.quantize_rows_torch(c.reshape(wl * w, n // w), mode)
    sent = _quant.dequantize_rows_torch(codes, scales, mode).reshape(wl, n)
    return codes.reshape(wl, w, -1), scales.reshape(wl, w, 1), sent


def quantized_rows_hop1(codes: torch.Tensor, scales: torch.Tensor, mode: str):
    """First hop: the encoded rows all-to-all (reduce-scatter), each local
    worker receiving every worker's row bound for it (bf16 is scale-free:
    its scales stay home)."""
    return _all_to_all(codes), (_all_to_all(scales) if mode == "int8" else scales)


def quantized_rows_reduce(codes_x: torch.Tensor, scales_x: torch.Tensor, mode: str,
                          mean: bool = False, r2: Optional[torch.Tensor] = None):
    """Reduce phase: each worker's received rows summed in f32 (divided by
    W for ``mean``), ``r2`` added, and the chunk re-quantized once.
    Returns ``(codes (W_local, chunk), scales (W_local, 1), new_r2)``,
    ``new_r2`` the re-quantization error."""
    w = codes_x.shape[0] * current_process()[1]
    red = _fold_sum(_quant.dequantize_rows_torch(codes_x, scales_x, mode), 1)
    if mean:
        red = red / w
    if r2 is not None:
        red = red + r2
    rcodes, rscale = _quant.quantize_rows_torch(red, mode)
    return rcodes, rscale, red - _quant.dequantize_rows_torch(rcodes, rscale, mode)


def quantized_rows_hop2(rcodes: torch.Tensor, rscale: torch.Tensor, mode: str):
    """Second hop: every worker's re-quantized chunk all-gathered. Returns
    the world's codes and scales (None for bf16) in worker order."""
    return _gather(rcodes), (_gather(rscale) if mode == "int8" else None)


def quantized_rows_decode(g_codes: torch.Tensor, g_scales, mode: str) -> torch.Tensor:
    """The gathered chunks dequantized into the flat reduced vector."""
    return _quant.dequantize_rows_torch(g_codes, g_scales, mode).reshape(-1)


def _quantized_hop1(c: torch.Tensor, mode: str):
    """First hop of the quantized exchange on ``c`` (W_local, W·chunk):
    encode and exchange. Returns (the f32 rows each local worker received,
    (W_local, W, chunk), and what each sent, dequantized, (W_local,
    W·chunk))."""
    codes, scales, sent = quantized_rows_encode(c, mode)
    codes_x, scales_x = quantized_rows_hop1(codes, scales, mode)
    return _quant.dequantize_rows_torch(codes_x, scales_x, mode), sent


def quantized_rows_allreduce(c: torch.Tensor, mode: str, mean: bool = False,
                             r2: Optional[torch.Tensor] = None):
    """The quantized allreduce of the stacked rows ``c`` (W_local, n_pad),
    ``n_pad`` divisible by W: both hops, every worker's chunk reduced in f32
    and re-quantized once. Returns ``(reduced (n_pad,), sent (W_local,
    n_pad), new_r2 (W_local, chunk))``: what the receivers summed of each
    worker's row, dequantized (so the caller's level-1 residual is ``c -
    sent``), and the level-2 residual of each worker's owned chunk (``r2``
    compensates the re-quantization before it, as in the reference's
    ``_quant_allreduce_leaf``). The phases are the ``quantized_rows_*``
    functions above, which a traced step times one by one."""
    codes, scales, sent = quantized_rows_encode(c, mode)
    codes_x, scales_x = quantized_rows_hop1(codes, scales, mode)
    rcodes, rscale, new_r2 = quantized_rows_reduce(codes_x, scales_x, mode, mean, r2)
    out = quantized_rows_decode(*quantized_rows_hop2(rcodes, rscale, mode), mode)
    return out, sent, new_r2


def raw_rows_hop1(rows: torch.Tensor) -> torch.Tensor:
    """First hop of the raw exchange: the stacked rows (W_local, n_pad)
    all-to-all at f32 width, (W_local, W, n_pad/W)."""
    wl, n = rows.shape
    w = wl * current_process()[1]
    return _all_to_all(rows.reshape(wl, w, n // w))


def raw_rows_reduce(xch: torch.Tensor) -> torch.Tensor:
    """Reduce phase of the raw exchange: the mean of the received rows."""
    return _fold_sum(xch, 1) / (xch.shape[0] * current_process()[1])


def raw_rows_hop2(red: torch.Tensor) -> torch.Tensor:
    """Second hop of the raw exchange: the reduced chunks all-gathered
    into the flat mean."""
    return _gather(red).reshape(-1)


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


def quantized_allreduce(tree: Any, mode: str = "int8", mean: bool = False,
                        residual: Any = None, residual2: Any = None) -> tuple:
    """Quantized SUM (or mean) allreduce over the workers, with two-level
    error feedback; ``mpit_tpu/comm/collectives.py:178``.

    Leaves are stacked ``(W_local, ...)``. Returns ``(reduced, new_residual,
    new_residual2)``: the reduced tree once (every worker holds it alike;
    each leaf in its own dtype), the level-1 residuals stacked like
    ``tree`` (each worker's contribution ``c = x + residual`` less what the
    receivers summed of it) and the level-2 residuals stacked ``(W_local,
    ceil(n/W))`` per leaf (the re-quantization error of each worker's owned
    chunk, compensated into the next call). With ``None`` residuals the new
    ones are still returned."""
    _check_mode(mode, "allreduce")
    leaves = tree_leaves(tree)
    res = tree_leaves(residual) if residual is not None else [None] * len(leaves)
    res2 = tree_leaves(residual2) if residual2 is not None else [None] * len(leaves)
    out, new_res, new_res2 = [], [], []
    for x, r, r2 in zip(leaves, res, res2):
        c = x.to(torch.float32)
        if r is not None:
            c = c + r.to(torch.float32)
        wl, shape = c.shape[0], c.shape[1:]
        flat = c.reshape(wl, -1)
        n = flat.shape[1]
        flat = torch.nn.functional.pad(flat, (0, -n % (wl * current_process()[1])))
        reduced, sent, nr2 = quantized_rows_allreduce(flat, mode, mean, r2)
        out.append(reduced[:n].reshape(shape).to(x.dtype))
        new_res.append(c - sent[:, :n].reshape(c.shape))
        new_res2.append(nr2)
    return (tree_unflatten(tree, out), tree_unflatten(tree, new_res),
            tree_unflatten(tree, new_res2))


def quantized_psum_scatter(flat: torch.Tensor, mode: str = "int8") -> torch.Tensor:
    """Quantized ``psum_scatter(tiled=True)`` of the stacked flat vectors
    ``flat`` (W_local, n), ``n`` divisible by W: the first hop of
    :func:`quantized_allreduce` alone; worker ``k`` keeps the f32 sum of
    every worker's quantized chunk ``k``, returned stacked ``(W_local,
    n/W)``. Stateless (no error feedback), as the reference's ZeRO scatter
    is. ``mode="off"`` is the raw reduce-scatter."""
    if mode in (None, "off"):
        return reduce_scatter(flat)
    _check_mode(mode, "psum_scatter")
    w = flat.shape[0] * current_process()[1]
    if flat.shape[1] % w:
        raise ValueError(f"flat size {flat.shape[1]} does not split over {w} workers")
    contrib, _ = _quantized_hop1(flat.to(torch.float32), mode)
    return _fold_sum(contrib, 1)


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
