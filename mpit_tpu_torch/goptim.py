"""goptim — distributed optimizer math (EASGD / EAMSGD / Downpour).

Counterpart of ``mpit_tpu/goptim.py``. There, each function runs inside
``shard_map`` on one worker's params and the sum over workers is a
``psum``. Here the W workers' params are stacked on dim 0 of every leaf
(``comm.topology.WORKER_DIM``), the center is one unstacked tree, and the
sum over workers is a sum over that dim (``comm.psum``).

EASGD (Zhang, Choromanska, LeCun, NeurIPS 2015), every τ local steps, with
elastic coupling α and old center x̃_t:

    client:  x_i ← x_i − α (x_i − x̃_t)
    center:  x̃  ← x̃_t + α Σ_i (x_i − x̃_t)

Both moves read the old center. EAMSGD is EASGD with momentum in the local
optimizer.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mpit_tpu_torch.comm import pmean, psum
from mpit_tpu_torch.utils.params import tree_leaves, tree_map, tree_unflatten


def elastic_client_move(params: Any, center: Any, alpha: float) -> Any:
    """x_i ← x_i − α (x_i − x̃): pull every client toward the center."""
    return tree_map(lambda p, c: p - alpha * (p - c), params, center)


def summed_client_diffs(
    params: Any, center: Any, compress_dtype: Optional[torch.dtype] = None
) -> Any:
    """Σ_i (x_i − x̃) over the workers.

    ``compress_dtype`` (e.g. ``torch.bfloat16``) casts the diffs before the
    sum and the sum back to the param dtype after, as the reference's
    compressed exchange does. The reference sums in the narrow type across
    devices; ``Tensor.sum`` here accumulates in float32 and rounds once."""
    diffs = tree_map(lambda p, c: p - c, params, center)
    if compress_dtype is None:
        return psum(diffs)
    total = psum(tree_map(lambda d: d.to(compress_dtype), diffs))
    return tree_map(lambda t, c: t.to(c.dtype), total, center)


def elastic_center_move(
    center: Any, params: Any, alpha: float,
    compress_dtype: Optional[torch.dtype] = None,
) -> Any:
    """x̃ ← x̃ + α Σ_i (x_i − x̃): pull the center toward the clients."""
    total_diff = summed_client_diffs(params, center, compress_dtype)
    return tree_map(lambda c, d: c + alpha * d, center, total_diff)


def easgd_round(
    params: Any,
    center: Any,
    alpha: float,
    use_kernel: Optional[bool] = None,
    compress_dtype: Optional[torch.dtype] = None,
    inplace: bool = False,
) -> tuple[Any, Any]:
    """One synchronous elastic-averaging exchange; returns
    ``(params, center)``.

    ``use_kernel`` routes the elementwise moves through the fused CUDA
    kernel (``ops.elastic_update_leaves``), one launch for all the leaves:
    True requires it, False takes the plain tree moves, None takes the
    kernel for CUDA tensors. The diff sum stays plain PyTorch either way,
    as the reference's psum stays outside its kernel. ``inplace`` writes
    the moved params and center over the given ones (the same bits)."""
    if use_kernel is False:
        new_x = elastic_client_move(params, center, alpha)
        new_c = elastic_center_move(center, params, alpha, compress_dtype)
        if not inplace:
            return new_x, new_c
        with torch.no_grad():
            torch._foreach_copy_(tree_leaves(params), tree_leaves(new_x))
            torch._foreach_copy_(tree_leaves(center), tree_leaves(new_c))
        return params, center

    from mpit_tpu_torch.ops import elastic_update_leaves

    total_diff = summed_client_diffs(params, center, compress_dtype)
    # flatten/unflatten by the params' structure, so trees whose containers
    # are tuples come back intact
    new_x, new_c = elastic_update_leaves(
        tree_leaves(params), tree_leaves(center), tree_leaves(total_diff), alpha,
        use_kernel=use_kernel, inplace=inplace,
    )
    if inplace:
        return params, center
    return tree_unflatten(params, new_x), tree_unflatten(center, new_c)


def downpour_push(
    center: Any, accumulated_updates: Any, average: bool = True
) -> Any:
    """Server-side apply of the workers' pushed updates: the mean over
    workers (model averaging) or, with ``average=False``, their sum."""
    total = (pmean if average else psum)(accumulated_updates)
    return tree_map(lambda c, u: c + u, center, total)


def downpour_pull(center: Any, stale_center: Optional[Any] = None) -> Any:
    """Worker pull: the center, or a stale snapshot when emulating
    asynchrony."""
    return stale_center if stale_center is not None else center
