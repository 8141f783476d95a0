"""Mixture-of-experts FFN with expert parallelism (GShard dispatch);
counterpart of ``mpit_tpu/ops/moe.py``.

The reference runs :func:`moe_ffn` inside ``shard_map``: each device holds
``E/ep`` experts and its own block of tokens, and tokens travel to their
expert's device and back with ``lax.all_to_all``. The port stacks the
workers on dim 0 (``comm/topology.py``): ``h`` is ``(W, b, t, D)``, worker
``w``'s block at row ``w``, and the expert leaves hold this process's
workers' experts in worker order (worker ``w`` owns experts ``[w·E/ep,
(w+1)·E/ep)``). Each worker routes its OWN tokens, batched over W:
capacity comes from the local token count, as in the reference, so the set
of dropped tokens is the reference's for the same mesh. The exchange is
``comm.collectives._all_to_all`` (a transpose of the stacked dim in one
process, ``all_to_all_single`` across processes) inside an
``autograd.Function`` whose backward is the same exchange, since the
all-to-all is its own inverse, as ``lax.all_to_all``'s transpose is.

The reference builds one-hot dispatch and combine tensors (T·E·C each) and
contracts them with ``einsum``; the port keeps the same decisions as
indices (:func:`_route`) and gathers and scatters by them, which gives the
same values (each slot holds one token; a token sums its k ≤ 2 gated
outputs as the contraction does) without the T·E·C tensors, which at an
evaluation batch of 512 windows of 512 tokens would not fit on the card.
:func:`_routing` still builds them, for the tests.

Routing follows the reference to its tie order: top-k by a stable
descending sort (``lax.top_k`` puts the lower index first on a tie;
``torch.topk``'s tie order on CUDA is unspecified), choice-major queueing
by an f32 ``cumsum`` (every first choice claims its slot before any second
choice), dispatch and combine in f32, the output cast back to ``h``'s
dtype, ``gelu`` in its tanh form (``jax.nn.gelu``'s default). The aux
statistics are averaged over the workers inside the op (the reference's
``pmean``), and across processes by :class:`_WorldMean`, whose backward
passes the cotangent's world mean back (the transpose of a ``pmean`` under
``check_vma=False``: every worker's local statistics see the full
cotangent).

:func:`moe_ffn_dense_reference` is the unsharded ground truth: all experts,
one token set.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    num_experts: int, device=None) -> dict:
    """Router + stacked expert FFN weights (E on the leading axis), drawn
    on the CPU from ``generator`` and moved to ``device``."""
    scale = 1.0 / math.sqrt(d_model)
    g = generator
    params = {
        "router": torch.randn(d_model, num_experts, generator=g) * scale,
        "w_up": torch.randn(num_experts, d_model, d_ff, generator=g) * scale,
        "b_up": torch.zeros(num_experts, d_ff),
        "w_down": torch.randn(num_experts, d_ff, d_model, generator=g) / math.sqrt(d_ff),
        "b_down": torch.zeros(num_experts, d_model),
    }
    return {k: v.to(device) for k, v in params.items()} if device is not None else params


def _expert_ffn(w_up, b_up, w_down, b_down, x):
    """The experts' FFN over batched expert dims: ``x`` (..., E, S, D)
    with weights (..., E, D, F) etc. The one definition both paths run."""
    up = torch.matmul(x, w_up) + b_up.unsqueeze(-2)
    return torch.matmul(F.gelu(up, approximate="tanh"), w_down) + b_down.unsqueeze(-2)


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last dim, the lower index
    first on a tie (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(h2, router, num_experts: int, capacity: int, top_k: int = 1):
    """The routing decisions of (..., T, D) tokens, leading dims independent
    groups (the stacked workers), in choice-major order (every token's
    first choice, then every second choice): per assignment its expert
    (..., k·T), its capacity slot, whether it was kept, and its gate; and
    each group's statistics. The reference's dense dispatch and combine
    tensors (:func:`_routing`) are these indices one-hot."""
    if not 1 <= top_k <= num_experts:
        raise ValueError(
            f"top_k={top_k} must be in [1, num_experts={num_experts}]"
        )
    t = h2.shape[-2]
    lead = h2.shape[:-2]
    logits = torch.matmul(h2.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, top_k)  # (..., T, k)
    if top_k > 1:
        # GShard: the selected gates renormalize to sum to one; top-1 keeps
        # the raw probability (Switch)
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    # choice-major queueing in f32, as the reference counts
    expert = expert_idx.transpose(-1, -2).reshape(*lead, top_k * t)
    flat_oh = F.one_hot(expert, num_experts).float()  # (..., k·T, E)
    position = torch.cumsum(flat_oh, dim=-2) * flat_oh - 1.0
    kept_oh = (position < capacity) & (flat_oh > 0)
    slot = torch.where(kept_oh, position, torch.zeros_like(position)).sum(-1).long()
    stats = {
        # first-choice density (no gradient) and mean probability
        "f": F.one_hot(expert_idx[..., 0], num_experts).float().mean(-2),
        "p": probs.mean(-2),
        "z": torch.logsumexp(logits, dim=-1).square().mean(-1),
        "dropped": 1.0 - kept_oh.float().sum((-2, -1)) / (top_k * t),
    }
    gates = gate_vals.transpose(-1, -2).reshape(*lead, top_k * t)
    return expert, slot, kept_oh.any(-1), gates, stats


def _routing(h2, router, num_experts: int, capacity: int, top_k: int = 1):
    """(..., T, D) tokens → dispatch (..., T, E, C) one-hot, combine (...,
    T, E, C), and the routing statistics: the reference's ``_routing``
    (``mpit_tpu/ops/moe.py:62``). The ops themselves use the index form,
    :func:`_route`, and never build these (T·E·C each)."""
    expert, slot, kept, gates, stats = _route(h2, router, num_experts, capacity, top_k)
    t = h2.shape[-2]
    lead = h2.shape[:-2]
    at = (F.one_hot(expert, num_experts).float()[..., :, :, None]
          * F.one_hot(slot, capacity).float()[..., :, None, :]
          * kept.float()[..., :, None, None])
    disp_choice = at.reshape(*lead, top_k, t, num_experts, capacity)
    dispatch = disp_choice.sum(-4)
    combine = torch.einsum("...kt,...ktec->...tec",
                           gates.reshape(*lead, top_k, t), disp_choice)
    return dispatch, combine, stats


def _dispatch(h2, expert, slot, kept, num_experts: int, capacity: int):
    """The reference's ``einsum("tec,td->ecd", dispatch, h2)`` by index:
    each kept assignment's token (f32) written into its expert's slot of an
    (..., E, C, D) buffer of zeros (a slot holds at most one token; a
    dropped one goes to a spare row that is cut off)."""
    lead, d = h2.shape[:-2], h2.shape[-1]
    k = expert.shape[-1] // h2.shape[-2]
    src = torch.cat([h2.float()] * k, dim=-2)  # choice-major, as ``expert``
    spare = num_experts * capacity
    idx = torch.where(kept, expert * capacity + slot, torch.full_like(slot, spare))
    buf = src.new_zeros(*lead, spare + 1, d)
    buf = buf.scatter(-2, idx[..., None].expand(*idx.shape, d), src)
    return buf[..., :spare, :].reshape(*lead, num_experts, capacity, d), idx


def _combine(out, idx, gates, kept, top_k: int):
    """The reference's ``einsum("tec,ecd->td", combine, out)`` by index:
    each token's kept assignments' expert outputs, gate-scaled, summed over
    its choices (a dropped assignment adds 0)."""
    lead, d = out.shape[:-3], out.shape[-1]
    flat = out.reshape(*lead, -1, d)
    flat = torch.cat([flat, flat.new_zeros(*lead, 1, d)], dim=-2)
    got = flat.gather(-2, idx[..., None].expand(*idx.shape, d))
    got = got * (gates * kept.float())[..., None]
    return got.reshape(*lead, top_k, -1, d).sum(-3)


def _aux_from_stats(f, p, z, dropped, num_experts: int) -> dict:
    """Balance/z losses from (averaged) routing stats: ``balance`` is the
    Switch/GShard load-balance loss ``E · Σ_e f_e · p_e`` (1.0 under
    perfectly uniform routing); ``f`` carries no gradient."""
    return {
        "balance": num_experts * torch.dot(f, p),
        "zloss": z,
        "dropped_frac": dropped,
    }


class _AllToAll(torch.autograd.Function):
    """The stacked workers' all-to-all (``comm.collectives._all_to_all``):
    ``(W_local, W, ...)`` rows exchanged so each worker holds every source
    worker's row bound for it. It is its own inverse, so the backward is
    the same exchange of the cotangent."""

    @staticmethod
    def forward(a):
        from mpit_tpu_torch.comm.collectives import _all_to_all

        return _all_to_all(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        from mpit_tpu_torch.comm.collectives import _all_to_all

        return _all_to_all(g.contiguous())


class _WorldMean(torch.autograd.Function):
    """The mean over the world's processes of a value every process holds
    (a ``pmean`` across processes); the backward is the same mean of the
    cotangent, as a ``pmean`` transposes under ``check_vma=False``."""

    @staticmethod
    def forward(a):
        return _process_mean(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g):
        return _process_mean(g)


def _process_mean(a: torch.Tensor) -> torch.Tensor:
    from mpit_tpu_torch.comm.topology import current_process, in_process_group

    if not in_process_group():
        return a
    import torch.distributed as dist

    out = a.detach().clone().contiguous()
    dist.all_reduce(out)
    return out / current_process()[1]


def exchange(a: torch.Tensor) -> torch.Tensor:
    """The differentiable all-to-all of the stacked workers."""
    return _AllToAll.apply(a.contiguous())


def world_mean(a: torch.Tensor) -> torch.Tensor:
    """The differentiable mean across the world's processes (identity in
    one process)."""
    from mpit_tpu_torch.comm.topology import in_process_group

    return _WorldMean.apply(a) if in_process_group() else a


def moe_ffn(
    params: dict,
    h: torch.Tensor,
    axis: str = "ep",
    capacity_factor: float = 2.0,
    top_k: int = 1,
    with_aux: bool = False,
):
    """Expert-parallel MoE FFN over the stacked workers.

    ``h``: ``(W, b, t, D)``, worker ``w``'s LOCAL activation block at row
    ``w``. ``params["w_up"]``/... hold this process's workers' experts
    (leading dim ``W·E/ep``, worker order); ``params["router"]`` scores all
    ``E`` experts. Returns the shape of ``h`` (plus the aux dict of
    ``balance``/``zloss``/``dropped_frac`` scalars when ``with_aux``, each
    averaged over every worker of the world, so every worker holds the
    global value). ``axis`` names the reference's mesh axis (the stacked
    dim here). Capacity comes from the LOCAL token count ``b·t``, as in
    the reference (its capacity caveat holds here too)."""
    from mpit_tpu_torch.comm.topology import current_process

    wl, b, t, d = h.shape
    ep = wl * current_process()[1]
    e_held = params["w_up"].shape[0]
    if e_held % wl:
        raise ValueError(
            f"{e_held} expert(s) held do not split over {wl} stacked workers"
        )
    e_local = e_held // wl
    num_experts = e_local * ep
    if params["router"].shape[1] != num_experts:
        raise ValueError(
            f"router scores {params['router'].shape[1]} experts but the "
            f"local shard x axis implies {num_experts} (= {e_local} local "
            f"x ep={ep}); are the expert weights actually sharded P(ep)?"
        )
    tokens = b * t
    capacity = int(math.ceil(tokens * capacity_factor / num_experts))
    h2 = h.reshape(wl, tokens, d)
    expert, slot, kept, gates, stats = _route(h2, params["router"], num_experts,
                                              capacity, top_k=top_k)
    # pack: (W, E, C, D) per worker, by expert and slot; then regroup so
    # each worker holds its own experts' slots from every peer
    buf, idx = _dispatch(h2, expert, slot, kept, num_experts, capacity)
    buf = exchange(buf.reshape(wl, ep, e_local, capacity, d))  # (W, ep, e_l, C, D)
    buf = buf.transpose(1, 2).reshape(wl, e_local, ep * capacity, d)

    def per_worker(a):
        return a.reshape(wl, e_local, *a.shape[1:])

    out = _expert_ffn(per_worker(params["w_up"]), per_worker(params["b_up"]),
                      per_worker(params["w_down"]), per_worker(params["b_down"]), buf)
    # reverse the exchange: every peer gets its slots back
    out = out.reshape(wl, e_local, ep, capacity, d).transpose(1, 2)
    out = exchange(out).reshape(wl, num_experts, capacity, d)
    res = _combine(out, idx, gates, kept, top_k)
    res = res.reshape(wl, b, t, d).to(h.dtype)
    if not with_aux:
        return res
    g = {k: world_mean(v.mean(0)) for k, v in stats.items()}
    return res, _aux_from_stats(g["f"], g["p"], g["z"], g["dropped"], num_experts)


def moe_ffn_dense_reference(
    params_full: dict,
    h: torch.Tensor,
    capacity_factor: float = 2.0,
    top_k: int = 1,
    with_aux: bool = False,
):
    """Unsharded ground truth: ``h`` (b, t, D) routed as one token set over
    ALL experts (``params_full``'s leading dim E), with the identical
    capacity and overflow rule."""
    b, t, d = h.shape
    num_experts = params_full["w_up"].shape[0]
    tokens = b * t
    capacity = int(math.ceil(tokens * capacity_factor / num_experts))
    h2 = h.reshape(tokens, d)
    expert, slot, kept, gates, stats = _route(h2, params_full["router"], num_experts,
                                              capacity, top_k=top_k)
    buf, idx = _dispatch(h2, expert, slot, kept, num_experts, capacity)
    out = _expert_ffn(params_full["w_up"], params_full["b_up"], params_full["w_down"],
                      params_full["b_down"], buf)
    res = _combine(out, idx, gates, kept, top_k).reshape(b, t, d).to(h.dtype)
    if not with_aux:
        return res
    return res, _aux_from_stats(stats["f"], stats["p"], stats["z"], stats["dropped"],
                                num_experts)
