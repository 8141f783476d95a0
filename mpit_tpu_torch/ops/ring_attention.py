"""Ring attention over a stacked sequence ring, and dense attention;
counterpart of ``mpit_tpu/ops/ring_attention.py``.

The reference shards the sequence over a mesh axis: device ``r`` holds
the contiguous block of global positions ``[r·T_l, (r+1)·T_l)``, and K/V
blocks rotate around the ring with ``lax.ppermute``, each device folding
every visiting block into its queries' online-softmax accumulator. On one
card the ring is stacked, as the port's workers are: the ``sp`` blocks lie
on dim 0 of ``(sp, B, T_l, H, D)`` tensors, and a rotation is
``torch.roll`` over that dim. A ring that spans processes stacks each
process's share of the blocks (``span``, ``comm/topology.py``
``AxisSpan``), and a rotation passes the edge block to the next process
(``comm.collectives.ring_hop``); the masks use the blocks' global
positions. The fold order, the f32 accumulators and the
``-inf`` guards are the reference's, so the result is exact attention, not
an approximation: only the order of the sums differs from
:func:`dense_attention`.

The reference's ring is jnp, not Pallas, so here it stays PyTorch
operations. :func:`dense_attention` is also the transformer's
``attn_impl="xla"`` path and the plain reference of the flash kernels.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.comm.collectives import ring_hop
from mpit_tpu_torch.ops.products import matmul_f32


def dense_attention(q, k, v, causal: bool = False):
    """``(B, T, H, D) -> (B, T, H, D)``: f32 scores from the compute-dtype
    inputs (:func:`matmul_f32`, the reference's ``preferred_element_type=f32``
    einsum), the causal mask, softmax in f32, and P·V with P in f32 (the
    reference's einsum promotes the values to f32), cast back to
    ``q.dtype``."""
    d = q.shape[-1]
    s = matmul_f32(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)) / (d ** 0.5)
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t_k, device=s.device)[None, :]
                <= torch.arange(t_q, device=s.device)[:, None])
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def _online_block(m, l, acc, q, k, v, mask, scale):
    """Fold one K/V block into the accumulator (``_online_block`` of the
    reference). Scores ``(sp, B, H, Tq, Tk)``; ``m``, ``l`` ``(sp, B, H,
    Tq)`` and ``acc`` ``(sp, B, H, Tq, D)``, all f32. A masked position
    never contributes (exp(-inf) = 0), and a row with nothing unmasked so
    far keeps l = 0."""
    s = matmul_f32(q.permute(0, 1, 3, 2, 4), k.permute(0, 1, 3, 4, 2)) * scale
    if mask is not None:
        s = torch.where(mask, s, float("-inf"))
    m_new = torch.maximum(m, s.amax(-1))
    # a -inf max (nothing unmasked yet) would make the exps below nan;
    # every term it touches is exp(-inf - 0) = 0 anyway
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    correction = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    l_new = l * correction + p.sum(-1)
    acc_new = acc * correction[..., None] + torch.einsum(
        "sbhqk,sbkhd->sbhqd", p, v.float())
    return m_new, l_new, acc_new


def ring_attention(q, k, v, causal: bool = False, span=None):
    """Exact attention over a stacked sequence ring: ``q``, ``k``, ``v``
    are ``(sp, B, T_l, H, D)``, block ``r`` the global positions ``[r·T_l,
    (r+1)·T_l)``. Returns the blocks of ``softmax(QKᵀ/√D)V``, same shape
    and dtype as ``q``. ``causal`` masks by global positions. At step
    ``i`` block ``r`` folds the K/V block that started at ``r − i``, as
    the reference's ring does. With ``span`` (an ``AxisSpan`` of the sp
    axis) the stack is this process's blocks ``[span.start, span.start +
    span.count)`` of a ring of ``span.size`` that spans processes."""
    if q.dim() != 5:
        raise ValueError(f"expected (sp, B, T, H, D) inputs, got {tuple(q.shape)}")
    sp, b, t_q, h, d = q.shape
    size, start = (sp, 0) if span is None else (span.size, span.start)
    t_k = k.shape[2]
    dev = q.device
    scale = 1.0 / (d ** 0.5)
    m = torch.full((sp, b, h, t_q), float("-inf"), device=dev)
    l = torch.zeros((sp, b, h, t_q), device=dev)
    acc = torch.zeros((sp, b, h, t_q, d), device=dev)
    ranks = torch.arange(start, start + sp, device=dev)
    q_pos = ranks[:, None] * t_q + torch.arange(t_q, device=dev)
    for i in range(size):
        mask = None
        if causal:
            src = (ranks - i) % size
            k_pos = src[:, None] * t_k + torch.arange(t_k, device=dev)
            # (sp, 1, 1, Tq, Tk): per block, over batch and heads
            mask = (k_pos[:, None, :] <= q_pos[:, :, None])[:, None, None]
        m, l, acc = _online_block(m, l, acc, q, k, v, mask, scale)
        if i + 1 < size:
            k, v = ring_hop(k, 1, span), ring_hop(v, 1, span)
    # causal rows always see >= 1 key (their own), so l > 0; the guard
    # keeps a fully masked row finite instead of 0/0
    out = acc / torch.clamp(l, min=torch.finfo(torch.float32).tiny)[..., None]
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def to_blocks(a: torch.Tensor, sp: int) -> torch.Tensor:
    """``(B, T, ...)`` → the stacked ring ``(sp, B, T/sp, ...)``: block
    ``r`` holds positions ``[r·T/sp, (r+1)·T/sp)``."""
    b, t = a.shape[:2]
    if t % sp:
        raise ValueError(f"sequence length {t} not divisible by sp={sp}")
    return a.reshape(b, sp, t // sp, *a.shape[2:]).transpose(0, 1)


def from_blocks(a: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_blocks`."""
    sp, b, t_l = a.shape[:3]
    return a.transpose(0, 1).reshape(b, sp * t_l, *a.shape[3:])


def make_ring_attention(sp: int, causal: bool = False):
    """Ring attention over global ``(B, T, H, D)`` tensors cut into ``sp``
    stacked blocks (the reference's ``make_ring_attention`` over a mesh):
    a callable returning the global result."""

    def ring(q, k, v):
        if q.dim() != 4:
            raise ValueError(f"expected (B, T, H, D) inputs, got {tuple(q.shape)}")
        blocks = (to_blocks(a, sp) for a in (q, k, v))
        return from_blocks(ring_attention(*blocks, causal=causal))

    return ring
