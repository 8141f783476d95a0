"""Ulysses sequence parallelism over a stacked sequence ring; counterpart
of ``mpit_tpu/ops/ulysses.py``.

The reference re-shards once with an ``all_to_all``: the sequence-sharded
``(B, T/P, H, D)`` blocks become head-sharded ``(B, T, H/P, D)``, each
device runs dense attention over the whole sequence for its heads, and the
reverse ``all_to_all`` restores the sequence blocks. With the ring stacked
on dim 0 (``ops/ring_attention.py``) each exchange is a reshape and a
permute of ``(sp, B, T_l, H, D)``: block ``r`` of the result gathers head
group ``r`` of every sequence block, in ring order, so positions are global
and the causal mask needs no offset. A ring that spans processes (``span``,
an ``AxisSpan`` of the sp axis) stacks each process's share of the blocks,
and each exchange then also makes one ``all_to_all_single`` over the
ring's processes (``comm.collectives.line_all_to_all``, differentiable;
none inside one process): process ``j`` gets head groups ``[j·c,
(j+1)·c)`` of every block, ``c`` blocks a process. The reference's op is
jnp, so this one stays PyTorch operations.
"""

from __future__ import annotations

from mpit_tpu_torch.comm.collectives import line_all_to_all
from mpit_tpu_torch.ops.ring_attention import dense_attention


def ulysses_attention(q, k, v, causal: bool = False, axis_name: str = "sp", span=None):
    """Exact attention over the stacked ring ``(sp, B, T_l, H, D)`` (the
    layout of :func:`~mpit_tpu_torch.ops.ring_attention.ring_attention`);
    ``H`` must divide by the ring's size. ``axis_name`` only names the axis
    in the error. Returns the blocks of ``softmax(QKᵀ/√D)V``, same shape
    and dtype as ``q``. With ``span`` the stack is this process's blocks
    ``[span.start, span.start + span.count)`` of a ring of ``span.size``."""
    if q.dim() != 5:
        raise ValueError(f"expected (sp, B, T, H, D) inputs, got {tuple(q.shape)}")
    c, b, t_l, h, d = q.shape
    sp = c if span is None else span.size
    if h % sp:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the {sp}-wide "
            f"{axis_name!r} axis; use ring attention for more devices "
            "than heads"
        )
    hp, procs = h // sp, sp // c

    def seq_to_head(a):  # (c, B, T_l, H, D) -> (c·B, T, H/sp, D)
        # (c_seq, B, T_l, procs, c_heads, H/sp, D), a row per process of the ring
        a = a.reshape(c, b, t_l, procs, c, hp, d).permute(3, 0, 1, 2, 4, 5, 6)
        a = line_all_to_all(a, span)
        # (procs, c_seq, B, T_l, c_heads, ...) -> (c_heads, B, sp_seq, T_l, ...)
        a = a.reshape(sp, b, t_l, c, hp, d).permute(3, 1, 0, 2, 4, 5)
        return a.reshape(c * b, sp * t_l, hp, d)

    out = dense_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                          causal=causal)
    # (c_heads, B, procs, c_seq, T_l, H/sp, D) -> (procs, c_seq, B, T_l, c_heads, ...)
    out = out.reshape(c, b, procs, c, t_l, hp, d).permute(2, 3, 1, 4, 0, 5, 6)
    out = line_all_to_all(out, span)
    # (procs_heads, c_seq, B, T_l, c_heads, ...) -> (c_seq, B, T_l, H, D)
    return out.permute(1, 2, 3, 0, 4, 5, 6).reshape(c, b, t_l, h, d)

