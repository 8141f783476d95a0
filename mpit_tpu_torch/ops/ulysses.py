"""Ulysses sequence parallelism over a stacked sequence ring; counterpart
of ``mpit_tpu/ops/ulysses.py``.

The reference re-shards once with an ``all_to_all``: the sequence-sharded
``(B, T/P, H, D)`` blocks become head-sharded ``(B, T, H/P, D)``, each
device runs dense attention over the whole sequence for its heads, and the
reverse ``all_to_all`` restores the sequence blocks. With the ring stacked
on dim 0 (``ops/ring_attention.py``) each exchange is a reshape and a
permute of ``(sp, B, T_l, H, D)``: block ``r`` of the result gathers head
group ``r`` of every sequence block, in ring order, so positions are global
and the causal mask needs no offset. The reference's op is jnp, so this one
stays PyTorch operations.
"""

from __future__ import annotations

from mpit_tpu_torch.ops.ring_attention import dense_attention


def ulysses_attention(q, k, v, causal: bool = False, axis_name: str = "sp"):
    """Exact attention over the stacked ring ``(sp, B, T_l, H, D)`` (the
    layout of :func:`~mpit_tpu_torch.ops.ring_attention.ring_attention`);
    ``H`` must divide by ``sp``. ``axis_name`` only names the axis in the
    error. Returns the blocks of ``softmax(QKᵀ/√D)V``, same shape and
    dtype as ``q``."""
    if q.dim() != 5:
        raise ValueError(f"expected (sp, B, T, H, D) inputs, got {tuple(q.shape)}")
    sp, b, t_l, h, d = q.shape
    if h % sp:
        raise ValueError(
            f"ulysses needs num_heads ({h}) divisible by the {sp}-wide "
            f"{axis_name!r} axis; use ring attention for more devices "
            "than heads"
        )
    hp = h // sp

    def seq_to_head(a):  # (sp, B, T_l, H, D) -> (sp·B, T, H/sp, D)
        a = a.reshape(sp, b, t_l, sp, hp, d).permute(3, 1, 0, 2, 4, 5)
        return a.reshape(sp * b, sp * t_l, hp, d)

    out = dense_attention(seq_to_head(q), seq_to_head(k), seq_to_head(v),
                          causal=causal)
    # (sp_heads, B, sp_seq, T_l, H/sp, D) -> (sp_seq, B, T_l, sp_heads, H/sp, D)
    out = out.reshape(sp, b, sp, t_l, hp, d).permute(2, 1, 3, 0, 4, 5)
    return out.reshape(sp, b, t_l, h, d)
