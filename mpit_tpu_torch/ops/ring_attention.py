"""Dense attention over the full sequence; counterpart of
``mpit_tpu/ops/ring_attention.py``'s ``dense_attention``.

It is the transformer's ``attn_impl="xla"`` path and the plain reference
the flash kernels are held against. Ring attention itself (the
sequence-parallel schedule) is not ported yet (ROADMAP A9).
"""

from __future__ import annotations

import torch


def dense_attention(q, k, v, causal: bool = False):
    """``(B, T, H, D) -> (B, T, H, D)``: f32 scores from the compute-dtype
    inputs, the causal mask, softmax in f32, and P·V with P in f32, cast
    back to ``q.dtype`` (the reference's ``preferred_element_type=f32``
    einsums: products of bf16 values are exact in f32, so the operands are
    widened and the sums taken in f32)."""
    d = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        t_q, t_k = s.shape[-2], s.shape[-1]
        mask = (torch.arange(t_k, device=s.device)[None, :]
                <= torch.arange(t_q, device=s.device)[:, None])
        s = torch.where(mask, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
