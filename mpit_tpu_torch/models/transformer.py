"""Causal transformer LM, training configuration; counterpart of
``mpit_tpu/models/transformer.py`` (``Block`` and ``TransformerLM``).

A pre-LN decoder: each block is LayerNorm → bias-free qkv Dense split as
``[q | k | v]`` into ``(B, T, H, D)`` → causal attention → bias-free output
Dense → residual, then LayerNorm → Dense → ``gelu`` (tanh form, flax's
default) → Dense → residual. Token embedding plus a float32
``pos_embedding`` table cast to the compute dtype; a final LayerNorm; the
tied head returns float32 logits computed from float32 operands holding the
compute-dtype values (products of bf16 values are exact in f32, so this is
the reference's bf16 einsum with f32 accumulation, never bf16 logits; keep
TF32 off on the card).

``attn_impl``: ``"xla"`` is :func:`dense_attention`; ``"flash"`` is
:func:`flash_attention` (the CUDA kernels for CUDA tensors, their plain
versions on the CPU); ``"flash_force"`` requires the kernels and raises on
the CPU.

``seq_axis`` set (the reference's sequence-parallel model, applied inside
``shard_map``): the model takes the stacked sequence ring, tokens ``(sp, B,
T_l)`` whose block ``r`` holds global positions ``[r·T_l, (r+1)·T_l)``
(``parallel/seq.py`` cuts them), reads the positional rows at those global
positions and returns ``(sp, B, T_l, vocab)`` logits. Its attention is
:func:`ring_attention` over the stacked blocks, or
:func:`ulysses_attention` with ``seq_impl="ulysses"``; either is taken
before ``attn_impl`` is read, as in the reference.

``remat`` recomputes each block's activations on the backward pass
(:func:`~mpit_tpu_torch.models.layers.rematerialized`, flax's ``nn.remat``);
the trainers then take the gradient with ``torch.autograd.grad``
(``parallel/common.py``).

Parameter names are flax's: ``Embed_0``, ``pos_embedding``,
``Block_i/{LayerNorm_0, Dense_0, Dense_1, LayerNorm_1, Dense_2, Dense_3}``,
``LayerNorm_0``, with or without remat. MoE and decoding are not ported yet
and raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    Dense, Embed, LayerNorm, Model, rematerialized, reset_children,
)
from mpit_tpu_torch.ops.flash_attention import flash_attention
from mpit_tpu_torch.ops.ring_attention import dense_attention, ring_attention
from mpit_tpu_torch.ops.ulysses import ulysses_attention

ATTN_IMPLS = ("xla", "flash", "flash_force")
SEQ_IMPLS = ("ring", "ulysses")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to mpit_tpu_torch yet (ROADMAP.md, {item})"
    )


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, compute_dtype,
                 attn_impl: str, device, seq_axis=None, seq_impl: str = "ring"):
        super().__init__()
        dt = compute_dtype
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.LayerNorm_0 = LayerNorm(d_model, dt, device)
        self.Dense_0 = Dense(d_model, 3 * d_model, dt, device, use_bias=False)
        self.Dense_1 = Dense(d_model, d_model, dt, device, use_bias=False)
        self.LayerNorm_1 = LayerNorm(d_model, dt, device)
        self.Dense_2 = Dense(d_model, d_ff, dt, device)
        self.Dense_3 = Dense(d_ff, d_model, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)

    def forward(self, x):
        """``x`` is ``(B, T, d_model)``, or the stacked ring ``(sp, B, T_l,
        d_model)`` with ``seq_axis`` set."""
        d_model, h = x.shape[-1], self.num_heads
        qkv = self.Dense_0(self.LayerNorm_0(x))
        q, k, v = (a.reshape(*x.shape[:-1], h, d_model // h)
                   for a in qkv.split(d_model, -1))
        if self.seq_axis is not None and self.seq_impl == "ulysses":
            att = ulysses_attention(q, k, v, causal=True, axis_name=self.seq_axis)
        elif self.seq_axis is not None:
            att = ring_attention(q, k, v, causal=True)
        elif self.attn_impl == "xla":
            att = dense_attention(q, k, v, causal=True)
        else:
            att = flash_attention(
                q, k, v, causal=True,
                use_kernel=True if self.attn_impl == "flash_force" else None,
            )
        x = x + self.Dense_1(att.reshape(x.shape))
        y = F.gelu(self.Dense_2(self.LayerNorm_1(x)), approximate="tanh")
        return x + self.Dense_3(y)


class TransformerLM(Model):
    """Next-token LM over ``(B, T)`` integer tokens → f32 logits
    ``(B, T, vocab_size)``; with ``seq_axis`` set, over the stacked ring
    ``(sp, B, T_l)`` → ``(sp, B, T_l, vocab_size)``."""

    def __init__(
        self,
        vocab_size: int,
        num_layers: int = 2,
        d_model: int = 128,
        num_heads: int = 4,
        d_ff: int = 0,
        max_len: int = 1024,
        compute_dtype: torch.dtype = torch.bfloat16,
        seq_axis=None,
        remat: bool = False,
        moe_experts: int = 0,
        attn_impl: str = "xla",
        seq_impl: str = "ring",
        decode: bool = False,
        head_dtype=None,
        device=None,
    ):
        super().__init__()
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(
                f"seq_impl={seq_impl!r} must be 'ring' or 'ulysses'"
            )
        if moe_experts:
            raise _not_ported("the MoE FFN (moe_experts)", "item A11")
        if decode:
            raise _not_ported("decode mode", "item A10")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={attn_impl!r}; have {ATTN_IMPLS}")
        if d_model % num_heads:
            raise ValueError(
                f"d_model {d_model} not divisible by num_heads {num_heads}"
            )
        device = resolve_device(device)
        dt = compute_dtype
        self.vocab_size, self.num_layers = vocab_size, num_layers
        self.d_model, self.num_heads = d_model, num_heads
        self.d_ff = d_ff or 4 * d_model
        self.max_len = max_len
        self.compute_dtype = dt
        self.attn_impl = attn_impl
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.remat = remat
        self.head_dtype = head_dtype
        self.Embed_0 = Embed(vocab_size, d_model, dt, device)
        self.pos_embedding = nn.Parameter(torch.zeros(max_len, d_model, device=device))
        for i in range(num_layers):
            setattr(self, f"Block_{i}",
                    Block(d_model, num_heads, self.d_ff, dt, attn_impl, device,
                          seq_axis, seq_impl))
        self.LayerNorm_0 = LayerNorm(d_model, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)
        draw = torch.randn(self.pos_embedding.shape, generator=generator)
        with torch.no_grad():
            self.pos_embedding.copy_(draw * 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t_local = tokens.shape[-1]
        sp = tokens.shape[0] if self.seq_axis is not None else 1
        total_len = t_local * sp
        if total_len > self.max_len:
            raise ValueError(
                f"sequence of {total_len} exceeds max_len={self.max_len}"
            )
        pos = self.pos_embedding[:total_len]
        if self.seq_axis is not None:
            # block r of the ring holds global positions [r·T_l, (r+1)·T_l)
            pos = pos.reshape(sp, 1, t_local, -1)
        x = self.Embed_0(tokens) + pos.to(self.compute_dtype)
        for i in range(self.num_layers):
            block = getattr(self, f"Block_{i}")
            x = rematerialized(block, x) if self.remat else block(x)
        x = self.LayerNorm_0(x)
        hdt = self.compute_dtype if self.head_dtype is None else self.head_dtype
        table = self.Embed_0.embedding.to(hdt).float()
        return torch.matmul(x.to(hdt).float(), table.t())
