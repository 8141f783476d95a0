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
``LayerNorm_0``, with or without remat. The MoE FFN is not ported yet and
raises.

Decode mode (``decode=True``, the serving path of ``models/sampling.py``):
the model takes a T-token chunk ``(B, T)`` and a cache tree and returns
``(out, cache)``, the way flax's ``apply(..., mutable=["cache"])`` returns
the ``cache`` collection. The tree has flax's names and shapes:
``Block_i/{cached_key, cached_value}`` ``(B, max_len, H, D)`` in the
compute dtype, ``Block_i/cache_index`` and ``pos_index`` ``(B,)`` int32, one
position clock per row (:meth:`TransformerLM.init_cache` makes a zero
one). A chunk's K/V go into the cache tensors in place at each row's clock
and its query row ``r`` attends positions ``<= clock + r``; the clocks
advance by T. Out-of-range positions are clamped as XLA clamps them: the
K/V write starts at ``min(clock, max_len - T)`` and the positional gather
reads row ``min(position, max_len - 1)`` (a server's free slots tick past
the horizon). ``head=False`` returns the final LayerNorm's output instead
of logits, and :meth:`TransformerLM.head_logits` projects chosen rows of
it through the same head.

A row decoded alone equals the same row decoded in a batch, on the card
too: no product, norm or softmax of the decode path runs at a row count
that the batch or the caller sets. A tick (T = 1) runs the rows
:data:`~mpit_tpu_torch.models.layers.ROW_BLOCK` at a time, the last block
padded with zero rows; a longer chunk (a prompt, a verification chunk)
runs one row at a time, at M = T; the products go through
:func:`~mpit_tpu_torch.models.layers.matmul_rows`, and
:meth:`TransformerLM.head_logits` projects its rows in blocks of
``ROW_BLOCK`` as well.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    ROW_BLOCK, Dense, Embed, LayerNorm, Model, matmul_rows, pad_rows, rematerialized,
    reset_children,
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

    def forward(self, x, cache=None):
        """``x`` is ``(B, T, d_model)``, or the stacked ring ``(sp, B, T_l,
        d_model)`` with ``seq_axis`` set. With ``cache`` (this block's
        ``cached_key``, ``cached_value``, ``cache_index`` for the first of
        ``x``'s rows; the rest are pad rows) the block runs a decode chunk,
        writing the chunk's K/V into the cache in place."""
        if cache is not None:
            return self._decode(x, cache)
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

    def _decode(self, x, cache):
        d_model, h = x.shape[-1], self.num_heads
        qkv = _dense(self.Dense_0, self.LayerNorm_0(x))
        q, k, v = (a.reshape(*x.shape[:-1], h, d_model // h)
                   for a in qkv.split(d_model, -1))
        att = _cached_attention(q, k, v, cache)
        x = x + _dense(self.Dense_1, att.reshape(x.shape))
        y = F.gelu(_dense(self.Dense_2, self.LayerNorm_1(x)), approximate="tanh")
        return x + _dense(self.Dense_3, y)


def _dense(layer: Dense, x):
    """``layer(x)`` with its product through :func:`matmul_rows`."""
    y = matmul_rows(x, layer.kernel.to(layer.dtype))
    return y if layer.bias is None else y + layer.bias.to(layer.dtype)


def _cached_attention(q, k, v, cache):
    """Causal attention of a T-token chunk ``q, k, v`` (W, T, H, D) over the
    block's K/V cache of N <= W rows (``Block._cached_attention`` of the
    reference; rows past N are pad rows): the first N rows' K/V are written
    into the cache in place at each row's clock ``i`` (the start clamped to
    ``[0, L - T]``, as ``dynamic_update_slice`` clamps it), and query row
    ``r`` of batch row ``n`` sees positions ``<= i[n] + r``. Scores, softmax
    and P·V in float32 from the compute-dtype values, over the cache padded
    with zero rows to W (a pad row sees position 0 only). The caller
    advances the clocks."""
    ck, cv, i = cache["cached_key"], cache["cached_value"], cache["cache_index"]
    w, t, h, d = q.shape
    n, length = ck.shape[0], ck.shape[1]
    if t > length:
        raise ValueError(f"chunk of {t} exceeds the {length}-slot cache")
    steps = torch.arange(t, device=q.device)
    start = torch.clamp(i.long(), 0, length - t)
    slots = start[:, None] + steps
    rows = torch.arange(n, device=q.device)[:, None]
    ck[rows, slots] = k[:n].to(ck.dtype)
    cv[rows, slots] = v[:n].to(cv.dtype)
    keys, values = pad_rows(ck.float(), w), pad_rows(cv.float(), w)
    s = matmul_rows(q.float().permute(0, 2, 1, 3), keys.permute(0, 2, 3, 1)) / (d ** 0.5)
    mask = (torch.arange(length, device=q.device)[None, None, :]
            <= pad_rows(i.long(), w)[:, None, None] + steps[None, :, None])  # (w, t, L)
    s = torch.where(mask[:, None], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = matmul_rows(p, values.permute(0, 2, 1, 3)).permute(0, 2, 1, 3)
    return out.to(q.dtype)


def _cache_rows(cache, start: int, stop: int) -> dict:
    """Rows ``[start, stop)`` of a decode cache tree, as views (writes go to
    the tree's tensors)."""
    return {name: ({k: a[start:stop] for k, a in node.items()}
                   if isinstance(node, dict) else node[start:stop])
            for name, node in cache.items()}


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
        head: bool = True,
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
        self.decode, self.head, self.head_dtype = decode, head, head_dtype
        self._check_settings()
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

    _CLONE_FIELDS = ("decode", "head", "head_dtype")

    def _check_settings(self) -> None:
        if self.decode and self.seq_axis is not None:
            raise ValueError("decode mode requires seq_axis=None")

    def init_cache(self, batch: int, device=None) -> dict:
        """A zero decode cache for ``batch`` rows (flax's initial ``cache``
        collection): per block ``cached_key``/``cached_value`` ``(batch,
        max_len, H, D)`` in the compute dtype and ``cache_index``
        ``(batch,)`` int32, and the LM's ``pos_index`` ``(batch,)``."""
        dev = resolve_device(device)
        h = self.num_heads
        shape = (batch, self.max_len, h, self.d_model // h)
        tree = {
            f"Block_{i}": {
                "cache_index": torch.zeros(batch, dtype=torch.int32, device=dev),
                "cached_key": torch.zeros(shape, dtype=self.compute_dtype, device=dev),
                "cached_value": torch.zeros(shape, dtype=self.compute_dtype, device=dev),
            }
            for i in range(self.num_layers)
        }
        tree["pos_index"] = torch.zeros(batch, dtype=torch.int32, device=dev)
        return tree

    @property
    def _head_operand_dtype(self):
        return self.compute_dtype if self.head_dtype is None else self.head_dtype

    def head_logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """The tied head on (B, d_model) hidden rows of a ``head=False``
        run: the projection the forward ends with (float32 operands
        holding head-dtype values), so prefill and tick logits agree; the
        rows are projected ``ROW_BLOCK`` at a time, as a tick projects
        them."""
        hdt = self._head_operand_dtype
        table = params["Embed_0"]["embedding"].to(hdt).float().t()
        out = [matmul_rows(pad_rows(blk, ROW_BLOCK), table)[: blk.shape[0]]
               for blk in h.to(hdt).float().split(ROW_BLOCK)]
        return out[0] if len(out) == 1 else torch.cat(out)

    def forward(self, tokens: torch.Tensor, cache=None):
        if self.decode:
            if cache is None:
                raise ValueError("a decode model takes a cache (init_cache)")
            return self._decode(tokens, cache)
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
        if not self.head:
            return x
        hdt = self._head_operand_dtype
        table = self.Embed_0.embedding.to(hdt).float()
        return torch.matmul(x.to(hdt).float(), table.t())

    def _decode(self, tokens, cache):
        """One decode chunk: ``(B, T)`` tokens at each row's ``pos_index``
        through every block's cached attention; returns ``(out, cache)``.
        A tick runs its rows ``ROW_BLOCK`` at a time, a longer chunk one row
        at a time (the module docstring says why)."""
        b, t = tokens.shape
        if t == 1:
            spans = [(s, min(s + ROW_BLOCK, b)) for s in range(0, b, ROW_BLOCK)]
            width = ROW_BLOCK
        else:
            spans, width = [(n, n + 1) for n in range(b)], 1
        outs = [self._decode_rows(tokens[s:e], _cache_rows(cache, s, e), width)
                for s, e in spans]
        new = {"pos_index": cache["pos_index"] + t}
        for i in range(self.num_layers):
            name = f"Block_{i}"
            new[name] = dict(cache[name], cache_index=cache[name]["cache_index"] + t)
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), new

    def _decode_rows(self, tokens, cache, width: int):
        """The decode chunk of N <= ``width`` rows, run as ``width`` rows (the
        pad rows are token 0 at position 0); returns the N rows' output."""
        n, t = tokens.shape
        offset = pad_rows(cache["pos_index"], width)
        steps = torch.arange(t, device=tokens.device)
        # XLA clamps the gather; a free server slot's clock runs past the end
        pos = torch.clamp(offset.long()[:, None] + steps, 0, self.max_len - 1)
        x = (self.Embed_0(pad_rows(tokens, width))
             + self.pos_embedding[pos].to(self.compute_dtype))
        for i in range(self.num_layers):
            name = f"Block_{i}"
            x = getattr(self, name)(x, cache[name])
        x = self.LayerNorm_0(x)
        if self.head:
            hdt = self._head_operand_dtype
            table = self.Embed_0.embedding.to(hdt).float()
            x = matmul_rows(x.to(hdt).float(), table.t())
        return x[:n]
