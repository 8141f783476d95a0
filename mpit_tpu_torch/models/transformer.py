"""Causal transformer LM, training configuration; counterpart of
``mpit_tpu/models/transformer.py`` (``Block`` and ``TransformerLM``).

A pre-LN decoder: each block is LayerNorm → bias-free qkv Dense split as
``[q | k | v]`` into ``(B, T, H, D)`` → causal attention → bias-free output
Dense → residual, then LayerNorm → Dense → ``gelu`` (tanh form, flax's
default) → Dense → residual. Token embedding plus a float32
``pos_embedding`` table cast to the compute dtype; a final LayerNorm; the
tied head returns float32 logits of the compute-dtype operands, the
reference's einsum with ``preferred_element_type=float32``, never bf16
logits (:func:`~mpit_tpu_torch.ops.products.matmul_f32`: bf16 operands on
the card's tensor cores; so are the attention scores QKᵀ).

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

A ring that spans processes (``seq_span``, set through
:meth:`TransformerLM.clone` by the trainers: this process's place on the
sp axis, ``comm/topology.py`` ``AxisSpan``): the tokens are this process's
blocks ``[start, start + count)`` of the ring's ``size``, the positional
rows are read at their global positions (the reference's ``axis_index``
offset) and ``max_len`` bounds the whole ring's length.

``remat`` recomputes each block's activations on the backward pass
(:func:`~mpit_tpu_torch.models.layers.rematerialized`, flax's ``nn.remat``);
the trainers then take the gradient with ``torch.autograd.grad``
(``parallel/common.py``).

Parameter names are flax's: ``Embed_0``, ``pos_embedding``,
``Block_i/{LayerNorm_0, Dense_0, Dense_1, LayerNorm_1, Dense_2, Dense_3}``,
``LayerNorm_0``, with or without remat.

The MoE FFN (``moe_experts > 0``, the reference's ``Block._moe``) replaces
``Dense_2``/``Dense_3`` with the leaves ``moe_router`` ``(D, E)``,
``moe_w_up`` ``(E, D, F)``, ``moe_b_up`` ``(E, F)``, ``moe_w_down`` ``(E,
F, D)`` and ``moe_b_down`` ``(E, D)``. With ``moe_axis=None`` the block
runs :func:`~mpit_tpu_torch.ops.moe.moe_ffn_dense_reference` on all the
tokens; with ``moe_axis`` set (the expert-parallel trainer) the model takes
the stacked workers ``(W, b, T)`` → ``(W, b, T, vocab)`` and each block runs
:func:`~mpit_tpu_torch.ops.moe.moe_ffn`, each worker routing its own
tokens. flax's ``sow("moe_losses")`` becomes an explicit return:
``apply(params, x, with_aux=True)`` gives ``(logits, {"Block_i":
{"balance", "zloss", "dropped_frac"}})``, and :func:`aggregate_moe_losses`
averages it over the blocks.

``tp`` (set by the tensor-parallel trainers and ``generate_tp`` through
:meth:`TransformerLM.clone`): the params stay whole, and the row-parallel
products of the Megatron split (``Dense_1`` and ``Dense_3``, whose kernels
``parallel/tensor.py`` shards on their input dim) are computed as the sum,
in shard order, of ``x[..., shard_i] @ kernel[shard_i]`` (the psum GSPMD
inserts), the bias added after it. Every other product is one product.
With tp spanning processes (``tp_span``), a process computes only its
shards: the qkv columns of its heads, their attention and its rows of
``Dense_1``; its columns of ``Dense_2`` and its rows of ``Dense_3``. The
row-parallel partial products are gathered over the tp processes
(``comm.collectives.line_gather``) and summed in shard order, then the
bias, so the sum's order is the stacked path's for any tp; the input of a
column-parallel product goes through Megatron's "f"
(``comm.collectives.line_sum_grad``), whose backward sums its gradient
over the tp processes, so the LayerNorms, the embeddings and every
earlier block get every shard's share. The params stay whole in each
process; a sharded leaf's gradient there holds its shards' part only.

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

from mpit_tpu_torch.comm.collectives import line_gather, line_sum_grad
from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    ROW_BLOCK, Dense, Embed, LayerNorm, Model, matmul_rows, pad_rows, rematerialized,
    reset_children,
)
from mpit_tpu_torch.models.layers import lecun_normal_
from mpit_tpu_torch.ops.flash_attention import flash_attention
from mpit_tpu_torch.ops.moe import moe_ffn, moe_ffn_dense_reference
from mpit_tpu_torch.ops.products import matmul_f32
from mpit_tpu_torch.ops.ring_attention import dense_attention, ring_attention
from mpit_tpu_torch.ops.ulysses import ulysses_attention

ATTN_IMPLS = ("xla", "flash", "flash_force")
SEQ_IMPLS = ("ring", "ulysses")


MOE_LEAVES = ("moe_router", "moe_w_up", "moe_b_up", "moe_w_down", "moe_b_down")


class Block(nn.Module):
    def __init__(self, d_model: int, num_heads: int, d_ff: int, compute_dtype,
                 attn_impl: str, device, seq_axis=None, seq_impl: str = "ring",
                 moe_experts: int = 0, moe_capacity_factor: float = 2.0,
                 moe_top_k: int = 1):
        super().__init__()
        dt = compute_dtype
        self.num_heads = num_heads
        self.attn_impl = attn_impl
        self.seq_axis, self.seq_impl = seq_axis, seq_impl
        self.moe_experts = moe_experts
        self.moe_capacity_factor, self.moe_top_k = moe_capacity_factor, moe_top_k
        self.LayerNorm_0 = LayerNorm(d_model, dt, device)
        self.Dense_0 = Dense(d_model, 3 * d_model, dt, device, use_bias=False)
        self.Dense_1 = Dense(d_model, d_model, dt, device, use_bias=False)
        self.LayerNorm_1 = LayerNorm(d_model, dt, device)
        if moe_experts:
            e, f = moe_experts, d_ff
            self.moe_router = nn.Parameter(torch.zeros(d_model, e, device=device))
            self.moe_w_up = nn.Parameter(torch.zeros(e, d_model, f, device=device))
            self.moe_b_up = nn.Parameter(torch.zeros(e, f, device=device))
            self.moe_w_down = nn.Parameter(torch.zeros(e, f, d_model, device=device))
            self.moe_b_down = nn.Parameter(torch.zeros(e, d_model, device=device))
        else:
            self.Dense_2 = Dense(d_model, d_ff, dt, device)
            self.Dense_3 = Dense(d_ff, d_model, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)
        if self.moe_experts:
            # lecun-normal router; the experts' dim is a batch axis of the
            # init (fan_in = the kernel's input dim), as in the reference
            lecun_normal_(self.moe_router, self.moe_router.shape[0], generator)
            lecun_normal_(self.moe_w_up, self.moe_w_up.shape[1], generator)
            lecun_normal_(self.moe_w_down, self.moe_w_down.shape[1], generator)
            with torch.no_grad():
                self.moe_b_up.zero_()
                self.moe_b_down.zero_()

    def forward(self, x, cache=None, tp: int = 1, moe_axis=None, seq_span=None,
                tp_span=None):
        """``x`` is ``(B, T, d_model)``, the stacked ring ``(sp, B, T_l,
        d_model)`` with ``seq_axis`` set, or the stacked workers ``(W, b,
        T, d_model)`` with ``moe_axis`` set. With ``cache`` (this block's
        ``cached_key``, ``cached_value``, ``cache_index`` for the first of
        ``x``'s rows; the rest are pad rows) the block runs a decode chunk,
        writing the chunk's K/V into the cache in place. An MoE block
        returns ``(x, aux)``. ``seq_span`` and ``tp_span`` place a ring
        and the tp shards that span processes."""
        if cache is not None:
            return self._decode(x, cache, tp)
        d_model, h = x.shape[-1], self.num_heads
        qkv = column_parallel(self.Dense_0, self.LayerNorm_0(x), tp, tp_span, parts=3)
        q, k, v = (a.reshape(*x.shape[:-1], -1, d_model // h)
                   for a in qkv.split(qkv.shape[-1] // 3, -1))
        if self.seq_axis is not None and self.seq_impl == "ulysses":
            att = ulysses_attention(q, k, v, causal=True, axis_name=self.seq_axis,
                                    span=seq_span)
        elif self.seq_axis is not None:
            att = ring_attention(q, k, v, causal=True, span=seq_span)
        else:
            # the stacked workers (W, b, ...) attend as one batch of W·b rows
            q, k, v = (a.reshape(-1, *a.shape[-3:]) for a in (q, k, v))
            if self.attn_impl == "xla":
                att = dense_attention(q, k, v, causal=True)
            else:
                att = flash_attention(
                    q, k, v, causal=True,
                    use_kernel=True if self.attn_impl == "flash_force" else None,
                )
        x = x + row_parallel(self.Dense_1, att.reshape(*x.shape[:-1], -1), tp,
                             span=tp_span)
        y = self.LayerNorm_1(x)
        if self.moe_experts:
            out, aux = self._moe(y, moe_axis)
            return x + out, aux
        y = F.gelu(column_parallel(self.Dense_2, y, tp, tp_span), approximate="tanh")
        return x + row_parallel(self.Dense_3, y, tp, span=tp_span)

    def _moe(self, y, moe_axis):
        """The GShard MoE FFN (``mpit_tpu.ops.moe``): the dense reference
        over all of ``y``'s tokens when ``moe_axis`` is None, else the
        expert-parallel op over the stacked workers. Returns ``(out, aux)``."""
        params = {name.removeprefix("moe_"): getattr(self, name) for name in MOE_LEAVES}
        kw = dict(capacity_factor=self.moe_capacity_factor, top_k=self.moe_top_k,
                  with_aux=True)
        if moe_axis is not None:
            return moe_ffn(params, y, axis=moe_axis, **kw)
        return moe_ffn_dense_reference(params, y, **kw)

    def _decode(self, x, cache, tp: int = 1):
        d_model, h = x.shape[-1], self.num_heads
        qkv = _dense(self.Dense_0, self.LayerNorm_0(x))
        q, k, v = (a.reshape(*x.shape[:-1], h, d_model // h)
                   for a in qkv.split(d_model, -1))
        att = _cached_attention(q, k, v, cache)
        x = x + row_parallel(self.Dense_1, att.reshape(x.shape), tp, matmul_rows)
        y = F.gelu(_dense(self.Dense_2, self.LayerNorm_1(x)), approximate="tanh")
        return x + row_parallel(self.Dense_3, y, tp, matmul_rows)


def _dense(layer: Dense, x):
    """``layer(x)`` with its product through :func:`matmul_rows`."""
    y = matmul_rows(x, layer.kernel.to(layer.dtype))
    return y if layer.bias is None else y + layer.bias.to(layer.dtype)


def _shards(span, tp: int) -> tuple:
    """``(first, count)`` of the ``tp`` shards this process computes: all of
    them unless ``span`` (the tp axis's ``AxisSpan``) spans processes."""
    return (0, tp) if span is None or span.local else (span.start, span.count)


def column_parallel(layer: Dense, x, tp: int, span=None, parts: int = 1):
    """``layer(x)``, or with the ``tp`` shards over processes (``span``)
    this process's shards' columns of each of the kernel's ``parts`` equal
    column blocks (q, k and v for ``Dense_0``), its input through
    Megatron's "f" (the backward sums its gradient over the tp processes)."""
    first, count = _shards(span, tp)
    if count == tp:
        return layer(x)
    width = layer.kernel.shape[1] // parts
    n = width // tp
    cols = [slice(p * width + first * n, p * width + (first + count) * n)
            for p in range(parts)]
    y = line_sum_grad(x, span) @ torch.cat([layer.kernel[:, c] for c in cols], 1).to(
        layer.dtype)
    if layer.bias is None:
        return y
    return y + torch.cat([layer.bias[c] for c in cols]).to(layer.dtype)


def row_parallel(layer: Dense, x, tp: int, matmul=torch.matmul, span=None):
    """``layer(x)`` as the tensor-parallel row split computes it: the sum in
    shard order of ``x[..., shard_i] @ kernel[shard_i]`` over ``tp`` shards
    of the kernel's input dim, then the bias (what GSPMD's psum gives).
    ``tp = 1`` is one product. With the shards over processes (``span``)
    ``x`` holds this process's shards' slice of the input; their partial
    products are gathered over the tp processes before the sum, so its
    order is the same for any split."""
    kernel = layer.kernel.to(layer.dtype)
    if tp == 1:
        y = matmul(x, kernel)
    else:
        n = kernel.shape[0] // tp
        first, count = _shards(span, tp)
        parts = (matmul(x[..., j * n:(j + 1) * n], kernel[(first + j) * n:(first + j + 1) * n])
                 for j in range(count))
        if count < tp:
            parts = iter(line_gather(torch.stack(list(parts)), span))
        y = next(parts)
        for part in parts:
            y = y + part
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
    keys, values = pad_rows(ck, w), pad_rows(cv.float(), w)
    s = matmul_rows(q.permute(0, 2, 1, 3), keys.permute(0, 2, 3, 1), matmul_f32) / (d ** 0.5)
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
    ``(sp, B, T_l)`` → ``(sp, B, T_l, vocab_size)``; with ``moe_axis`` set,
    over the stacked workers ``(W, b, T)`` → ``(W, b, T, vocab_size)``."""

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
        moe_axis=None,
        moe_capacity_factor: float = 2.0,
        moe_top_k: int = 1,
        moe_balance_weight: float = 0.0,
        moe_zloss_weight: float = 0.0,
        attn_impl: str = "xla",
        seq_impl: str = "ring",
        decode: bool = False,
        head: bool = True,
        head_dtype=None,
        tp: int = 1,
        seq_span=None,
        tp_span=None,
        device=None,
    ):
        super().__init__()
        if seq_impl not in SEQ_IMPLS:
            raise ValueError(
                f"seq_impl={seq_impl!r} must be 'ring' or 'ulysses'"
            )
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
        self.moe_experts, self.moe_axis = moe_experts, moe_axis
        self.moe_capacity_factor, self.moe_top_k = moe_capacity_factor, moe_top_k
        self.moe_balance_weight = moe_balance_weight
        self.moe_zloss_weight = moe_zloss_weight
        self.decode, self.head, self.head_dtype = decode, head, head_dtype
        self.tp = tp
        self.seq_span, self.tp_span = seq_span, tp_span
        self._check_settings()
        self.Embed_0 = Embed(vocab_size, d_model, dt, device)
        self.pos_embedding = nn.Parameter(torch.zeros(max_len, d_model, device=device))
        for i in range(num_layers):
            setattr(self, f"Block_{i}",
                    Block(d_model, num_heads, self.d_ff, dt, attn_impl, device,
                          seq_axis, seq_impl, moe_experts, moe_capacity_factor,
                          moe_top_k))
        self.LayerNorm_0 = LayerNorm(d_model, dt, device)

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_children(self, generator)
        draw = torch.randn(self.pos_embedding.shape, generator=generator)
        with torch.no_grad():
            self.pos_embedding.copy_(draw * 0.02)

    _CLONE_FIELDS = ("decode", "head", "head_dtype", "tp", "moe_axis", "seq_span",
                     "tp_span")

    def _check_settings(self) -> None:
        if self.decode and self.seq_axis is not None:
            raise ValueError("decode mode requires seq_axis=None")
        if self.decode and self.moe_experts:
            raise ValueError(
                "decode mode is single-device dense-FFN only "
                "(seq_axis=None, moe_experts=0)"
            )
        if self.moe_axis is not None and self.seq_axis is not None:
            raise ValueError(
                "the port stacks one mesh axis on the model's input: "
                "moe_axis and seq_axis cannot both be set"
            )

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
        run: the projection the forward ends with (head-dtype operands,
        float32 result), so prefill and tick logits agree; the
        rows are projected ``ROW_BLOCK`` at a time, as a tick projects
        them."""
        hdt = self._head_operand_dtype
        table = params["Embed_0"]["embedding"].to(hdt).t()
        out = [matmul_rows(pad_rows(blk, ROW_BLOCK), table, matmul_f32)[: blk.shape[0]]
               for blk in h.to(hdt).split(ROW_BLOCK)]
        return out[0] if len(out) == 1 else torch.cat(out)

    def forward(self, tokens: torch.Tensor, cache=None, with_aux: bool = False):
        """Logits; with ``with_aux`` (an MoE model) ``(logits, {"Block_i":
        aux})``, the reference's ``moe_losses`` collection."""
        if self.decode:
            if cache is None:
                raise ValueError("a decode model takes a cache (init_cache)")
            return self._decode(tokens, cache)
        t_local = tokens.shape[-1]
        sp = tokens.shape[0] if self.seq_axis is not None else 1
        # this process's blocks [start, start + sp) of a ring of `size`
        span = self.seq_span if self.seq_axis is not None else None
        size, start = (sp, 0) if span is None else (span.size, span.start)
        total_len = t_local * size
        if total_len > self.max_len:
            raise ValueError(
                f"sequence of {total_len} exceeds max_len={self.max_len}"
            )
        pos = self.pos_embedding[start * t_local:(start + sp) * t_local]
        if self.seq_axis is not None:
            # block r of the ring holds global positions [r·T_l, (r+1)·T_l)
            pos = pos.reshape(sp, 1, t_local, -1)
        x = self.Embed_0(tokens) + pos.to(self.compute_dtype)
        kw = dict(tp=self.tp, moe_axis=self.moe_axis)
        if span is not None:
            kw["seq_span"] = span
        if self.tp_span is not None:
            kw["tp_span"] = self.tp_span
        aux = {}
        for i in range(self.num_layers):
            block = getattr(self, f"Block_{i}")
            x = rematerialized(block, x, **kw) if self.remat else block(x, **kw)
            if self.moe_experts:
                x, aux[f"Block_{i}"] = x
        x = self.LayerNorm_0(x)
        if self.head:
            hdt = self._head_operand_dtype
            x = matmul_f32(x.to(hdt), self.Embed_0.embedding.to(hdt).t())
        return (x, aux) if with_aux else x

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
            x = getattr(self, name)(x, cache[name], tp=self.tp)
        x = self.LayerNorm_0(x)
        if self.head:
            hdt = self._head_operand_dtype
            x = matmul_rows(x.to(hdt), self.Embed_0.embedding.to(hdt).t(), matmul_f32)
        return x[:n]


def aggregate_moe_losses(collection: dict) -> dict:
    """Mean each MoE stat over the blocks that returned it: ``{"Block_i":
    {name: scalar}}`` (``apply(..., with_aux=True)``'s second output) →
    ``{name: scalar}``."""
    per_name: dict = {}
    for block_vals in collection.values():
        for name, val in block_vals.items():
            per_name.setdefault(name, []).append(val)
    return {name: sum(vals) / len(vals) for name, vals in per_name.items()}
