"""LSTM language model for the PTB EASGD config; counterpart of
``mpit_tpu/models/lstm.py`` in training mode.

Embedding → ``num_layers`` :class:`~mpit_tpu_torch.models.layers.OptimizedLSTMCell`
layers (float32 carries and outputs, gate products in ``compute_dtype``)
→ the vocab head. Takes (B, T) integer tokens, returns (B, T, V) float32
logits. The head multiplies ``compute_dtype`` operands with float32
accumulation and then adds the bias rounded to ``compute_dtype``, as the
reference's ``preferred_element_type=float32`` Dense does; here the
operands are upcast to float32 first, which gives the same numbers
(products of bf16 values are exact in float32; keep TF32 off on the card).
Not cuDNN's ``nn.LSTM``: it keeps bf16 carries and has no batching rule
for ``torch.func.vmap`` over per-worker weights.

Decode mode (``decode=True``, the serving path of
``models/rnn_sampling.py``): the model takes ``(B, T)`` tokens and a cache
tree ``{"carry_i": (c, h)}`` (flax's ``cache`` collection, each carry
(B, hidden) float32; :meth:`LSTMLM.init_cache` makes a zero one) and returns
``(out, cache)`` with every layer resumed from its stored carry.
``seq_lengths`` (B,) freezes row ``n``'s carries after its first
``seq_lengths[n]`` tokens (a padded prompt buffer prefills each row to its
own length). ``head=False`` returns the top layer's outputs (B, T, hidden)
and :meth:`LSTMLM.head_logits` projects chosen rows through the same head;
``head_dtype`` overrides the head's operand dtype. The decode products go
through :func:`~mpit_tpu_torch.models.layers.matmul_rows`, so a row decoded
alone equals the same row decoded in a batch.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import (
    Dense, Embed, Model, OptimizedLSTMCell, matmul_rows,
)


class LSTMLM(Model):
    def __init__(
        self,
        vocab_size: int = 10_000,
        embed_dim: int = 256,
        hidden: int = 512,
        num_layers: int = 2,
        compute_dtype: torch.dtype = torch.bfloat16,
        decode: bool = False,
        head: bool = True,
        head_dtype=None,
        device=None,
    ):
        super().__init__()
        device = resolve_device(device)
        dt = self.compute_dtype = compute_dtype
        self.vocab_size, self.num_layers, self.hidden = vocab_size, num_layers, hidden
        self.decode, self.head, self.head_dtype = decode, head, head_dtype
        self.Embed_0 = Embed(vocab_size, embed_dim, dt, device)
        fin = embed_dim
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            OptimizedLSTMCell(fin, hidden, dt, device))
            fin = hidden
        self.Dense_0 = Dense(hidden, vocab_size, dt, device)

    _CLONE_FIELDS = ("decode", "head", "head_dtype")

    def init_cache(self, batch: int, device=None) -> dict:
        """Zero carries for ``batch`` rows: ``{"carry_i": (c, h)}``."""
        dev = resolve_device(device)
        zero = lambda: torch.zeros(batch, self.hidden, device=dev)  # noqa: E731
        return {f"carry_{i}": (zero(), zero()) for i in range(self.num_layers)}

    @property
    def _head_operand_dtype(self):
        return self.compute_dtype if self.head_dtype is None else self.head_dtype

    def head_logits(self, params: dict, h: torch.Tensor) -> torch.Tensor:
        """The vocab head on (B, hidden) rows of a ``head=False`` run, with
        the bias rounded to the head's operand dtype before the add, as
        the forward's head adds it."""
        dt = self._head_operand_dtype
        kernel = params["Dense_0"]["kernel"].to(dt).float()
        bias = params["Dense_0"]["bias"].to(dt).float()
        return matmul_rows(h.to(dt).float(), kernel) + bias

    def forward(self, tokens: torch.Tensor, cache=None, seq_lengths=None):
        if seq_lengths is not None and not self.decode:
            raise ValueError("seq_lengths is a decode-mode argument")
        if self.decode and cache is None:
            raise ValueError("a decode model takes a cache (init_cache)")
        x = self.Embed_0(tokens)
        new = {}
        for i in range(self.num_layers):
            cell = getattr(self, f"OptimizedLSTMCell_{i}")
            if not self.decode:
                x = cell(x)
                continue
            new[f"carry_{i}"], x = cell.scan(x, cache[f"carry_{i}"], seq_lengths,
                                             matmul=matmul_rows)
        if self.head:
            dt = self._head_operand_dtype
            kernel = self.Dense_0.kernel.to(dt).float()
            bias = self.Dense_0.bias.to(dt).float()
            mm = matmul_rows if self.decode else torch.matmul
            x = mm(x.to(dt).float(), kernel) + bias
        return (x, new) if self.decode else x
