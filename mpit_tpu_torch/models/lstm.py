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

Decode mode (``decode``, ``head=False``, ``head_logits``) and the head's
operand-dtype override (``head_dtype``) belong to the serving slice and
raise.
"""

from __future__ import annotations

import torch

from mpit_tpu_torch.comm.topology import resolve_device
from mpit_tpu_torch.models.layers import Dense, Embed, Model, OptimizedLSTMCell
from mpit_tpu_torch.models.transformer import _not_ported


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
        if decode or not head or head_dtype is not None:
            raise _not_ported("LSTMLM decode mode (decode, head=False, head_dtype)",
                              "item A10")
        device = resolve_device(device)
        dt = self.compute_dtype = compute_dtype
        self.num_layers = num_layers
        self.Embed_0 = Embed(vocab_size, embed_dim, dt, device)
        fin = embed_dim
        for i in range(num_layers):
            self.add_module(f"OptimizedLSTMCell_{i}",
                            OptimizedLSTMCell(fin, hidden, dt, device))
            fin = hidden
        self.Dense_0 = Dense(hidden, vocab_size, dt, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.Embed_0(tokens)
        for i in range(self.num_layers):
            x = getattr(self, f"OptimizedLSTMCell_{i}")(x)
        dt = self.compute_dtype
        kernel = self.Dense_0.kernel.to(dt).float()
        return x.to(dt).float() @ kernel + self.Dense_0.bias.to(dt).float()
