"""Products of bf16 operands with a float32 result: the reference's
``dot_general`` / ``einsum`` with ``preferred_element_type=jnp.float32``
where both operands are in the compute dtype (the tied vocab head, the
LSTM's vocab head, the attention scores QKᵀ, in training and in decode).

The reference computes these outside any Pallas kernel, so the card's route
is a library GEMM: cuBLAS with bf16 inputs, float32 accumulation and a
float32 output, reached through ``torch.mm`` / ``torch.bmm`` with
``out_dtype=torch.float32``. TF32 plays no part (its flag is PyTorch's
default, off). The backward is the reference's VJP, which multiplies the
float32 cotangent by the other operand into float32 and rounds each
gradient to its operand's dtype: here the other operand widened to float32
and an f32 × f32 product, as the port computed it before the forward moved
to the tensor cores.
"""

from __future__ import annotations

import torch


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the reference's ``dot_general`` with
    ``preferred_element_type=float32``: the float32 result of the operands'
    products. Two bf16 operands on the card take the tensor cores
    (:class:`Bf16Product`); anything else (the CPU, an f32 operand) is
    ``a.float() @ b.float()``: for bf16 operands the same exact products
    (bf16 × bf16 is exact in float32), summed in float32 in another order. ``b``
    (K, N) with ``a`` (..., K), or ``b`` (..., K, N) with ``a`` (..., M,
    K) over the same leading dims."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return Bf16Product.apply(a, b)
    return a.float() @ b.float()


def _bf16_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The float32 product of two bf16 operands laid out as
    :func:`matmul_f32` takes them: on the card one cuBLAS GEMM with bf16
    inputs, float32 accumulation and a float32 output (``torch.mm`` /
    ``torch.bmm`` with ``out_dtype``); on the CPU its plain version, the
    widened product."""
    if not a.is_cuda:
        return a.float() @ b.float()
    k, n = b.shape[-2:]
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, k), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], n)
    lead, m = a.shape[:-2], a.shape[-2]
    out = torch.bmm(a.reshape(-1, m, k), b.reshape(-1, k, n), out_dtype=torch.float32)
    return out.reshape(*lead, m, n)


class Bf16Product(torch.autograd.Function):
    """:func:`matmul_f32`'s card route: the forward multiplies the bf16
    operands into float32 (:func:`_bf16_mm`); the backward is the
    reference's VJP of that ``dot_general``, the float32 cotangent times
    the other operand widened to float32, each gradient rounded to its
    operand's dtype. In the form ``torch.func`` takes, with a ``vmap``
    rule that folds the mapped dim into the GEMM (a trainer's stacked
    workers)."""

    @staticmethod
    def forward(a, b):
        return _bf16_mm(a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        grad_a = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_a = (g @ b.float().mT).to(a.dtype)
        if ctx.needs_input_grad[1]:
            if b.dim() == 2:
                rows = a.reshape(-1, a.shape[-1]).float()
                grad_b = (rows.t() @ g.reshape(-1, g.shape[-1])).to(b.dtype)
            else:
                grad_b = (a.float().mT @ g).to(b.dtype)
        return grad_a, grad_b

    @staticmethod
    def vmap(info, in_dims, a, b):
        n = info.batch_size
        a_dim, b_dim = in_dims
        a = a.expand(n, *a.shape) if a_dim is None else a.movedim(a_dim, 0)
        if b_dim is None and b.dim() == 2:
            # one (K, N) for every entry: the entries' rows stack
            return Bf16Product.apply(a, b), 0
        b = b.expand(n, *b.shape) if b_dim is None else b.movedim(b_dim, 0)
        if b.dim() == 3:
            # a (K, N) of each entry: the entry's rows as one matrix
            rows = a.reshape(n, -1, a.shape[-1])
            return Bf16Product.apply(rows, b).reshape(*a.shape[:-1], b.shape[-1]), 0
        return Bf16Product.apply(a, b), 0
