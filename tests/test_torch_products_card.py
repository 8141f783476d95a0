"""The card route of ``mpit_tpu_torch/ops/products.py``: bf16 operands
multiplied into float32 on the tensor cores (cuBLAS through ``torch.mm`` /
``torch.bmm`` with ``out_dtype``), at the contractions the models run (the
tied vocab head, the LSTM's head, dense and ring QKᵀ, the decode rows).

On a CUDA card (skipped without one), each against the plain route on the
same card with TF32 off, ``a.float() @ b.float()``:

- the forward within the bound of two float32 sums of the same exact
  products in two orders, elementwise ``K · 2⁻²⁴ · (|a| · |b|) + 1e-30``;
- the gradients for one cotangent within one bf16 ulp, plus the summation
  bound of their own product, of autograd's through the plain route (the
  same float32 products, rounded to bf16);
- under ``torch.func.vmap(grad_and_value)`` over 3 stacked workers, with
  no per-worker fallback of functorch, within those limits of each
  worker's plain call;
- a captured CUDA graph of forward and backward replays bit-equal to the
  eager call; a bf16 transformer with ``remat`` gives the gradients of
  the same model without it, bit for bit.

The file imports nothing of JAX, so it runs on a machine without it::

    python -m pytest --noconftest tests/test_torch_products_card.py -q
"""

import warnings

import numpy as np
import pytest
import torch

from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.models.layers import matmul_rows
from mpit_tpu_torch.ops.products import matmul_f32
from mpit_tpu_torch.parallel.capture import capture_graph

W = 3
ULP_BF16 = 2.0 ** -7  # a bf16 value's spacing relative to its magnitude, at most


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False


def _bf16(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).bfloat16().cuda()


def _operands(site: str, rng):
    """(a, b) of ``site`` as the model hands them to ``matmul_f32``."""
    if site == "head":  # (B, T, d) × tableᵀ, the table (V, d)
        return _bf16(rng, 2, 64, 96), _bf16(rng, 1000, 96).t()
    if site == "lstm":  # (B, T, H) × kernel (H, V)
        return _bf16(rng, 4, 16, 64), _bf16(rng, 64, 500)
    if site == "dense":  # q (B, T, H, D), k alike
        q, k = _bf16(rng, 2, 64, 4, 32), _bf16(rng, 2, 64, 4, 32)
        return q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)
    if site == "ring":  # one ring block (sp, B, T_l, H, D)
        q, k = _bf16(rng, 4, 2, 16, 4, 32), _bf16(rng, 4, 2, 16, 4, 32)
        return q.permute(0, 1, 3, 2, 4), k.permute(0, 1, 3, 4, 2)
    raise ValueError(site)


SITES = ("head", "lstm", "dense", "ring")


def _bound(a, b):
    return a.shape[-1] * 2.0 ** -24 * (a.float().abs() @ b.float().abs()) + 1e-30


def _plain(a, b):
    return a.float() @ b.float()


def _within_ulp(got, want, slack=0.0):
    """Two bf16 roundings of float32 values at most ``slack`` apart."""
    gap = (got.float() - want.float()).abs()
    ulp = ULP_BF16 * torch.maximum(got.float().abs(), want.float().abs())
    return bool((gap <= ulp + slack).all())


@pytest.mark.parametrize("site", SITES)
def test_card_route_within_the_summation_bound(site):
    _need_card()
    a, b = _operands(site, np.random.default_rng(0))
    out = matmul_f32(a, b)
    assert out.dtype == torch.float32 and out.shape == _plain(a, b).shape
    a_grad = a.detach().requires_grad_(True)
    assert type(matmul_f32(a_grad, b).grad_fn).__name__ == "Bf16ProductBackward"
    assert bool(((out - _plain(a, b)).abs() <= _bound(a, b)).all())


def test_decode_rows_take_the_card_route_in_their_row_blocks():
    _need_card()
    rng = np.random.default_rng(1)
    x, table = _bf16(rng, 5, 1, 96), _bf16(rng, 1000, 96).t()
    out = matmul_rows(x, table, matmul_f32)
    assert bool(((out - _plain(x, table)).abs() <= _bound(x, table)).all())
    # a row's logits do not depend on the rows beside it
    alone = matmul_rows(x[:1], table, matmul_f32)
    assert torch.equal(alone[0], out[0])
    q, keys = _bf16(rng, 8, 4, 1, 32), _bf16(rng, 8, 4, 32, 64)
    s = matmul_rows(q, keys, matmul_f32)
    assert bool(((s - _plain(q, keys)).abs() <= _bound(q, keys)).all())


@pytest.mark.parametrize("site", SITES)
def test_card_gradients_are_the_reference_vjp(site):
    _need_card()
    rng = np.random.default_rng(2)
    a, b = _operands(site, rng)
    a, b = a.detach().requires_grad_(True), b.detach().requires_grad_(True)
    ct = torch.from_numpy(rng.standard_normal(_plain(a, b).shape).astype(np.float32)).cuda()
    got = torch.autograd.grad(matmul_f32(a, b), (a, b), ct)
    want = torch.autograd.grad(_plain(a, b), (a, b), ct)
    # each gradient a float32 product of the cotangent and the other operand
    a_, b_ = a.detach(), b.detach()
    if b_.dim() == 2:
        a_, ct = a_.reshape(-1, a_.shape[-1]), ct.reshape(-1, ct.shape[-1])
    slacks = (_bound(ct, b_.mT).reshape(a.shape), _bound(a_.mT, ct))
    for g, w, slack in zip(got, want, slacks):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _within_ulp(g, w, slack)


def test_card_route_under_vmap_grad_and_value():
    _need_card()
    rng = np.random.default_rng(3)
    xs = _bf16(rng, W, 4, 16, 64)
    ks = torch.from_numpy(rng.standard_normal((W, 64, 500)).astype(np.float32)).cuda()
    cts = torch.from_numpy(rng.standard_normal((W, 4, 16, 500)).astype(np.float32)).cuda()

    def step(mm):
        # linear in the logits: the kernel's gradient is the VJP of ``ct``
        def loss(k, x, ct):
            logits = mm(x, k.bfloat16())
            return (logits * ct).sum(), logits
        return torch.func.grad_and_value(loss, has_aux=True)

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        grads, (_, logits) = torch.func.vmap(step(matmul_f32))(ks, xs, cts)
    assert not [w for w in caught if "performance drop" in str(w.message)]
    for i in range(W):
        g, (_, want) = step(_plain)(ks[i], xs[i], cts[i])
        assert bool(((logits[i] - want).abs() <= _bound(xs[i], ks[i].bfloat16())).all())
        slack = _bound(xs[i].reshape(-1, 64).t(), cts[i].reshape(-1, 500))
        assert _within_ulp(grads[i], g, slack)


def test_captured_replay_equals_eager():
    _need_card()
    rng = np.random.default_rng(4)
    a, b = _operands("head", rng)
    ct = torch.from_numpy(rng.standard_normal((2, 64, 1000)).astype(np.float32)).cuda()

    def body():
        # the gradient as the trainers take it (torch.func): a leaf's
        # autograd node from an eager call would tie the capture to the
        # default stream
        out, vjp = torch.func.vjp(matmul_f32, a, b)
        return (out, *vjp(ct))

    eager = body()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()  # warm-up on the capturing stream
    torch.cuda.current_stream().wait_stream(side)
    graph, static, _ = capture_graph(side, body)
    graph.replay()
    torch.cuda.synchronize()
    for s, e in zip(static, eager):
        assert torch.equal(s, e)


def test_remat_gives_the_gradients_of_the_model_without_it():
    _need_card()
    gen = torch.Generator().manual_seed(0)
    kw = dict(vocab_size=97, num_layers=2, d_model=64, num_heads=4, d_ff=128,
              max_len=32, compute_dtype=torch.bfloat16, attn_impl="xla", device="cuda")
    model = TransformerLM(**kw)
    params = model.init(gen)
    tokens = torch.randint(0, 97, (2, 32), generator=gen).cuda()

    def loss(p, m):
        return m.apply(p, tokens).float().logsumexp(-1).mean()

    leaves = list(_leaves(params))
    plain = torch.autograd.grad(loss(params, model), leaves)
    got = torch.autograd.grad(loss(params, TransformerLM(remat=True, **kw)), leaves)
    for g, w in zip(got, plain):
        assert torch.equal(g, w)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v.requires_grad_(True)
