"""The bf16-operand, float32-result products (``mpit_tpu_torch/ops/products.py``)
against the reference's ``preferred_element_type=jnp.float32`` contractions,
on the CPU.

Each site's contraction as the models hand it over (the tied head
``btd,vd``, the LSTM's Dense head, dense QKᵀ ``bqhd,bkhd``, a ring block
``sbqhd,sbkhd``, the decode rows through ``matmul_rows``), on seeded numpy
inputs rounded to bf16, through ``matmul_f32`` (its plain route here) and
through ``Bf16Product``, the card route's ``autograd.Function`` (whose
product is its plain version on CPU tensors):

- the forward against ``jnp.einsum`` / ``lax.dot_general`` with
  ``preferred_element_type=jnp.float32``: float32 within 1e-6 of the
  output's scale (the same exact products, summed in another order);
- the gradients for one cotangent against ``jax.vjp`` of the same
  expression: bf16, within one bf16 ulp (the reference multiplies the f32
  cotangent into float32 and rounds, as the port does);
- the plain route bit-equal to the expression the port computed before
  (both operands widened, ``torch.einsum`` or ``@``), forward and backward;
- under ``torch.func.vmap(grad_and_value)`` over 3 stacked workers, and
  under ``rematerialized``, bit-equal to the calls without them;
- the dispatch: the plain route on the CPU and for any f32 operand.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from mpit_tpu_torch.models.layers import matmul_rows, rematerialized
from mpit_tpu_torch.ops.products import Bf16Product, matmul_f32

W = 3
F32 = jnp.float32


def _rows(mm):
    return lambda a, b: matmul_rows(a, b, mm)


# site: (operand shapes, the reference's expression, the port's call on the
# operands as the reference takes them, the port's expression before)
SITES = {
    "head": (
        [(2, 8, 32), (50, 32)],
        lambda x, t: jnp.einsum("btd,vd->btv", x, t, preferred_element_type=F32),
        lambda mm, x, t: mm(x, t.t()),
        lambda x, t: torch.matmul(x.float(), t.float().t()),
    ),
    "lstm": (
        [(2, 8, 24), (24, 40)],
        lambda x, k: lax.dot_general(x, k, (((2,), (0,)), ((), ())),
                                     preferred_element_type=F32),
        lambda mm, x, k: mm(x, k),
        lambda x, k: torch.matmul(x.float(), k.float()),
    ),
    "dense-qk": (
        [(2, 16, 4, 8), (2, 16, 4, 8)],
        lambda q, k: jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=F32),
        lambda mm, q, k: mm(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)),
        lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()),
    ),
    "ring-qk": (
        [(3, 2, 8, 4, 8), (3, 2, 8, 4, 8)],
        lambda q, k: jnp.einsum("sbqhd,sbkhd->sbhqk", q, k, preferred_element_type=F32),
        lambda mm, q, k: mm(q.permute(0, 1, 3, 2, 4), k.permute(0, 1, 3, 4, 2)),
        lambda q, k: torch.einsum("sbqhd,sbkhd->sbhqk", q.float(), k.float()),
    ),
    "decode-head": (
        [(5, 32), (50, 32)],
        lambda h, t: jnp.einsum("bd,vd->bv", h, t, preferred_element_type=F32),
        lambda mm, h, t: _rows(mm)(h, t.t()),
        lambda h, t: matmul_rows(h.float(), t.float().t()),
    ),
    "decode-qk": (
        [(8, 1, 4, 8), (8, 24, 4, 8)],
        lambda q, k: jnp.einsum("bqhd,bkhd->bhqk", q, k, preferred_element_type=F32),
        lambda mm, q, k: _rows(mm)(q.permute(0, 2, 1, 3), k.permute(0, 2, 3, 1)),
        lambda q, k: matmul_rows(q.float().permute(0, 2, 1, 3), k.float().permute(0, 2, 3, 1)),
    ),
}
ROUTES = {"matmul_f32": matmul_f32, "Bf16Product": Bf16Product.apply}


def _bf16(seed: int, shapes) -> list:
    """Seeded normal arrays rounded to bf16 (numpy f32 holding the values)."""
    rng = np.random.default_rng(seed)
    out = []
    for shape in shapes:
        a = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        out.append(a.bfloat16().float().numpy())
    return out


def _torch(arrays, requires_grad=False):
    return [torch.from_numpy(a).bfloat16().requires_grad_(requires_grad) for a in arrays]


def _jax(arrays):
    return [jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays]


def _within_ulp(got: torch.Tensor, want) -> bool:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, F32))
    ulp = 2.0 ** -7 * np.maximum(np.abs(got), np.abs(want))
    return bool((np.abs(got - want) <= ulp).all())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("site", SITES)
def test_forward_matches_the_reference(site, route):
    shapes, ref, port, _ = SITES[site]
    arrays = _bf16(0, shapes)
    want = np.asarray(ref(*_jax(arrays)))
    got = port(ROUTES[route], *_torch(arrays))
    assert got.dtype == torch.float32
    got = got.numpy().reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("site", SITES)
def test_gradients_match_the_reference_vjp(site, route):
    shapes, ref, port, _ = SITES[site]
    arrays = _bf16(1, shapes)
    out, vjp = jax.vjp(ref, *_jax(arrays))
    ct = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    ops = _torch(arrays, requires_grad=True)
    got_out = port(ROUTES[route], *ops)
    got = torch.autograd.grad(got_out, ops, torch.from_numpy(ct).reshape(got_out.shape))
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        assert tuple(g.shape) == w.shape and _within_ulp(g, w)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("site", SITES)
def test_bit_equal_to_the_widened_expression(site, route):
    shapes, _, port, before = SITES[site]
    arrays = _bf16(3, shapes)
    ops, ops_before = _torch(arrays, True), _torch(arrays, True)
    got, want = port(ROUTES[route], *ops), before(*ops_before)
    assert torch.equal(got, want)
    ct = torch.from_numpy(np.random.default_rng(4).standard_normal(
        tuple(got.shape)).astype(np.float32))
    for g, w in zip(torch.autograd.grad(got, ops, ct), torch.autograd.grad(want, ops_before, ct)):
        assert g.dtype == w.dtype == torch.bfloat16 and torch.equal(g, w)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("site", SITES)
def test_vmap_grad_and_value_over_workers_equals_per_worker_calls(site, route):
    shapes, _, port, _ = SITES[site]
    rng = np.random.default_rng(5)
    # each worker's f32 operands, rounded to bf16 inside as a model's
    # compute-dtype cast rounds its f32 params
    a, b = (torch.from_numpy(rng.standard_normal((W, *s)).astype(np.float32)) for s in shapes)
    out_shape = port(ROUTES[route], a[0].bfloat16(), b[0].bfloat16()).shape
    ct = torch.from_numpy(rng.standard_normal((W, *out_shape)).astype(np.float32))

    def loss(a, b, ct):
        out = port(ROUTES[route], a.bfloat16(), b.bfloat16())
        return (out * ct).sum() + (out ** 2).mean()

    step = torch.func.grad_and_value(loss, argnums=(0, 1))
    (ga, gb), values = torch.func.vmap(step)(a, b, ct)
    for i in range(W):
        (wa, wb), value = step(a[i], b[i], ct[i])
        assert torch.equal(ga[i], wa) and torch.equal(gb[i], wb)
        assert torch.equal(values[i], value)


class _Site(torch.nn.Module):
    """One product site as a layer: the second operand a float32 parameter
    rounded to bf16 for the product, as a model's compute-dtype cast."""

    def __init__(self, site: str, route: str, weight: torch.Tensor):
        super().__init__()
        self.site, self.route = site, route
        self.weight = torch.nn.Parameter(weight)

    def forward(self, x):
        port = SITES[self.site][2]
        return port(ROUTES[self.route], x.bfloat16(), self.weight.bfloat16()).tanh()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("site", SITES)
def test_rematerialized_equals_the_plain_call(site, route):
    shapes = SITES[site][0]
    rng = np.random.default_rng(6)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in shapes)
    layer = _Site(site, route, w)
    grads = []
    for run in (lambda xx: layer(xx), lambda xx: rematerialized(layer, xx)):
        xx = x.clone().requires_grad_(True)
        out = run(xx)
        grads.append((out, *torch.autograd.grad(out.square().sum(), (xx, layer.weight))))
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("dtypes", [(torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32),
                                    (torch.float32, torch.bfloat16),
                                    (torch.float32, torch.float32)],
                         ids=["bf16-bf16", "bf16-f32", "f32-bf16", "f32-f32"])
def test_the_plain_route_on_the_cpu_and_for_any_f32_operand(dtypes):
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.standard_normal((3, 5, 16)).astype(np.float32)).to(dtypes[0])
    b = torch.from_numpy(rng.standard_normal((16, 7)).astype(np.float32)).to(dtypes[1])
    a.requires_grad_(True)
    out = matmul_f32(a, b)
    assert type(out.grad_fn).__name__ != "Bf16ProductBackward"
    assert out.dtype == torch.float32 and torch.equal(out, a.float() @ b.float())
    # the card route's Function takes two bf16 operands, the card's dtype pair
    if dtypes == (torch.bfloat16, torch.bfloat16):
        assert type(Bf16Product.apply(a, b).grad_fn).__name__ == "Bf16ProductBackward"
