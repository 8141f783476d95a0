"""The port's LeNet and MLP against the flax models: the reference's initial
params carried across with ``convert.from_flax`` give the same logits and
the same loss gradients, on the CPU, from numpy inputs made with a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu.models import MLP as JaxMLP
from mpit_tpu.models import LeNet as JaxLeNet
from mpit_tpu.parallel.common import cross_entropy_loss as jax_xent
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import MLP, LeNet
from mpit_tpu_torch.parallel.common import cross_entropy_loss

# f32: both sides compute in float32; convolutions and matmuls sum in
# different orders, which moves the last bits of values O(1).
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: activations and weights are rounded to bf16 (8 mantissa bits,
# 2^-8 relative) at every layer boundary, and the two frameworks round at
# different points (XLA may keep a fused conv+bias in f32, PyTorch adds
# the bias in bf16). Four layers of such roundings on logits of size O(1)
# give differences of a few bf16 ulps: 5e-2 absolute covers that with room.
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _cases():
    return [
        ("lenet", lambda dt: JaxLeNet(compute_dtype=dt),
         lambda dt: LeNet(compute_dtype=dt, device="cpu"), (28, 28, 1)),
        ("mlp", lambda dt: JaxMLP(hidden=(32, 16), compute_dtype=dt),
         lambda dt: MLP(hidden=(32, 16), compute_dtype=dt, in_shape=(8, 8, 1),
                        device="cpu"), (8, 8, 1)),
    ]


def _data(shape, seed=0, n=6):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, *shape)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("case", _cases(), ids=lambda c: c[0])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32, F32_TOL),
                                    (jnp.bfloat16, torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_logits_and_grads_match_flax(case, dtypes):
    _, make_jax, make_port, shape = case
    jdt, tdt, tol = dtypes
    x, y = _data(shape)
    jm = make_jax(jdt)
    params = jax.jit(jm.init)(jax.random.key(0), jnp.asarray(x[:2]))["params"]

    def jloss(p):
        return jax_xent(jm.apply({"params": p}, x), y)

    ref_logits = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    ref_grads = jax.jit(jax.grad(jloss))(params)

    pm = make_port(tdt)
    tparams = from_flax(jax.tree.map(np.asarray, params), device="cpu")
    logits = pm.apply(tparams, torch.from_numpy(x))
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, **tol)

    grads, _ = torch.func.grad_and_value(
        lambda p: cross_entropy_loss(pm.apply(p, torch.from_numpy(x)),
                                     torch.from_numpy(y))
    )(tparams)
    got = to_flax(grads)
    assert jax.tree.structure(got) == jax.tree.structure(ref_grads)
    for a, b in zip(jax.tree.leaves(ref_grads), jax.tree.leaves(got)):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, np.asarray(a, dtype=np.float32), **tol)


def test_convert_round_trip_and_layouts():
    shapes = jax.eval_shape(
        JaxLeNet().init, jax.random.key(1), jnp.zeros((1, 28, 28, 1))
    )["params"]
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda s: rng.normal(size=s.shape).astype(np.float32), shapes
    )
    t = from_flax(params, device="cpu")
    assert tuple(t["Conv_0"]["kernel"].shape) == (32, 1, 5, 5)  # OIHW
    assert tuple(t["Dense_0"]["kernel"].shape) == (3136, 256)   # (in, out)
    back = to_flax(t)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model", ["lenet", "mlp"])
def test_own_init_mirrors_flax_statistics(model):
    """The port's init draws its own numbers (torch.Generator), so it is
    held to flax's by distribution: same tree and shapes, zero biases,
    kernels truncated at 2 sigma with std sqrt(1/fan_in)."""
    if model == "lenet":
        jm, pm, x0 = JaxLeNet(), LeNet(device="cpu"), jnp.zeros((1, 28, 28, 1))
    else:
        jm, pm = JaxMLP(), MLP(device="cpu")
        x0 = jnp.zeros((1, 28, 28, 1))
    ref = jax.eval_shape(jm.init, jax.random.key(0), x0)["params"]
    mine = to_flax(pm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for layer in mine:
        assert not mine[layer]["bias"].any()
        k = mine[layer]["kernel"]
        assert k.shape == ref[layer]["kernel"].shape
        fan_in = int(np.prod(k.shape[:-1]))
        std = np.sqrt(1.0 / fan_in)
        assert np.abs(k).max() <= 2 * std / 0.87962566103423978 + 1e-7
        if k.size >= 10_000:
            assert abs(k.std() / std - 1) < 0.05
    again = to_flax(pm.init(torch.Generator().manual_seed(0)))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
