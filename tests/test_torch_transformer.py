"""The port's transformer LM against the flax model, on the CPU.

The reference's initial params carried across with ``convert.from_flax``
give the same logits and the same loss gradients, from numpy tokens made
with a seed, for ``attn_impl="xla"`` and ``"flash"`` (the JAX side runs
``flash_force``: its Pallas kernels in interpret mode; the port side runs
its kernels' plain versions through the same autograd.Function).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from jax.flatten_util import ravel_pytree

from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel.common import cross_entropy_loss as jax_xent
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import LeNet, TransformerLM
from mpit_tpu_torch.models.layers import LayerNorm
from mpit_tpu_torch.parallel.common import cross_entropy_loss
from mpit_tpu_torch.utils.params import flatten_params, tree_leaves

V, T = 31, 64
# f32: both sides compute in float32 and sum in other orders; 2e-5 as the
# reference's own flash-vs-dense model test.
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16: activations are rounded to bf16 (2^-8 relative) at every layer
# boundary, at other points in the two frameworks (XLA fuses bias adds and
# the gelu in f32 before one rounding, PyTorch rounds after each op). Two
# blocks of such roundings on logits and gradients of size O(1) move them
# by a few bf16 ulps: 5e-2 absolute covers that with room, as for LeNet.
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _tokens(seed=0, b=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, V, (b, T)).astype(np.int32),
            rng.integers(0, V, (b, T)).astype(np.int32))


def _models(jdt, tdt, impl, layers=2):
    jm = JaxLM(vocab_size=V, num_layers=layers, d_model=32, num_heads=4,
               max_len=T, compute_dtype=jdt,
               attn_impl="flash_force" if impl == "flash" else "xla")
    pm = TransformerLM(V, num_layers=layers, d_model=32, num_heads=4, max_len=T,
                       compute_dtype=tdt, attn_impl=impl, device="cpu")
    return jm, pm


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32, F32_TOL),
                                    (jnp.bfloat16, torch.bfloat16, BF16_TOL)],
                         ids=["f32", "bf16"])
def test_logits_and_grads_match_flax(impl, dtypes):
    jdt, tdt, tol = dtypes
    x, y = _tokens()
    jm, pm = _models(jdt, tdt, impl)
    params = jax.jit(jm.init)(jax.random.key(0), x)["params"]
    ref_logits = np.asarray(jax.jit(jm.apply)({"params": params}, x))
    ref_grads = jax.jit(jax.grad(
        lambda p: jax_xent(jm.apply({"params": p}, x), y)))(params)

    tparams = from_flax(jax.tree.map(np.asarray, params), device="cpu")
    logits = pm.apply(tparams, torch.from_numpy(x))
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, T, V)
    np.testing.assert_allclose(logits.detach().numpy(), ref_logits, **tol)

    grads = torch.func.grad(
        lambda p: cross_entropy_loss(pm.apply(p, torch.from_numpy(x)),
                                     torch.from_numpy(y))
    )(tparams)
    got = to_flax(grads)
    assert jax.tree.structure(got) == jax.tree.structure(ref_grads)
    for a, b in zip(jax.tree.leaves(ref_grads), jax.tree.leaves(got)):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, np.asarray(a, np.float32), **tol)


def test_flash_model_equals_xla_model():
    """attn_impl changes scheduling, never math (the reference's wiring
    test), through the plain versions on the CPU."""
    x, _ = _tokens(1)
    _, xla = _models(jnp.float32, torch.float32, "xla")
    _, flash = _models(jnp.float32, torch.float32, "flash")
    params = xla.init(torch.Generator().manual_seed(3))
    torch.testing.assert_close(flash.apply(params, torch.from_numpy(x)),
                               xla.apply(params, torch.from_numpy(x)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", [(6, 10), (2, 5, 10)], ids=["2d", "3d"])
def test_cross_entropy_matches_optax(shape):
    """The loss reduces over the LAST dim for any rank: (B, C) logits of a
    classifier and (B, T, V) logits of an LM."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=shape).astype(np.float32) * 3
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    ref = optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean()
    got = cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_layernorm_matches_flax_bf16():
    """eps 1e-6, f32 statistics with the fast variance, output in bf16."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=(4, 7, 48)) * 3 + 1).astype(np.float32)
    scale = rng.normal(size=48).astype(np.float32)
    bias = rng.normal(size=48).astype(np.float32)
    ln = fnn.LayerNorm(dtype=jnp.bfloat16)
    ref = ln.apply({"params": {"scale": scale, "bias": bias}},
                   jnp.asarray(x, jnp.bfloat16))
    mine = LayerNorm(48, torch.bfloat16, "cpu")
    out = torch.func.functional_call(
        mine, {"scale": torch.from_numpy(scale), "bias": torch.from_numpy(bias)},
        (torch.from_numpy(x).to(torch.bfloat16),))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                               rtol=8e-3, atol=8e-3)  # one bf16 rounding


def test_param_tree_names_shapes_and_init_mirror_flax():
    x, _ = _tokens()
    jm, pm = _models(jnp.float32, torch.float32, "xla")
    ref = jax.eval_shape(jm.init, jax.random.key(0), x)["params"]
    mine = to_flax(pm.init(torch.Generator().manual_seed(0)))
    assert jax.tree.structure(mine) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(mine)):
        assert a.shape == b.shape
    blk = mine["Block_0"]
    assert sorted(blk) == ["Dense_0", "Dense_1", "Dense_2", "Dense_3",
                           "LayerNorm_0", "LayerNorm_1"]
    assert "bias" not in blk["Dense_0"] and "bias" not in blk["Dense_1"]
    assert (blk["LayerNorm_0"]["scale"] == 1).all() and not blk["Dense_2"]["bias"].any()
    emb = mine["Embed_0"]["embedding"]
    assert abs(emb.std() * np.sqrt(32) - 1) < 0.1  # variance 1 / features
    assert abs(mine["pos_embedding"].std() / 0.02 - 1) < 0.1
    again = to_flax(pm.init(torch.Generator().manual_seed(0)))
    for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


def test_convert_round_trip_is_exact_in_ravel_pytree_order():
    x, _ = _tokens()
    jm, _ = _models(jnp.float32, torch.float32, "xla")
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.key(1), x)["params"])
    t = from_flax(params, device="cpu")
    back = to_flax(t)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    flat, _ = flatten_params(t)
    ref_flat, _ = ravel_pytree(params)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(ref_flat))
    assert len(tree_leaves(t)) == len(jax.tree.leaves(params)) == 2 + 2 + 2 * 10


def test_apply_takes_trees_of_any_depth():
    """Model.apply flattens the whole tree to functional_call's names: a
    three-level transformer tree plus a top-level leaf, and LeNet's two."""
    _, pm = _models(jnp.float32, torch.float32, "xla", layers=1)
    params = pm.init(torch.Generator().manual_seed(1))
    assert params["Block_0"]["Dense_2"]["kernel"].shape == (32, 128)
    x, _ = _tokens()
    shifted = dict(params, pos_embedding=params["pos_embedding"] + 1.0)
    a = pm.apply(params, torch.from_numpy(x))
    b = pm.apply(shifted, torch.from_numpy(x))
    assert not torch.allclose(a, b)  # the top-level leaf is used
    lenet = LeNet(compute_dtype=torch.float32, device="cpu")
    lp = lenet.init(torch.Generator().manual_seed(0))
    assert sorted(lp) == ["Conv_0", "Conv_1", "Dense_0", "Dense_1"]
    img = torch.zeros(2, 28, 28, 1)
    torch.testing.assert_close(lenet.apply(lp, img), lenet(img))


@pytest.mark.parametrize("kwargs,err", [
    (dict(seq_impl="allgather"), ValueError),
    (dict(seq_axis="sp", seq_impl="Ring"), ValueError),
    (dict(moe_experts=4), NotImplementedError),
    (dict(decode=True, seq_axis="sp"), ValueError),
    (dict(attn_impl="ring"), ValueError),
    (dict(num_heads=5), ValueError),
])
def test_refuses_what_is_not_ported(kwargs, err):
    with pytest.raises(err):
        TransformerLM(V, **{"num_heads": 4, **kwargs}, device="cpu")


def test_flash_force_raises_on_the_cpu():
    x, _ = _tokens()
    pm = TransformerLM(V, num_layers=1, d_model=32, num_heads=4, max_len=T,
                       attn_impl="flash_force", device="cpu")
    with pytest.raises(ValueError, match="not CUDA"):
        pm.apply(pm.init(torch.Generator().manual_seed(0)), torch.from_numpy(x))
