"""Rematerialization in the port (``remat=True`` on the transformer and
ResNet-50) against no remat and against flax's ``nn.remat``, and the
trainers' gradient route for it, on the CPU.

Remat only changes when activations are computed, never what is computed
(``tests/test_models.py:173-220``): the same params give the same logits
and gradients, under the same parameter names. ``torch.func``'s transforms
refuse a non-reentrant checkpoint's saved-tensor hooks, so with remat on
the trainers take the gradient with ``torch.autograd.grad``
(``parallel/common.py``); these tests hold that route to the
``torch.func`` one the trainers take without remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models.resnet import ResNet50 as JaxResNet
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.models.resnet import ResNet50
from mpit_tpu_torch.parallel import (
    DataParallelTrainer, EASGDTrainer, SeqParallelTrainer, common,
)

CPU = torch.device("cpu")
# the reference's limits for remat against no remat (tests/test_models.py:189-220):
# transformer logits 1e-6, gradients rtol 1e-5 / atol 1e-6; ResNet logits 1e-5
SAME_FN_TOL = {"transformer": dict(rtol=1e-6, atol=1e-6),
               "resnet": dict(rtol=1e-5, atol=1e-5)}
SAME_GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
# against flax, the f32 limits of tests/test_torch_transformer.py (2e-5) and
# tests/test_torch_models.py (5e-5: GroupNorm statistics and 3x3
# contractions sum in other orders); gradients per leaf in L2 norm within 1%
# (test_torch_models.py's F32_GRAD_REL: a ReLU input within f32 error of 0
# may take the other branch)
FLAX_TOL = {"transformer": dict(rtol=2e-5, atol=2e-5),
            "resnet": dict(rtol=5e-5, atol=5e-5)}
FLAX_GRAD_REL = 1e-2


def _inputs(name):
    if name == "transformer":
        return np.random.default_rng(0).integers(0, 31, (2, 16)).astype(np.int32)
    return np.random.default_rng(1).uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)


def _port(name, remat):
    if name == "transformer":
        return TransformerLM(31, num_layers=2, d_model=32, num_heads=2, max_len=16,
                             compute_dtype=torch.float32, remat=remat, device="cpu")
    return ResNet50(num_classes=7, stage_sizes=(1, 1), compute_dtype=torch.float32,
                    remat=remat, in_shape=(32, 32, 3), device="cpu")


def _flax(name, remat):
    if name == "transformer":
        return JaxLM(vocab_size=31, num_layers=2, d_model=32, num_heads=2, max_len=16,
                     compute_dtype=jnp.float32, remat=remat)
    return JaxResNet(num_classes=7, stage_sizes=(1, 1), compute_dtype=jnp.float32,
                     remat=remat)


def _loss(model, x):
    def loss(params, _x=None, _y=None):
        return (model.apply(params, x).float() ** 2).mean()
    return loss


@pytest.mark.parametrize("name", ["transformer", "resnet"])
def test_remat_is_the_same_function_under_the_same_names(name):
    """Logits and gradients with remat equal those without (the reference's
    limits), from one params tree whose names do not change."""
    base, rem = _port(name, False), _port(name, True)
    params = base.init(torch.Generator().manual_seed(0))
    assert list(dict(base.named_parameters())) == list(dict(rem.named_parameters()))
    x = torch.from_numpy(_inputs(name))
    torch.testing.assert_close(rem.apply(params, x), base.apply(params, x),
                               **SAME_FN_TOL[name])
    g0, l0 = torch.func.grad_and_value(_loss(base, x))(params)
    g1, l1 = common.autograd_value_and_grad(_loss(rem, x))(params, None, None)
    torch.testing.assert_close(l1, l0, **SAME_FN_TOL[name])
    for a, b in zip(jax.tree.leaves(g0), jax.tree.leaves(g1), strict=True):
        torch.testing.assert_close(b, a, **SAME_GRAD_TOL)


@pytest.mark.parametrize("name", ["transformer", "resnet"])
def test_remat_matches_flax_remat(name):
    """The port's remat model against flax's ``nn.remat`` one from the same
    params: logits and the gradients of the same loss."""
    pm = _port(name, True)
    params = pm.init(torch.Generator().manual_seed(2))
    jm = _flax(name, True)
    x = _inputs(name)
    jp = jax.tree.map(jnp.asarray, to_flax(params))

    def jloss(p):
        out = jm.apply({"params": p}, x)
        return (out.astype(jnp.float32) ** 2).mean(), out

    (_, want_logits), want = jax.value_and_grad(jloss, has_aux=True)(jp)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(pm.apply(params, xt).detach().numpy(),
                               np.asarray(want_logits), **FLAX_TOL[name])
    grads, _ = common.autograd_value_and_grad(_loss(pm, xt))(params, None, None)
    got = to_flax(grads)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, r in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.linalg.norm(g - np.asarray(r)) <= FLAX_GRAD_REL * np.linalg.norm(r)


def _lm(remat, seq_axis=None, attn_impl="flash"):
    return TransformerLM(31, num_layers=2, d_model=32, num_heads=4, max_len=64,
                         compute_dtype=torch.float32, remat=remat, seq_axis=seq_axis,
                         attn_impl=attn_impl, device="cpu")


def _tokens(n=8):
    x = np.random.default_rng(3).integers(0, 31, (n, 64)).astype(np.int32)
    return x, np.roll(x, -1, axis=1)


@pytest.mark.parametrize("trainer", ["sync-flash", "seq-sync-2x4", "easgd"])
def test_trainers_with_remat_take_the_steps_they_take_without(trainer):
    """Two steps (or one EASGD round of τ = 2) of an f32 LM with remat
    against the same without: the ``torch.autograd.grad`` route (per worker
    under the round trainer) gives the ``torch.func`` route's losses and
    params."""
    x, y = _tokens()
    params = _lm(False).init(torch.Generator().manual_seed(0))
    out = []
    for remat in (False, True):
        if trainer == "sync-flash":
            t = DataParallelTrainer(_lm(remat), optim.Adam(1e-3), Topology(8, CPU))
        elif trainer == "seq-sync-2x4":
            t = SeqParallelTrainer(_lm(remat, seq_axis="sp"), optim.Adam(1e-3),
                                   Topology(8, CPU, axis_names=("dp", "sp"),
                                            mesh_shape=(2, 4)))
        else:
            t = EASGDTrainer(_lm(remat), optim.SGD(0.1, 0.9), Topology(4, CPU), tau=2)
        state = t.init_state(params=params)
        losses = []
        for _ in range(2 if trainer != "easgd" else 1):
            if trainer == "easgd":
                state, m = t.step(state, np.stack([x, x]), np.stack([y, y]))
            else:
                state, m = t.step(state, x, y)
            losses.append(float(m["loss"]))
        final = state.center if trainer == "easgd" else state.params
        out.append((losses, final))
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-6)
    for a, b in zip(jax.tree.leaves(out[0][1]), jax.tree.leaves(out[1][1]), strict=True):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)


def test_the_reference_trainer_with_remat_matches_the_ports(topo8):
    """One f32 sync step of the remat transformer in both packages (the
    reference's flax ``nn.remat`` under its ``DataParallelTrainer`` on the
    8-device mesh): the same loss and params."""
    from mpit_tpu.parallel import DataParallelTrainer as JaxDP

    x, y = _tokens()
    jm = JaxLM(vocab_size=31, num_layers=2, d_model=32, num_heads=4, max_len=64,
               compute_dtype=jnp.float32, remat=True)
    jt = JaxDP(jm, optax.sgd(0.1, momentum=0.9), topo8, donate_state=False)
    js = jt.init_state(jax.random.key(0), x[:1])
    pt = DataParallelTrainer(_lm(True, attn_impl="xla"), optim.SGD(0.1, 0.9),
                             Topology(8, CPU))
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.params), device="cpu"))
    js, jmet = jt.step(js, x, y)
    ps, pmet = pt.step(ps, x, y)
    np.testing.assert_allclose(float(pmet["loss"]), float(jmet["loss"]), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(js.params), jax.tree.leaves(to_flax(ps.params))):
        np.testing.assert_allclose(b, np.asarray(a), rtol=2e-6, atol=2e-6)
