"""The port's composed dp × tp × sp parallelism (``parallel/composed.py``)
against the JAX package's on the 8-device CPU mesh.

The reference's 6 cases of ``tests/test_composed.py`` on the port's
trainer (one trajectory across five factorizations of 8, Ulysses composes,
tp = 1 equals the 2-D seq trainer, the tp shards, convergence, the
refusals), then three steps against the reference's trainer from the same
init. Tolerances: the reference's (losses 2e-5 relative, params 3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpit_tpu
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel import ComposedParallelTrainer as JaxComposed
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.parallel import ComposedParallelTrainer, SeqParallelTrainer
from mpit_tpu_torch.parallel.tensor import P, shard_views
from mpit_tpu_torch.utils.params import tree_leaves

V, B, T = 29, 8, 32
CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_TOL = dict(rtol=3e-4, atol=3e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(seq_axis="sp", **kw):
    kw = {"num_heads": 8, **kw}
    return TransformerLM(V, num_layers=2, d_model=32, max_len=T, compute_dtype=torch.float32,
                         seq_axis=seq_axis, device="cpu", **kw)


def _data(seed=0):
    x = np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _world(shape):
    return Topology(8, CPU, axis_names=("dp", "tp", "sp"), mesh_shape=shape)


def _params():
    return _model().init(torch.Generator().manual_seed(0))


def _run(shape, params, steps=3, seq_impl="ring", opt=None):
    tr = ComposedParallelTrainer(_model(seq_impl=seq_impl),
                                 opt or optim.SGD(0.1, momentum=0.9), _world(shape))
    state = tr.init_state(params=params)
    x, y = _data()
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, x, y)
        losses.append(float(m["loss"]))
    return losses, state.params, tr.evaluate(state, x, y)


def _close(a, b):
    for p, q in zip(tree_leaves(a), tree_leaves(b), strict=True):
        torch.testing.assert_close(p, q, **PARAM_TOL)


class TestComposed:
    def test_factorizations_match(self):
        """(8,1,1), (2,2,2), (1,4,2), (2,1,4), (1,1,8): one trajectory."""
        params = _params()
        ref_losses, ref_params, ref_ev = _run((8, 1, 1), params)
        for shape in ((2, 2, 2), (1, 4, 2), (2, 1, 4), (1, 1, 8)):
            losses, got, ev = _run(shape, params)
            np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL, err_msg=f"mesh {shape}")
            _close(got, ref_params)
            assert ev[0] == pytest.approx(ref_ev[0], abs=0.03)

    def test_ulysses_composes_too(self):
        params = _params()
        ref_losses, ref_params, _ = _run((2, 2, 2), params)
        losses, got, _ = _run((2, 2, 2), params, seq_impl="ulysses")
        np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL)
        _close(got, ref_params)

    def test_matches_dedicated_seq_trainer(self):
        params = _params()
        composed_losses, composed_params, _ = _run((2, 1, 4), params)
        tr = SeqParallelTrainer(_model(), optim.SGD(0.1, momentum=0.9),
                                Topology(8, CPU, axis_names=("dp", "sp"), mesh_shape=(2, 4)))
        state = tr.init_state(params=params)
        x, y = _data()
        losses = []
        for _ in range(3):
            state, m = tr.step(state, x, y)
            losses.append(float(m["loss"]))
        np.testing.assert_allclose(losses, composed_losses, **LOSS_TOL)
        _close(state.params, composed_params)

    def test_weights_actually_sharded_on_tp(self):
        tr = ComposedParallelTrainer(_model(), optim.SGD(0.1), _world((1, 4, 2)))
        state = tr.init_state(torch.Generator().manual_seed(0))
        specs = tr.state_sharding(state.params)
        assert specs["Block_0"]["Dense_0"]["kernel"] == P(None, "tp")
        assert specs["Block_0"]["Dense_3"]["kernel"] == P("tp", None)
        views = list(shard_views(state.params, specs, tr.tp_size))
        assert tuple(views[3]["Block_0"]["Dense_0"]["kernel"].shape) == (32, 24)
        assert tuple(views[3]["Block_0"]["Dense_3"]["kernel"].shape) == (32, 32)
        assert torch.equal(views[1]["Block_0"]["Dense_3"]["kernel"],
                           state.params["Block_0"]["Dense_3"]["kernel"][32:64])

    def test_trains_to_low_loss(self):
        tr = ComposedParallelTrainer(_model(), optim.SGD(0.3, momentum=0.9), _world((2, 2, 2)))
        x = (np.arange(B * T * 2, dtype=np.int32) % V).reshape(-1, T)[:B]
        y = np.roll(x, -1, axis=1).astype(np.int32)
        state = tr.init_state(torch.Generator().manual_seed(1))
        losses = []
        for _ in range(40):
            state, m = tr.step(state, x, y)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.5, losses

    def test_validation(self):
        topo = _world((2, 2, 2))
        with pytest.raises(ValueError, match="seq_axis='sp'"):
            ComposedParallelTrainer(_model(seq_axis=None), optim.SGD(0.1), topo)
        moe = TransformerLM(V, max_len=T, seq_axis="sp", moe_experts=8, device="cpu")
        with pytest.raises(ValueError, match="MoEParallelTrainer"):
            ComposedParallelTrainer(moe, optim.SGD(0.1), topo)
        tr = ComposedParallelTrainer(_model(), optim.SGD(0.1), topo)
        x, y = _data()
        with pytest.raises(ValueError, match="not divisible"):
            tr.step(None, x[:7], y[:7])
        with pytest.raises(ValueError, match="dp', 'tp', 'sp"):
            ComposedParallelTrainer(_model(), optim.SGD(0.1), Topology(
                8, CPU, axis_names=("dp", "sp"), mesh_shape=(2, 4)))


def test_three_steps_match_the_reference_trainer():
    """Three SGD-momentum steps at (2, 2, 2) from the reference's init:
    losses, params and the evaluation against the reference's composed
    trainer (its ring over sp, GSPMD's psums over tp)."""
    mpit_tpu.finalize()
    topo = mpit_tpu.init(axis_names=("dp", "tp", "sp"), mesh_shape=(2, 2, 2))
    jt = JaxComposed(JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=8, max_len=T,
                           compute_dtype=jnp.float32, seq_axis="sp"),
                     optax.sgd(0.1, momentum=0.9), topo, donate_state=False)
    x, y = _data()
    js = jt.init_state(jax.random.key(0), x[:2, : T // 2])
    init = jax.tree.map(np.asarray, jax.device_get(js.params))
    want = []
    for _ in range(3):
        js, m = jt.step(js, x, y)
        want.append(float(m["loss"]))
    want_p = jax.tree.map(np.asarray, jax.device_get(js.params))
    want_ev = jt.evaluate(js, x, y)
    mpit_tpu.finalize()
    losses, got, ev = _run((2, 2, 2), from_flax(init, device="cpu"))
    np.testing.assert_allclose(losses, want, **LOSS_TOL)
    for a, b in zip(jax.tree.leaves(want_p), jax.tree.leaves(to_flax(got)), strict=True):
        np.testing.assert_allclose(b, a, **PARAM_TOL)
    assert ev[0] == pytest.approx(want_ev[0], abs=1e-6)
    assert ev[1] == pytest.approx(want_ev[1], rel=1e-5)
