"""The trainers whose unit runs as a CUDA graph on the card
(``mpit_tpu_torch/parallel/capture.py``: zero-sync with and without int8
codes on its scatter, moe-sync, seq-sync by ring and by Ulysses, tp,
composed, Downpour), driven through their replay
branch, against the reference's trainers on the CPU.

The replay branch is what a captured trainer runs after its first unit:
the optimizer's host values reach the unit as 0-dim tensors and the host
moves the counts afterwards. ``ReplayOnTheHost`` (``test_torch_capture``)
runs the unit's body there, where a graph would replay it, so every unit
below goes through that branch. Each case starts both packages from the
port's init (the weight converter carries it across), feeds both the
same numpy-seeded batches for 2 units, with a cosine schedule on the
learning rate, and holds the losses (and moe-sync's statistics) and the
state to the tolerance of that trainer's own parity test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_capture import ReplayOnTheHost

import mpit_tpu
from mpit_tpu.models import MLP as JaxMLP
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel import ComposedParallelTrainer as JaxComposed
from mpit_tpu.parallel import DownpourTrainer as JaxDownpour
from mpit_tpu.parallel import MoEParallelTrainer as JaxMoE
from mpit_tpu.parallel import SeqParallelTrainer as JaxSeq
from mpit_tpu.parallel import TensorParallelTrainer as JaxTP
from mpit_tpu.parallel import ZeroDataParallelTrainer as JaxZero
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import to_flax
from mpit_tpu_torch.models import MLP, TransformerLM
from mpit_tpu_torch.parallel import (
    ComposedParallelTrainer,
    DownpourTrainer,
    MoEParallelTrainer,
    SeqParallelTrainer,
    TensorParallelTrainer,
    ZeroDataParallelTrainer,
)

CPU = torch.device("cpu")
UNITS, TAU, V, B, T = 2, 2, 31, 8, 16

# each trainer's own parity test's tolerances (loss, state)
TOLS = {
    # tests/test_torch_zero.py REF_TOL (and 1e-5 on the loss)
    "zero": (dict(rtol=1e-5, atol=0), dict(rtol=1e-5, atol=1e-5)),
    # tests/test_torch_zero.py REF_Q_TOL with int8 codes on the scatter
    "zero-int8": (dict(rtol=1e-5, atol=0), dict(rtol=0, atol=1e-3)),
    # tests/test_torch_moe.py LOSS_TOL (the statistics too), PARAM_TOL
    "moe": (dict(rtol=1e-4, atol=1e-5), dict(rtol=3e-4, atol=3e-4)),
    # tests/test_torch_seq.py LOSS_TOL, PARAM_TOL
    "seq": (dict(rtol=1e-5, atol=1e-5), dict(rtol=5e-5, atol=5e-5)),
    # tests/test_torch_tensor.py LOSS_TOL, PARAM_TOL
    "tp": (dict(rtol=1e-4, atol=1e-5), dict(rtol=2e-4, atol=2e-4)),
    # tests/test_torch_composed.py LOSS_TOL, PARAM_TOL
    "composed": (dict(rtol=2e-5, atol=2e-6), dict(rtol=3e-4, atol=3e-4)),
    # tests/test_torch_downpour.py: the loss 1e-6 relative, TRAJ_TOL
    "downpour": (dict(rtol=1e-6, atol=0), dict(rtol=1e-5, atol=1e-6)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the test processes
    share the machine)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sgd(port: bool, lr: float = 0.1, momentum: float = 0.9):
    """SGD with momentum on a cosine schedule over the units, in either
    package: the learning rate is a host value of every update."""
    if port:
        return optim.SGD(optim.cosine_decay_schedule(lr, 2 * UNITS), momentum)
    return optax.sgd(optax.cosine_decay_schedule(lr, 2 * UNITS), momentum=momentum)


def _tokens(seed):
    x = np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _images(seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (TAU, B, 8, 8, 1)).astype(np.float32)
    return x, rng.integers(0, 10, (TAU, B)).astype(np.int32)


def _world(names, shape):
    mpit_tpu.finalize()
    return mpit_tpu.init(axis_names=names, mesh_shape=shape)


def _lm_kw(**kw):
    return dict(num_layers=1, d_model=32, num_heads=4, max_len=T, **kw)


def _lms(**kw):
    return (JaxLM(vocab_size=V, compute_dtype=jnp.float32, **_lm_kw(**kw)),
            TransformerLM(V, compute_dtype=torch.float32, device="cpu", **_lm_kw(**kw)))


MOE = dict(moe_experts=8, moe_capacity_factor=2.0, moe_top_k=2, moe_balance_weight=0.5,
           moe_zloss_weight=0.1)


def _zero(quant):
    def make():
        topo = _world(("dp",), (8,))
        jt = JaxZero(JaxMLP(hidden=(16,), compute_dtype=jnp.float32), _sgd(False), topo,
                     donate_state=False, quant=quant)
        pt = ZeroDataParallelTrainer(
            MLP(hidden=(16,), compute_dtype=torch.float32, in_shape=(8, 8, 1), device="cpu"),
            _sgd(True), Topology(8, CPU), quant=quant)

        def batch(seed):
            x, y = _images(seed)
            return x[0], y[0]

        return jt, pt, batch, batch(0)[0][:2]
    return make


def _moe():
    topo = _world(("dp",), (8,))
    jm, pm = _lms(moe_axis="dp", **MOE)
    return (JaxMoE(jm, _sgd(False), topo, donate_state=False),
            MoEParallelTrainer(pm, _sgd(True), Topology(8, CPU)), _tokens, _tokens(0)[0][:1])


def _seq(impl):
    def make():
        topo = _world(("dp", "sp"), (2, 4))
        jm, pm = _lms(seq_axis="sp", seq_impl=impl)
        return (JaxSeq(jm, _sgd(False), topo, donate_state=False),
                SeqParallelTrainer(pm, _sgd(True), Topology(8, CPU, axis_names=("dp", "sp"),
                                                            mesh_shape=(2, 4))),
                _tokens, _tokens(0)[0][: B // 2, : T // 4])
    return make


def _tp():
    topo = _world(("dp", "tp"), (2, 4))
    jm, pm = _lms()
    return (JaxTP(jm, _sgd(False), topo, donate_state=False),
            TensorParallelTrainer(pm, _sgd(True), Topology(8, CPU, axis_names=("dp", "tp"),
                                                           mesh_shape=(2, 4))),
            _tokens, _tokens(0)[0][:2])


def _composed():
    topo = _world(("dp", "tp", "sp"), (2, 2, 2))
    jm, pm = _lms(seq_axis="sp")
    return (JaxComposed(jm, _sgd(False), topo, donate_state=False),
            ComposedParallelTrainer(pm, _sgd(True), Topology(
                8, CPU, axis_names=("dp", "tp", "sp"), mesh_shape=(2, 2, 2))),
            _tokens, _tokens(0)[0][:2, : T // 2])


def _downpour(staleness, server):
    def make():
        topo = _world(("dp",), (8,))
        jt = JaxDownpour(JaxMLP(hidden=(16,), compute_dtype=jnp.float32), _sgd(False), topo,
                         tau=TAU, staleness=staleness, donate_state=False,
                         server_optimizer=_sgd(False, 0.5, 0.5) if server else None)
        pt = DownpourTrainer(
            MLP(hidden=(16,), compute_dtype=torch.float32, in_shape=(8, 8, 1), device="cpu"),
            _sgd(True), Topology(8, CPU), tau=TAU, staleness=staleness,
            server_optimizer=_sgd(True, 0.5, 0.5) if server else None)
        return jt, pt, _images, _images(0)[0][0, :2]
    return make


# name -> (tolerances, (reference, port, batch(seed), the reference's
# init sample))
CASES = {
    "zero": ("zero", _zero("off")),
    "zero-int8": ("zero-int8", _zero("int8")),
    "moe": ("moe", _moe),
    "seq-ring": ("seq", _seq("ring")),
    "seq-ulysses": ("seq", _seq("ulysses")),
    "tp": ("tp", _tp),
    "composed": ("composed", _composed),
    "downpour-staleness-0": ("downpour", _downpour(0, False)),
    "downpour-staleness-1-server-sgd": ("downpour", _downpour(1, True)),
}


def _state_trees(state):
    """The state's trees in the reference's layout, in a fixed order."""
    if hasattr(state, "params"):
        return [state.params]
    return [state.center, state.worker_params, state.center_history]


def _reference_state(jt, init, sample):
    """The reference's ``init_state`` from the port's init ``init`` (flax
    layout): Downpour takes it as ``params=``; the others' model answers
    its ``init`` with it (compiling the reference's own init took most of
    this file's time)."""
    params = jax.tree.map(jnp.asarray, init)
    if isinstance(jt, JaxDownpour):
        return jt.init_state(jax.random.key(0), params=params)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(jt.model), "init", lambda self, *a, **k: {"params": params})
        return jt.init_state(jax.random.key(0), jnp.asarray(sample))


@pytest.mark.parametrize("name", list(CASES))
def test_the_replay_branch_trains_as_the_reference(name):
    tol, make = CASES[name]
    loss_tol, state_tol = TOLS[tol]
    jt, pt, batch, sample = make()
    pt._graph = ReplayOnTheHost()
    # both start from the port's seeded init
    ps = pt.init_state(torch.Generator().manual_seed(0))
    js = _reference_state(jt, to_flax(ps.params if hasattr(ps, "params") else ps.center),
                          sample)
    for u in range(UNITS):
        js, jm = jt.step(js, *batch(u))
        ps, pm = pt.step(ps, *batch(u))
        keys = [k for k in pm if k == "loss" or k.startswith("moe_")]
        assert keys and set(keys) <= set(jm)
        for k in keys:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]), **loss_tol, err_msg=k)
    assert pt._graph.replays == UNITS
    for want, got in zip(_state_trees(js), _state_trees(ps), strict=True):
        for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(to_flax(got)), strict=True):
            np.testing.assert_allclose(b, np.asarray(a), **state_tol)
    unit = "step" if hasattr(ps, "params") else "round"
    assert getattr(ps, unit) == int(getattr(js, unit)) == UNITS
