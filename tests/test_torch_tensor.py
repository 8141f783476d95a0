"""The port's tensor parallelism (``parallel/tensor.py``) against the JAX
package's GSPMD trainer on the 8-device CPU mesh.

The reference's 5 cases of ``tests/test_tensor_parallel.py`` on the port's
trainer (the Megatron spec tree and each device's shard, here
``shard_views`` against the reference's ``addressable_shards``; the
trajectory across (dp, tp) factorizations and against the sync trainer;
the strict rule table; the MoE and other refusals), then three steps
against the reference's trainer from the same init. Tolerances: the
reference's (losses 1e-4 relative, params 2e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpit_tpu
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel import TensorParallelTrainer as JaxTP
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.parallel import DataParallelTrainer, TensorParallelTrainer
from mpit_tpu_torch.parallel.tensor import P, shard_views, tp_state_specs
from mpit_tpu_torch.utils.params import tree_leaves

V, B, T = 29, 8, 32
CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _model(**kw):
    kw = {"num_heads": 8, **kw}
    return TransformerLM(V, num_layers=2, d_model=32, max_len=T,
                         compute_dtype=torch.float32, device="cpu", **kw)


def _data(seed=0, n=B):
    x = np.random.default_rng(seed).integers(0, V, (n, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _world(shape):
    return Topology(8, CPU, axis_names=("dp", "tp"), mesh_shape=shape)


def _run_tp(shape, params, steps=3):
    tr = TensorParallelTrainer(_model(), optim.SGD(0.1, momentum=0.9), _world(shape))
    state = tr.init_state(params=params)
    x, y = _data()
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, x, y)
        losses.append(float(m["loss"]))
    return losses, state.params, tr.evaluate(state, x, y)


class TestTensorParallel:
    def test_weights_actually_sharded(self, topo8):
        """Each device's shard of each leaf (``shard_views``) has the shape
        of the reference's ``addressable_shards`` on a (2, 4) mesh."""
        mpit_tpu.finalize()
        topo = mpit_tpu.init(axis_names=("dp", "tp"), mesh_shape=(2, 4))
        jt = JaxTP(JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=8, max_len=T,
                         compute_dtype=jnp.float32), optax.sgd(0.1), topo, donate_state=False)
        x, _ = _data()
        js = jt.init_state(jax.random.key(0), x[:2])
        params = from_flax(jax.tree.map(np.asarray, js.params), device="cpu")
        specs = tp_state_specs(params)
        assert specs["Block_0"]["Dense_0"]["kernel"] == P(None, "tp")
        assert specs["Block_0"]["Dense_3"]["kernel"] == P("tp", None)
        assert specs["Embed_0"]["embedding"] == P()
        views = list(shard_views(params, specs, 4))
        # device (d, t) of the mesh holds tp shard t
        for leaf_path in (("Block_0", "Dense_0", "kernel"), ("Block_1", "Dense_1", "kernel"),
                          ("Block_0", "Dense_2", "bias"), ("Block_0", "Dense_3", "kernel"),
                          ("Embed_0", "embedding")):
            ref_leaf = js.params
            for k in leaf_path:
                ref_leaf = ref_leaf[k]
            for shard in ref_leaf.addressable_shards:
                t = int(np.argwhere(topo.mesh.devices == shard.device)[0][1])
                port = views[t]
                for k in leaf_path:
                    port = port[k]
                assert tuple(port.shape) == shard.data.shape, leaf_path
                assert np.array_equal(port.numpy(), np.asarray(shard.data)), leaf_path
        mpit_tpu.finalize()

    def test_tp_factorizations_match_each_other_and_dp(self):
        params = _model().init(torch.Generator().manual_seed(0))
        ref_losses, ref_params, ref_ev = _run_tp((8, 1), params)
        for shape in ((2, 4), (1, 8)):
            losses, got, ev = _run_tp(shape, params)
            np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL,
                                       err_msg=f"losses diverged for mesh {shape}")
            for a, b in zip(tree_leaves(got), tree_leaves(ref_params), strict=True):
                torch.testing.assert_close(a, b, **PARAM_TOL)
            assert ev[0] == pytest.approx(ref_ev[0], abs=1e-6)
        dp = DataParallelTrainer(_model(), optim.SGD(0.1, momentum=0.9), Topology(8, CPU))
        state = dp.init_state(params=params)
        x, y = _data()
        dp_losses = []
        for _ in range(3):
            state, m = dp.step(state, x, y)
            dp_losses.append(float(m["loss"]))
        np.testing.assert_allclose(dp_losses, ref_losses, **LOSS_TOL)

    def test_rule_drift_raises_instead_of_replicating(self):
        tr = TensorParallelTrainer(_model(), optim.SGD(0.1), _world((2, 4)))
        arr = torch.zeros(8, 8)
        with pytest.raises(ValueError, match="matched no rule"):
            tr.state_sharding({"params": {"Block_0": {"Dense_9": {"kernel": arr}}}})
        with pytest.raises(ValueError, match="matched no parameter"):
            tr.state_sharding({"params": {"Block_0": {"LayerNorm_0": {"scale": arr}}}})
        # the whole TrainState (the momentum trace reuses the params' paths)
        tr = TensorParallelTrainer(_model(), optim.SGD(0.1, momentum=0.9), _world((2, 4)))
        state = tr.init_state(torch.Generator().manual_seed(0))
        specs = tr.state_sharding(state)
        assert specs.opt_state[0].trace["Block_1"]["Dense_1"]["kernel"] == P("tp", None)
        assert specs.step == P()

    def test_moe_model_rejected(self):
        moe = TransformerLM(V, num_layers=2, d_model=32, num_heads=8, max_len=T,
                            moe_experts=8, device="cpu")
        with pytest.raises(ValueError, match="MoEParallelTrainer"):
            TensorParallelTrainer(moe, optim.SGD(0.1), _world((2, 4)))

    def test_validation(self):
        with pytest.raises(ValueError, match="second axis is 'tp'"):
            TensorParallelTrainer(_model(), optim.SGD(0.1), Topology(8, CPU))
        with pytest.raises(ValueError, match="not divisible by tp"):
            TensorParallelTrainer(_model(num_heads=2), optim.SGD(0.1), _world((1, 8)))
        with pytest.raises(ValueError, match="dense-attention"):
            TensorParallelTrainer(_model(seq_axis="sp"), optim.SGD(0.1), _world((1, 8)))
        tr = TensorParallelTrainer(_model(), optim.SGD(0.1), _world((2, 4)))
        x, y = _data()
        with pytest.raises(ValueError, match="not divisible by dp"):
            tr.step(tr.init_state(torch.Generator().manual_seed(0)), x[:3], y[:3])


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)], ids=["2x4", "1x8"])
def test_three_steps_match_the_reference_trainer(shape):
    """Three SGD-momentum steps from the reference's init: losses, params
    and the evaluation against the reference's GSPMD trainer on the same
    mesh (its psums of the row-parallel products against the port's
    shard sums)."""
    mpit_tpu.finalize()
    topo = mpit_tpu.init(axis_names=("dp", "tp"), mesh_shape=shape)
    jt = JaxTP(JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=8, max_len=T,
                     compute_dtype=jnp.float32), optax.sgd(0.1, momentum=0.9), topo,
               donate_state=False)
    x, y = _data()
    js = jt.init_state(jax.random.key(0), x[:2])
    init = jax.tree.map(np.asarray, jax.device_get(js.params))
    want = []
    for _ in range(3):
        js, m = jt.step(js, x, y)
        want.append(float(m["loss"]))
    want_p = jax.tree.map(np.asarray, jax.device_get(js.params))
    want_ev = jt.evaluate(js, x, y)
    mpit_tpu.finalize()
    losses, got, ev = _run_tp(shape, from_flax(init, device="cpu"))
    np.testing.assert_allclose(losses, want, **LOSS_TOL)
    for a, b in zip(jax.tree.leaves(want_p), jax.tree.leaves(to_flax(got)), strict=True):
        np.testing.assert_allclose(b, a, **PARAM_TOL)
    assert ev[0] == pytest.approx(want_ev[0], abs=1e-6)
    assert ev[1] == pytest.approx(want_ev[1], rel=1e-5)
