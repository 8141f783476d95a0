"""The port's Downpour trainer against the JAX package's, and BASELINE's
configs through the port's ``run()``, on the CPU.

The JAX trainer runs W = 8 workers on the 8-device CPU mesh (``topo8``);
the port stacks the same 8 workers on one CPU device. The presets run at
the scales of the reference's own `run()` tests
(``tests/test_run_presets.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models import MLP as JaxMLP
from mpit_tpu.parallel import DownpourTrainer as JaxDownpourTrainer
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import MLP
from mpit_tpu_torch.optim import SGD
from mpit_tpu_torch.parallel import DownpourTrainer
from mpit_tpu_torch.run import run
from mpit_tpu_torch.utils.config import TrainConfig

CPU8 = Topology(num_workers=8, device=torch.device("cpu"))
# f32 MLP: each local gradient agrees to ~1e-7 relative (matmuls sum in
# other orders); three rounds of τ = 2 momentum steps, means and ring pulls
# keep it there. 1e-5 relative, 1e-6 absolute on weights of size ~0.1.
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("server", [None, "sgd"], ids=["averaging", "server-sgd"])
@pytest.mark.parametrize("staleness", [0, 1])
def test_three_rounds_match_jax_trainer(topo8, staleness, server):
    """f32 MLP, W = 8, τ = 2, SGD with momentum: after each of three rounds
    the center, every worker's params and the loss equal the JAX
    trainer's, by model averaging or through a server optimizer, with the
    workers pulling the center of ``staleness`` rounds ago."""
    rng = np.random.default_rng(3 + staleness)
    tau, b = 2, 2
    x = rng.uniform(0, 1, (3, tau, 8 * b, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, (3, tau, 8 * b)).astype(np.int32)
    jt = JaxDownpourTrainer(
        JaxMLP(hidden=(16,), compute_dtype=jnp.float32), optax.sgd(0.1, momentum=0.9),
        topo8, tau=tau, staleness=staleness, donate_state=False,
        server_optimizer=None if server is None else optax.sgd(0.5, momentum=0.5),
    )
    js = jt.init_state(jax.random.key(0), x[0, 0, :2])
    pt = DownpourTrainer(
        MLP(hidden=(16,), compute_dtype=torch.float32, in_shape=(8, 8, 1), device="cpu"),
        SGD(0.1, 0.9), CPU8, tau=tau, staleness=staleness,
        server_optimizer=None if server is None else SGD(0.5, 0.5),
    )
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.center), device="cpu"))
    for r in range(3):
        js, jm = jt.step(js, x[r], y[r])
        ps, pm = pt.step(ps, x[r], y[r])
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-6)
        for want, got in ((js.center, ps.center), (js.worker_params, ps.worker_params),
                          (js.center_history, ps.center_history)):
            got = jax.tree.leaves(to_flax(got))
            for a, g in zip(jax.tree.leaves(want), got, strict=True):
                np.testing.assert_allclose(g, np.asarray(a), **TRAJ_TOL)
    assert ps.round == int(js.round) == 3
    assert jax.tree.leaves(to_flax(ps.center_history))[0].shape[0] == staleness + 1
    if staleness:  # the workers hold last round's center, not this one's
        stale = jax.tree.leaves(to_flax(ps.center_history))[0][0]
        assert np.array_equal(jax.tree.leaves(to_flax(ps.worker_params))[0][3], stale)
        assert not np.array_equal(stale, jax.tree.leaves(to_flax(ps.center))[0])
    ex = rng.uniform(0, 1, (64, 8, 8, 1)).astype(np.float32)
    ey = rng.integers(0, 10, 64).astype(np.int32)
    assert pt.evaluate(ps, ex, ey) == jt.evaluate(js, ex, ey)


def test_negative_staleness_raises():
    with pytest.raises(ValueError, match="staleness must be >= 0"):
        DownpourTrainer(MLP(device="cpu"), SGD(0.1), CPU8, staleness=-1)


def _cfg(preset: str, **over) -> TrainConfig:
    return dataclasses.replace(TrainConfig().apply_preset(preset), **over)


# the reference's scales (tests/test_run_presets.py) and its counts
PRESETS = {
    "cifar-vgg-sync": (dict(train_size=128, global_batch=32, epochs=1), 4, 128),
    "alexnet-downpour": (dict(train_size=64, global_batch=32, image_size=64, tau=2,
                              epochs=1), 1, 64),
    "resnet50-sync": (dict(train_size=16, global_batch=8, image_size=64, epochs=1), 2, 16),
    "ptb-lstm-easgd": (dict(train_size=64, global_batch=16, seq_len=16, tau=2,
                            epochs=1), 2, 64),
}


@pytest.mark.parametrize("preset", list(PRESETS))
def test_run_trains_each_baseline_preset_on_cpu(preset):
    over, units, samples = PRESETS[preset]
    cfg = _cfg(preset, **over)
    res = run(cfg, device="cpu")
    assert res["workers"] == 8 and res["platform"] == "cpu"
    assert (res["trained_units"], res["samples"]) == (units, samples)
    assert np.isfinite(res["round_losses"]).all()
    assert 0.0 <= res["accuracy"] <= 1.0
    assert ("eval_loss" in res) == (cfg.algo == "sync")


def test_ps_easgd_runs_vgg_on_cifar10():
    """``ps-*`` runs off MNIST: any registry model on any dataset, as the
    reference's ``_run_async_ps``."""
    cfg = _cfg("mnist-ps", model="vgg", dataset="cifar10", train_size=256, steps=8,
               global_batch=32)
    res = run(cfg, device="cpu")
    counts = res["server_counts"][0]
    assert counts["push_easgd"] == 2 * (8 // 4) and not res["dead_clients"]
    assert all(len(l) == 8 and np.isfinite(l).all() for l in res["client_losses"])
    assert 0.0 <= res["accuracy"] <= 1.0


def test_run_warns_on_remat_for_models_without_it():
    """The reference's warning for ``remat`` on a model that has none; a
    model that has one (ResNet-50) trains with it as without it."""
    with pytest.warns(UserWarning, match="remat is implemented"):
        res = run(_cfg("mnist-easgd", model="mlp", train_size=256, global_batch=64,
                       epochs=1, remat=True), device="cpu")
    assert res["trained_units"] == 1
    losses = [run(_cfg("resnet50-sync", train_size=16, global_batch=8, image_size=64,
                       remat=remat), device="cpu")["round_losses"]
              for remat in (False, True)]
    assert len(losses[1]) == 2
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
