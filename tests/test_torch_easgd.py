"""The port's EASGD trainer and driver against the JAX package's: the
slice as a whole, on the CPU, from the same init and the same data.

The JAX trainer runs W = 8 workers on the 8-device CPU mesh (``topo8``);
the port stacks the same 8 workers on one CPU device.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models import MLP as JaxMLP
from mpit_tpu.models import LeNet as JaxLeNet
from mpit_tpu.parallel import EASGDTrainer as JaxEASGDTrainer
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import MLP, LeNet
from mpit_tpu_torch.optim import SGD
from mpit_tpu_torch.parallel import EASGDTrainer

CPU8 = Topology(num_workers=8, device=torch.device("cpu"))

# f32 trajectory tolerance: each local step's gradient agrees to ~1e-6
# relative (convolutions sum in different orders); momentum and 2 x 3
# local steps carry that forward, and the elastic moves mix it across
# workers, so after three rounds the center agrees to ~1e-5. 1e-4 absolute
# on weights of size ~0.1 leaves a decade of room.
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _rounds(seed, rounds, tau, w, b, shape):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (rounds, tau, w * b, *shape)).astype(np.float32)
    ys = rng.integers(0, 10, (rounds, tau, w * b)).astype(np.int32)
    return xs, ys


def test_lenet_f32_three_rounds_match_jax_trainer(topo8):
    """LeNet f32, W = 8, SGD with momentum, τ = 2: the center after each
    of three rounds and the per-round losses match the JAX trainer."""
    tau, b = 2, 2
    xs, ys = _rounds(0, 3, tau, topo8.num_workers, b, (28, 28, 1))
    jt = JaxEASGDTrainer(
        JaxLeNet(compute_dtype=jnp.float32), optax.sgd(0.05, momentum=0.9),
        topo8, tau=tau, donate_state=False,
    )
    js = jt.init_state(jax.random.key(0), xs[0, 0, :2])
    pt = EASGDTrainer(
        LeNet(compute_dtype=torch.float32, device="cpu"), SGD(0.05, 0.9),
        CPU8, tau=tau,
    )
    assert pt.alpha == jt.alpha == 0.9 / 8
    ps = pt.init_state(
        params=from_flax(jax.tree.map(np.asarray, js.center), device="cpu")
    )
    for r in range(3):
        js, jm = jt.step(js, xs[r], ys[r])
        ps, pm = pt.step(ps, xs[r], ys[r])
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        got = to_flax(ps.center)
        for a, g in zip(jax.tree.leaves(js.center), jax.tree.leaves(got)):
            np.testing.assert_allclose(g, np.asarray(a), **TRAJ_TOL)
    assert ps.round == int(js.round) == 3
    ex, ey = _rounds(1, 1, 1, 8, 16, (28, 28, 1))
    assert pt.evaluate(ps, ex[0, 0], ey[0, 0]) == jt.evaluate(js, ex[0, 0], ey[0, 0])


@pytest.mark.parametrize("use_kernel", [False, None], ids=["tree-moves", "per-leaf"])
def test_mlp_trainer_matches_jax(topo8, use_kernel):
    """The MLP case of the reference's kernel-on trainer test: f32 MLP,
    plain SGD, τ = 2, two rounds on the same batches."""
    rng = np.random.default_rng(2)
    w, tau, b = topo8.num_workers, 2, 4
    x = rng.uniform(0, 1, (tau, w * b, 8, 8, 1)).astype(np.float32)
    y = rng.integers(0, 10, (tau, w * b)).astype(np.int32)
    jt = JaxEASGDTrainer(
        JaxMLP(hidden=(16,), compute_dtype=jnp.float32), optax.sgd(0.1),
        topo8, tau=tau, use_pallas=True, donate_state=False,
    )
    js = jt.init_state(jax.random.key(0), x[0, :2])
    pt = EASGDTrainer(
        MLP(hidden=(16,), compute_dtype=torch.float32, in_shape=(8, 8, 1),
            device="cpu"),
        SGD(0.1), CPU8, tau=tau, use_kernel=use_kernel,
    )
    ps = pt.init_state(
        params=from_flax(jax.tree.map(np.asarray, js.center), device="cpu")
    )
    for _ in range(2):
        js, jm = jt.step(js, x, y)
        ps, pm = pt.step(ps, x, y)
    assert np.isfinite(float(pm["loss"]))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
    for a, g in zip(jax.tree.leaves(js.center), jax.tree.leaves(to_flax(ps.center))):
        np.testing.assert_allclose(g, np.asarray(a), rtol=1e-5, atol=1e-6)


def test_run_trains_preset_on_cpu():
    """run() end to end on the CPU: mnist-easgd values at a small
    scale train through run(), and the results carry the reference's keys."""
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = dataclasses.replace(
        TrainConfig().apply_preset("mnist-easgd"),
        model="mlp", train_size=1024, global_batch=64, epochs=2,
    )
    res = run(cfg, device="cpu")
    for key in ("config", "workers", "platform", "accuracy", "final_loss",
                "trained_units", "samples", "wall_s", "samples_per_sec",
                "samples_per_sec_per_chip", "step_time"):
        assert key in res
    assert res["workers"] == 8 and res["platform"] == "cpu"
    assert res["trained_units"] == 2 * (1024 // 64) // 4
    losses = res["round_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert res["accuracy"] > 0.5


@pytest.mark.parametrize("change", [
    dict(algo="zero-sync"), dict(algo="moe-sync"), dict(optimizer="adam"),
    dict(lr_schedule="cosine"), dict(ckpt_dir="ckpt"), dict(profile_dir="prof"),
])
def test_run_refuses_what_is_not_ported(change, tmp_path):
    """moe-sync, which raised until item A11 landed, refuses the preset's
    LeNet without ``--moe-experts`` with the reference's ValueError;
    zero-sync, which raised until item A6 landed, trains the preset's LeNet
    by ZeRO-1 (8 steps of 64); run()'s flags of item A5b (Adam, a schedule,
    checkpoints, a profiler trace), which raised until A5b landed, now
    train under easgd."""
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), **change)
    if change.get("algo") == "moe-sync":
        with pytest.raises(ValueError, match="moe-experts"):
            run(cfg, device="cpu")
        return
    if "algo" in change:
        res = run(dataclasses.replace(cfg, train_size=512, global_batch=64, epochs=1),
                  device="cpu")
        assert res["trained_units"] == 8 and np.isfinite(res["round_losses"]).all()
        assert res["round_losses"][-1] < res["round_losses"][0]
        return
    change = {k: str(tmp_path / v) if k.endswith("_dir") else v
              for k, v in change.items()}
    cfg = dataclasses.replace(cfg, train_size=512, global_batch=64, epochs=1,
                              **change)
    res = run(cfg, device="cpu")
    assert res["trained_units"] == 2 and np.isfinite(res["round_losses"]).all()
    if "ckpt_dir" in change:
        assert res["last_checkpoint"] == 2
        assert sorted(os.listdir(change["ckpt_dir"])) == [
            "ckpt_00000002.json", "ckpt_00000002.msgpack"]
    if "profile_dir" in change:
        assert os.listdir(change["profile_dir"])[0].endswith(".pt.trace.json")
