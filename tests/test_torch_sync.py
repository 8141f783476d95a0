"""The port's optimizers, schedules, sync-DP trainer and driver against the
JAX package's, on the CPU, from the same init and the same data.

The JAX trainer runs W = 8 workers on the 8-device CPU mesh (``topo8``);
the port runs the same global batch on one CPU device, which is the same
mean gradient (see ``mpit_tpu_torch/parallel/sync.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel import DataParallelTrainer as JaxDP
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.parallel import DataParallelTrainer

CPU8 = Topology(num_workers=8, device=torch.device("cpu"))
# f32 trajectory tolerance: each step's gradient agrees to ~1e-6 relative
# (the same sums in other orders). Adam divides by the gradient's own
# scale, so a gradient element near float noise can move its update by up
# to lr x (noise / eps); over three steps at lr <= 3e-4 the params agree to
# ~1e-7 absolute in practice. 2e-6 leaves a decade of room.
TRAJ_TOL = dict(rtol=2e-6, atol=2e-6)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(4,)).astype(np.float32)}}


@pytest.mark.parametrize("name", ["adamw-warmup-cosine", "adam-constant", "adam-cosine"])
def test_adam_matches_optax(name):
    """Five steps from the same params and gradients; for warmup-cosine the
    schedule is read before the step, so the first update is exactly 0,
    weight decay included."""
    if name == "adamw-warmup-cosine":
        ref = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 8),
                          weight_decay=1e-2)
        mine = optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 8), 1e-2)
    elif name == "adam-constant":
        ref, mine = optax.adam(1e-3), optim.Adam(1e-3)
    else:
        ref = optax.adam(optax.cosine_decay_schedule(1e-2, 4))
        mine = optim.Adam(optim.cosine_decay_schedule(1e-2, 4))
    params = _tree(0)
    st = ref.init(params)
    tp = jax.tree.map(torch.from_numpy, params)
    ts = mine.init(tp)
    for i in range(5):
        g = jax.tree.map(lambda a: a * (i + 1), _tree(10 + i))
        u, st = ref.update(g, st, params)
        params = optax.apply_updates(params, u)
        new, ts = mine.update(tp, jax.tree.map(torch.from_numpy, g), ts)
        if i == 0 and name == "adamw-warmup-cosine":
            for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(new)):
                assert torch.equal(a, b)
        tp = new
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)
    assert ts[0].count == 5  # optax's layout: (ScaleByAdamState, ...)


@pytest.mark.parametrize("sched", ["cosine", "warmup-cosine", "linear"])
def test_schedules_match_optax(sched):
    if sched == "cosine":
        ref, mine = optax.cosine_decay_schedule(0.1, 10), optim.cosine_decay_schedule(0.1, 10)
    elif sched == "warmup-cosine":
        ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 31, 64)
        mine = optim.warmup_cosine_decay_schedule(0.0, 3e-4, 31, 64)
    else:
        ref, mine = optax.linear_schedule(1.0, 0.5, 7), optim.linear_schedule(1.0, 0.5, 7)
    for c in range(70):
        np.testing.assert_allclose(mine(c), float(ref(c)), rtol=1e-6, atol=1e-12)
    if sched == "warmup-cosine":
        assert mine(0) == 0.0
        np.testing.assert_allclose(mine(1), 9.678e-6, rtol=1e-4)


def _lm_data(steps, b=8, t=64, vocab=31, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, vocab, (steps, b, t)).astype(np.int32)
    y = np.roll(x, -1, axis=-1)
    return x, y


def test_three_sync_steps_match_the_jax_trainer(topo8):
    """The slice as a whole: an f32 flash transformer (1 layer, d_model 32,
    4 heads, T = 64), AdamW with warmup-cosine, W = 8, global batch 8; the
    params and the loss after each of three steps on one batch match the
    JAX trainer's (its attention through the Pallas kernels in interpret
    mode)."""
    x, y = _lm_data(1)
    jm = JaxLM(vocab_size=31, num_layers=1, d_model=32, num_heads=4, max_len=64,
               compute_dtype=jnp.float32, attn_impl="flash_force")
    jt = JaxDP(jm, optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 8)),
               topo8, donate_state=False)
    js = jt.init_state(jax.random.key(0), x[0, :1])
    pt = DataParallelTrainer(
        TransformerLM(31, num_layers=1, d_model=32, num_heads=4, max_len=64,
                      compute_dtype=torch.float32, attn_impl="flash", device="cpu"),
        optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 8)), CPU8,
    )
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.params), device="cpu"))
    losses = []
    for _ in range(3):
        js, jmet = jt.step(js, x[0], y[0])
        ps, pmet = pt.step(ps, x[0], y[0])
        losses.append(float(pmet["loss"]))
        np.testing.assert_allclose(losses[-1], float(jmet["loss"]), rtol=1e-6)
        for a, g in zip(jax.tree.leaves(js.params), jax.tree.leaves(to_flax(ps.params))):
            np.testing.assert_allclose(g, np.asarray(a), **TRAJ_TOL)
    assert ps.step == int(js.step) == 3
    assert losses[0] == losses[1]  # step 0's learning rate is 0
    ex, ey = _lm_data(1, b=16, seed=1)
    acc, loss = pt.evaluate(ps, ex[0], ey[0], batch=8)
    jacc, jloss = jt.evaluate(js, ex[0], ey[0], batch=8)
    assert acc == jacc
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)


def test_accumulation_equals_the_full_batch_step():
    x, y = _lm_data(1, b=16)
    make = lambda accum: DataParallelTrainer(  # noqa: E731
        TransformerLM(31, num_layers=1, d_model=32, num_heads=4, max_len=64,
                      compute_dtype=torch.float32, attn_impl="flash", device="cpu"),
        optim.Adam(1e-3), CPU8, accum_steps=accum)
    params = make(1).model.init(torch.Generator().manual_seed(0))
    out = []
    for accum in (1, 2):
        t = make(accum)
        s, m = t.step(t.init_state(params=params), x[0], y[0])
        out.append((s.params, float(m["loss"])))
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-6)
    for a, b in zip(jax.tree.leaves(out[0][0]), jax.tree.leaves(out[1][0])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="accum_steps"):
        make(3).step(make(3).init_state(params=params), x[0], y[0])
    with pytest.raises(ValueError, match="not divisible"):
        make(1).step(make(1).init_state(params=params), x[0, :12], y[0, :12])


@pytest.mark.parametrize("knob", [dict(quant="int8"), dict(bucket_bytes=1 << 20),
                                  "MPIT_DP_QUANT", "MPIT_DP_BUCKET_BYTES"])
def test_bucketed_exchange_is_not_ported(knob, monkeypatch):
    kwargs = knob if isinstance(knob, dict) else {}
    if isinstance(knob, str):
        monkeypatch.setenv(knob, "bf16" if knob == "MPIT_DP_QUANT" else "4096")
    with pytest.raises(NotImplementedError, match="A6"):
        DataParallelTrainer(TransformerLM(31, num_layers=1, d_model=32, num_heads=4,
                                          device="cpu"), optim.SGD(0.1), CPU8, **kwargs)


def test_run_trains_the_transformer_preset_on_cpu():
    """run() end to end on the CPU with ptb-transformer-large's optimizer
    and schedule, cut to 2 layers of width 32 and T = 64, flash attention
    through the plain versions; the results carry the reference's keys."""
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = dataclasses.replace(
        TrainConfig().apply_preset("ptb-transformer-large"), algo="sync",
        attn_impl="flash", layers=2, d_model=32, heads=4, seq_len=64,
        train_size=64, lr=3e-3, warmup_steps=2,
    )
    res = run(cfg, device="cpu")
    for key in ("accuracy", "eval_loss", "final_loss", "trained_units", "samples",
                "wall_s", "samples_per_sec", "step_time"):
        assert key in res
    assert res["trained_units"] == 64 // 8 and res["samples"] == 64
    losses = res["round_losses"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert 0.0 <= res["accuracy"] <= 1.0 and np.isfinite(res["eval_loss"])


@pytest.mark.parametrize("change", [
    dict(algo="seq-sync"), dict(optimizer="sgd"), dict(clip_norm=1.0),
    dict(remat=True), dict(algo="pp-sync"),
])
def test_run_refuses_transformer_options_not_ported(change):
    """pp-sync (A11) raises naming the ROADMAP; SGD and clip_norm, which
    raised until item A5b landed, and seq-sync and remat, which raised
    until item A9 landed, train the flash LM's preset."""
    from mpit_tpu_torch.run import run
    from mpit_tpu_torch.utils.config import TrainConfig

    cfg = dataclasses.replace(TrainConfig().apply_preset("ptb-transformer-large"),
                              **{"algo": "sync", **change})
    if change.get("algo") == "pp-sync":
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run(cfg, device="cpu")
        return
    res = run(dataclasses.replace(cfg, attn_impl="flash", layers=2, d_model=32,
                                  heads=4, seq_len=64, train_size=64, lr=3e-3,
                                  warmup_steps=2), device="cpu")
    assert res["trained_units"] == 8 and np.isfinite(res["round_losses"]).all()
