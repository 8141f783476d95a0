"""The port's optimizers, schedules, sync-DP trainer and driver against the
JAX package's, on the CPU, from the same init and the same data.

The JAX trainer runs W = 8 workers on the 8-device CPU mesh (``topo8``);
the port runs the same global batch on one CPU device, which is the same
mean gradient (see ``mpit_tpu_torch/parallel/sync.py``).
"""

import dataclasses
import json

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
from mpit_tpu_torch.parallel import sync as port_sync

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
    """Each knob of the bucketed exchange (ROADMAP A6, which raised until
    it landed) engages it, as the reference's do (``tests/test_sync_dp.py::
    TestBucketedExchange::test_env_knobs``): an argument or an environment
    variable; bucket bytes alone leave it unquantized; a step runs through
    it and reports the reference's metrics."""
    kwargs = knob if isinstance(knob, dict) else {}
    if isinstance(knob, str):
        monkeypatch.setenv(knob, "bf16" if knob == "MPIT_DP_QUANT" else "4096")
    trainer = DataParallelTrainer(TransformerLM(31, num_layers=1, d_model=32, num_heads=4,
                                                device="cpu"), optim.SGD(0.1), CPU8, **kwargs)
    env = knob if isinstance(knob, str) else None
    want_quant = {"MPIT_DP_QUANT": "bf16"}.get(env, kwargs.get("quant", "off"))
    want_bytes = {"MPIT_DP_BUCKET_BYTES": 4096}.get(env, kwargs.get("bucket_bytes", 4 << 20))
    assert trainer.bucketed and trainer.quant == want_quant
    assert trainer.bucket_bytes == want_bytes and trainer.wire_bytes_per_step() is None
    x, y = _lm_data(1)
    state, m = trainer.step(trainer.init_state(torch.Generator().manual_seed(0)), x[0], y[0])
    assert set(m) == {"loss", "param_norm", "update_norm"} and state.step == 1
    assert np.isfinite([float(v) for v in m.values()]).all()
    assert trainer.wire_bytes_per_step() > 0


def _lenet_data(n=64, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _lenet_runs(topo8, steps, **kw):
    """(reference trainer, its losses and params; the port's, from the
    reference's init) for ``steps`` of f32 LeNet, SGD 0.1 with momentum 0.9,
    W = 8, as ``tests/test_sync_dp.py::TestBucketedExchange`` runs it."""
    from mpit_tpu.models import LeNet as JaxLeNet
    from mpit_tpu_torch.models import LeNet

    x, y = _lenet_data()
    jt = JaxDP(JaxLeNet(compute_dtype=jnp.float32), optax.sgd(0.1, momentum=0.9), topo8,
               donate_state=False, **kw)
    js = jt.init_state(jax.random.key(0), x[:2])
    pt = DataParallelTrainer(LeNet(compute_dtype=torch.float32, device="cpu"),
                             optim.SGD(0.1, momentum=0.9), CPU8, **kw)
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.params), device="cpu"))
    jl, pl = [], []
    for _ in range(steps):
        js, jm = jt.step(js, x, y)
        ps, pm = pt.step(ps, x, y)
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    return (jt, jl, jax.tree.map(np.asarray, js.params)), (pt, pl, to_flax(ps.params))


# the port against the reference on the bucketed path, f32 LeNet: raw, the
# fused step's limits; int8 and bf16, the codes of gradients that differ in
# their last bits (the same sums in other orders) round alike but for an
# element near a half-way point, which moves by one code step: after 5
# steps losses within 1e-4 and params within 2e-3 (int8; measured 6.7e-5
# and 4.5e-4) and 1e-4 (bf16; measured 0 and 1.8e-5)
BUCKET_REF_TOL = {"off": (1e-5, 2e-5), "int8": (1e-4, 2e-3), "bf16": (1e-4, 1e-4)}


@pytest.mark.parametrize("quant", ["off", "int8", "bf16"])
def test_bucketed_steps_match_the_reference_trainer(quant, topo8):
    """``TestBucketedExchange``: 64 KiB buckets (several per step), raw for 3
    steps, int8 and bf16 for 5; the port tracks the reference's bucketed
    trainer within BUCKET_REF_TOL and the reference's fused trainer within
    its own limits of the bucketed path (raw: loss rtol 1e-5, params 2e-5;
    quantized: loss 2e-2, params 5e-3); the plan, the buckets and the wire
    bytes are the reference's; int8 puts under a third of raw's bytes on the
    wire."""
    steps = 3 if quant == "off" else 5
    (jt, jl, jp), (pt, pl, pp) = _lenet_runs(topo8, steps, quant=quant,
                                             bucket_bytes=64 << 10)
    (_, fl, fp), _ = _lenet_runs(topo8, steps) if quant != "off" else ((None, jl, jp), None)
    loss_tol, param_tol = BUCKET_REF_TOL[quant]
    assert pt.bucketed and len(pt._plan.buckets) == len(jt._plan.buckets) > 1
    assert pt.wire_bytes_per_step() == jt.wire_bytes_per_step()
    np.testing.assert_allclose(pl, jl, rtol=0, atol=loss_tol)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(pp), strict=True):
        np.testing.assert_allclose(b, a, rtol=0, atol=param_tol)
    if quant == "off":
        np.testing.assert_allclose(pl, jl, rtol=1e-5)
        return
    assert np.isfinite(pl).all()
    np.testing.assert_allclose(pl, fl, atol=2e-2)
    for a, b in zip(jax.tree.leaves(fp), jax.tree.leaves(pp)):
        np.testing.assert_allclose(b, a, atol=5e-3)
    raw = port_sync._BucketPlan(pt._plan.template, 8, 64 << 10, "off")
    if quant == "int8":
        assert pt.wire_bytes_per_step() < raw.wire_bytes_per_step() / 3
    assert all(r.abs().max() > 0 for r in pt._residual)  # error feedback is live


def test_both_knobs_off_is_the_fused_step(monkeypatch):
    """The port's counterpart of ``tests/test_perf_guards.py``: with both
    knobs off (and ``quant="off"`` given) the trainer is the fused one, its
    step never builds a plan, and its state is bit for bit the fused
    step's."""
    for k in ("MPIT_DP_QUANT", "MPIT_DP_BUCKET_BYTES"):
        monkeypatch.delenv(k, raising=False)
    x, y = _lm_data(1)
    make = lambda **kw: DataParallelTrainer(  # noqa: E731
        TransformerLM(31, num_layers=1, d_model=32, num_heads=4, max_len=64,
                      compute_dtype=torch.float32, device="cpu"), optim.Adam(1e-3), CPU8, **kw)
    params = make().model.init(torch.Generator().manual_seed(0))
    out = []
    for kw in ({}, dict(quant="off")):
        t = make(**kw)
        assert not t.bucketed
        s, m = t.step(t.init_state(params=params), x[0], y[0])
        assert set(m) == {"loss"} and t._plan is None and t.wire_bytes_per_step() is None
        out.append(s)
    for a, b in zip(jax.tree.leaves(out[0].params), jax.tree.leaves(out[1].params)):
        assert torch.equal(a, b)


def test_bucketed_exchange_refuses_bad_values():
    """A bad mode or bucket size raises as in the reference."""
    model = TransformerLM(31, num_layers=1, d_model=32, num_heads=4, device="cpu")
    with pytest.raises(ValueError, match="quant"):
        DataParallelTrainer(model, optim.SGD(0.1), CPU8, quant="fp4")
    with pytest.raises(ValueError, match="bucket_bytes"):
        DataParallelTrainer(model, optim.SGD(0.1), CPU8, bucket_bytes=0)


@pytest.mark.parametrize("quant", ["int8", "off"])
def test_bucketed_step_with_an_obs_dir_writes_its_journal(quant, monkeypatch, tmp_path):
    """``MPIT_OBS_DIR`` arms the bucketed step's journal: per step a
    ``compute`` span around the gradients, each bucket's encode (quantized
    only) and reduce, and the update, a ``send`` with each hop's bytes, and
    one ``dynamics`` record; the step's results are those of the unarmed
    trainer, bit for bit."""
    x, y = _lm_data(2)
    make = lambda: DataParallelTrainer(  # noqa: E731
        TransformerLM(31, num_layers=1, d_model=32, num_heads=4, max_len=64,
                      compute_dtype=torch.float32, device="cpu"),
        optim.SGD(0.1), CPU8, quant=quant, bucket_bytes=4096)
    plain = make()
    params = plain.model.init(torch.Generator().manual_seed(0))
    monkeypatch.setenv("MPIT_OBS_DIR", str(tmp_path))
    traced = make()
    s0, s1 = plain.init_state(params=params), traced.init_state(params=params)
    for i in range(2):
        s0, _ = plain.step(s0, x[i], y[i])
        s1, _ = traced.step(s1, x[i], y[i])
    traced.close_obs()
    for a, b in zip(jax.tree.leaves(s0.params), jax.tree.leaves(s1.params)):
        assert torch.equal(a, b)
    recs = [json.loads(line) for line in open(tmp_path / "obs_rank0.jsonl")]
    kinds = [(r["ev"], r.get("name")) for r in recs if r["ev"] != "span_e"]
    nb = len(traced._plan.buckets)
    per_bucket = ([("span_b", "compute")] if quant != "off" else []) + [
        ("send", None), ("span_b", "compute"), ("send", None)]
    step = [("span_b", "compute"), *per_bucket * nb, ("span_b", "compute"), ("dynamics", None)]
    assert nb > 1 and kinds == step * 2
    hops = [r["bytes"] for r in recs if r["ev"] == "send"]
    assert hops == [b.hop_bytes for b in traced._plan.buckets for _ in (0, 1)] * 2
    dyn = [r for r in recs if r["ev"] == "dynamics"]
    assert [d["round"] for d in dyn] == [1, 2] and all(d["algo"] == "sync-dp" for d in dyn)
    assert all((d["elastic"] > 0) == (quant != "off") for d in dyn)


def test_resnet50_at_lr_01_rises_in_both_packages(topo8):
    """ROADMAP C6: ``resnet50-sync``'s loss rises at its lr 0.1 (momentum
    0.9). Six f32 sync steps of ResNet-50 at (1, 1, 1, 1) blocks, 64², W = 8,
    16 fresh random images a step, from the same weights: the reference's
    loss rises as the port's does (7.1 to 37 here), step by step within 1%
    (a diverging trajectory grows the last-bit differences of the convs'
    sums: 4e-3 relative by step 6), so the rise is the preset's own."""
    from mpit_tpu.models.resnet import ResNet50 as JaxResNet
    from mpit_tpu_torch.models.resnet import ResNet50

    rng = np.random.default_rng(0)
    steps, b, size = 6, 16, 64
    x = rng.uniform(0, 1, (steps, b, size, size, 3)).astype(np.float32)
    y = rng.integers(0, 1000, (steps, b)).astype(np.int32)
    jt = JaxDP(JaxResNet(stage_sizes=(1, 1, 1, 1), compute_dtype=jnp.float32),
               optax.sgd(0.1, momentum=0.9), topo8, donate_state=False)
    js = jt.init_state(jax.random.key(0), x[0, :2])
    pt = DataParallelTrainer(ResNet50(stage_sizes=(1, 1, 1, 1), in_shape=(size, size, 3),
                                      compute_dtype=torch.float32, device="cpu"),
                             optim.SGD(0.1, momentum=0.9), CPU8)
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.params), device="cpu"))
    jl, pl = [], []
    for i in range(steps):
        js, jm = jt.step(js, x[i], y[i])
        ps, pm = pt.step(ps, x[i], y[i])
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    np.testing.assert_allclose(pl, jl, rtol=1e-2)
    assert jl[-1] > 2 * jl[0] and pl[-1] > 2 * pl[0]


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


@pytest.mark.parametrize("case", ["lenet", "lm"])
def test_run_under_mpit_dp_quant_int8_matches_the_references_run(case, tmp_path,
                                                                 monkeypatch):
    """``run()`` of ``--algo sync`` with ``MPIT_DP_QUANT=int8`` (the
    bucketed int8 exchange at the 4 MiB default): ``mnist-easgd``'s bf16
    LeNet and a narrow bf16 ``ptb-transformer-large``. The reference trains
    the first epoch and checkpoints (the packages initialize from their own
    generators); both resume from copies of that file, the residuals from
    zero as the checkpoint holds none; losses, eval and final params within
    the bf16 trajectory tolerance (``tests/test_torch_checkpoint.py``)."""
    import shutil

    from mpit_tpu.run import run as ref_run
    from mpit_tpu_torch.run import run as port_run
    from mpit_tpu_torch.utils import checkpoint as ckpt
    from mpit_tpu_torch.utils.config import TrainConfig

    monkeypatch.setenv("MPIT_DP_QUANT", "int8")
    if case == "lm":
        cfg = dataclasses.replace(
            TrainConfig().apply_preset("ptb-transformer-large"), algo="sync",
            attn_impl="flash", layers=2, d_model=32, heads=4, seq_len=64, train_size=64,
            lr=3e-3, warmup_steps=2, global_batch=16)
    else:
        cfg = dataclasses.replace(TrainConfig().apply_preset("mnist-easgd"), algo="sync",
                                  train_size=256, global_batch=64)
    ref_run(dataclasses.replace(cfg, epochs=1, ckpt_dir=str(tmp_path / "first")))
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / name)
    resumed = dataclasses.replace(cfg, epochs=2, resume=True)
    r = ref_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "ref")))
    p = port_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "port")), device="cpu")
    for key in ("workers", "trained_units", "samples", "resumed_from", "last_checkpoint"):
        assert p[key] == r[key], key
    tol = dict(rtol=0, atol=5e-3)
    for key in ("final_loss", "eval_loss", "accuracy"):
        # the LM's eval loss sums a window's tokens: compared per token
        per = cfg.seq_len if case == "lm" and key == "eval_loss" else 1
        np.testing.assert_allclose(p[key] / per, r[key] / per, **tol, err_msg=key)
    step = r["last_checkpoint"]
    want, got = (ckpt.msgpack_restore(open(tmp_path / d / f"ckpt_{step:08d}.msgpack",
                                           "rb").read()) for d in ("ref", "port"))
    for a, b in zip(jax.tree.leaves(want["params"]), jax.tree.leaves(got["params"]),
                    strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **tol)
