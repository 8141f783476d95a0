"""The driver's last flags in the port against the JAX package's: the
optimizer chain (every optimizer under every schedule, ``clip_norm``,
per-worker clipping), ``run()`` taking every flag of ROADMAP item A5b
under every algo, the resume-layout guard and ``profile_dir``. The
checkpoint format and resume are in ``tests/test_torch_checkpoint.py``.
All on the CPU; the JAX side on the 8-device CPU mesh (``topo8``)."""

import dataclasses
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models import LeNet as JaxLeNet
from mpit_tpu.parallel import EASGDTrainer as JaxEASGD
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.parallel import EASGDTrainer
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.config import TrainConfig

CPU = torch.device("cpu")
CPU8 = Topology(num_workers=8, device=CPU)
# the f32 trajectory tolerance of tests/test_torch_easgd.py
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed, lead=()):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(*lead, 5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(*lead, 4)).astype(np.float32)}}


def _pair(name, clip):
    """(optax transformation, the port's optimizer) for a case name."""
    sched_ref = {"constant": 1e-2, "cosine": optax.cosine_decay_schedule(1e-2, 4),
                 "warmup-cosine": optax.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)}
    sched_mine = {"constant": 1e-2, "cosine": optim.cosine_decay_schedule(1e-2, 4),
                  "warmup-cosine": optim.warmup_cosine_decay_schedule(0.0, 1e-2, 2, 6)}
    opt, sched = name.split(":")
    lr_r, lr_m = sched_ref[sched], sched_mine[sched]
    if opt == "sgd":
        ref, mine = optax.sgd(lr_r, momentum=0.9), optim.SGD(lr_m, 0.9)
    elif opt == "sgd0":
        ref, mine = optax.sgd(lr_r, momentum=0.0), optim.SGD(lr_m, 0.0)
    elif opt == "adam":
        ref, mine = optax.adam(lr_r), optim.Adam(lr_m)
    else:
        ref, mine = optax.adamw(lr_r, weight_decay=1e-2), optim.AdamW(lr_m, 1e-2)
    if clip is not None:
        ref = optax.chain(optax.clip_by_global_norm(clip), ref)
        mine = optim.chain(optim.clip_by_global_norm(clip), mine)
    return ref, mine


OPT_CASES = [f"{o}:{s}" for o in ("sgd", "sgd0", "adam", "adamw")
             for s in ("constant", "cosine", "warmup-cosine")]


@pytest.mark.parametrize("clip", [None, 1.0, 100.0], ids=["noclip", "clipped", "unclipped"])
@pytest.mark.parametrize("stacked", [False, True], ids=["tree", "stacked"])
@pytest.mark.parametrize("name", OPT_CASES)
def test_optimizer_chain_matches_optax(name, stacked, clip):
    """Five steps from the same params and gradients, against optax at
    rtol 1e-6; stacked: W = 3 workers on dim 0 against the reference's
    vmapped worker optimizer (each worker clips by its own norm; the
    gradients differ in scale per worker, so the clip engages for some
    and not others). The state's layout is optax's, leaf for leaf."""
    ref, mine = _pair(name, clip)
    lead = (3,) if stacked else ()
    params = _tree(0, lead)
    if stacked:
        st = jax.vmap(ref.init)(params)
        upd = jax.vmap(ref.update)
    else:
        st, upd = ref.init(params), ref.update
    tp = jax.tree.map(torch.from_numpy, params)
    ts = mine.init(tp)
    scale = np.array([0.05, 1.0, 20.0], np.float32).reshape(3, 1) if stacked else 1.0
    for i in range(5):
        g = jax.tree.map(
            lambda a: a * (i + 1) * (scale.reshape(3, *[1] * (a.ndim - 1))
                                     if stacked else scale),
            _tree(10 + i, lead))
        u, st = upd(g, st, params)
        params = optax.apply_updates(params, u)
        tp, ts = mine.update(tp, jax.tree.map(torch.from_numpy, g), ts,
                             per_worker=stacked)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(tp)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-9)
    want = flax.serialization.to_state_dict(st)
    got = ckpt.state_to_state_dict(ts, lead=lead)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert b.shape == np.shape(a) and b.dtype == np.asarray(a).dtype
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-9)


def _rounds(seed, rounds, tau, w, b, shape):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (rounds, tau, w * b, *shape)).astype(np.float32)
    ys = rng.integers(0, 10, (rounds, tau, w * b)).astype(np.int32)
    return xs, ys


def test_per_worker_clipping_under_easgd_matches_the_reference_trainer(topo8):
    """LeNet f32, W = 8, τ = 2, the clip chained in front of SGD with
    momentum and a cosine schedule: each worker clips its own gradient by
    its own norm, as the reference's vmapped worker optimizer does. The
    center after each of three rounds matches at TRAJ_TOL; the clip
    engages (a limit below the gradients' norms)."""
    tau, b, clip = 2, 2, 0.5
    xs, ys = _rounds(0, 3, tau, 8, b, (28, 28, 1))
    jt = JaxEASGD(
        JaxLeNet(compute_dtype=jnp.float32),
        optax.chain(optax.clip_by_global_norm(clip),
                    optax.sgd(optax.cosine_decay_schedule(0.05, 6), momentum=0.9)),
        topo8, tau=tau, donate_state=False,
    )
    js = jt.init_state(jax.random.key(0), xs[0, 0, :2])
    pt = EASGDTrainer(
        LeNet(compute_dtype=torch.float32, device="cpu"),
        optim.chain(optim.clip_by_global_norm(clip),
                    optim.SGD(optim.cosine_decay_schedule(0.05, 6), 0.9)),
        CPU8, tau=tau,
    )
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.center), device="cpu"))
    grads, _ = pt._grad(ps.worker_params, torch.as_tensor(xs[0, 0]).reshape(8, b, 28, 28, 1),
                        torch.as_tensor(ys[0, 0]).reshape(8, b))
    norms = torch.stack([g.reshape(8, -1).norm(dim=1) for g in jax.tree.leaves(grads)]).norm(dim=0)
    assert (norms > clip).all()
    for r in range(3):
        js, jm = jt.step(js, xs[r], ys[r])
        ps, pm = pt.step(ps, xs[r], ys[r])
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        for a, g in zip(jax.tree.leaves(js.center), jax.tree.leaves(to_flax(ps.center))):
            np.testing.assert_allclose(g, np.asarray(a), **TRAJ_TOL)
    want = flax.serialization.to_state_dict(js.worker_opt)
    got = ckpt.state_to_state_dict(ps).get("worker_opt")
    assert jax.tree.structure(got) == jax.tree.structure(want)
    assert int(got["1"]["1"]["count"][0]) == 6 and got["1"]["1"]["count"].shape == (8,)




def _cfg(preset, **over):
    return dataclasses.replace(TrainConfig().apply_preset(preset), **over)


def _port_run(cfg):
    from mpit_tpu_torch.run import run

    return run(cfg, device="cpu")


def _ref_run(cfg):
    from mpit_tpu.run import run

    return run(cfg)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_optimizer_structure_mismatch_is_refused_on_resume(package, tmp_path):
    """``tests/test_run_presets.py:150-169``: a checkpoint written with SGD
    refuses a resume with Adam, with a schedule or with clip_norm (the
    optimizer state's structure differs) before the restore, with the
    same message in both packages; a value-only change resumes."""
    go = _ref_run if package == "reference" else _port_run
    base = _cfg("mnist-easgd", train_size=256, global_batch=64, epochs=1,
                ckpt_dir=str(tmp_path / "ck"))
    go(base)
    with pytest.raises(ValueError, match="optimizer"):
        go(dataclasses.replace(base, resume=True, epochs=2, optimizer="adam"))
    for change in (dict(lr_schedule="cosine"), dict(clip_norm=0.5)):
        with pytest.raises(ValueError, match="layout mismatch"):
            go(dataclasses.replace(base, resume=True, epochs=2, **change))
    r = go(dataclasses.replace(base, resume=True, epochs=2, lr=0.01, momentum=0.5))
    assert r["resumed_from"] == 1 and r["trained_units"] == 1


def test_profile_dir_writes_a_trace(tmp_path):
    """``tests/test_run_presets.py:307-311``: ``profile_dir`` writes a
    Chrome trace of the loop (host operators here, on the CPU), for the
    collective path and the PS path."""
    _port_run(_cfg("mnist-easgd", train_size=256, global_batch=64, epochs=1,
                   profile_dir=str(tmp_path / "tr")))
    _port_run(_cfg("mnist-ps", model="mlp", steps=8, train_size=512,
                   transport="inproc", profile_dir=str(tmp_path / "ps")))
    for d in ("tr", "ps"):
        (name,) = os.listdir(tmp_path / d)
        assert name.endswith(".pt.trace.json")
        events = json.load(open(tmp_path / d / name))["traceEvents"]
        assert any(e.get("cat") == "cpu_op" for e in events)



def test_run_sets_deterministic_convolutions():
    """ROADMAP C7: ``run()`` turns on cuDNN's deterministic algorithms and
    turns off its autotuning before it builds a trainer, so a run repeats
    bit for bit on the card (``chip_smoke.py``'s ``conv-determinism``)."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = False, True
    try:
        _port_run(_cfg("mnist-easgd", model="mlp", algo="sync", train_size=256,
                       global_batch=64, epochs=1))
        assert torch.backends.cudnn.deterministic is True
        assert torch.backends.cudnn.benchmark is False
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup-cosine"])
@pytest.mark.parametrize("optimizer", ["sgd", "adam", "adamw"])
@pytest.mark.parametrize("algo", ["easgd", "downpour", "sync", "ps-easgd", "ps-downpour"])
def test_run_takes_every_optimizer_under_every_schedule_with_clip_and_checkpoints(
        algo, optimizer, schedule, tmp_path):
    """What item A5b covers, under every algo the port has: each optimizer
    with each schedule, clip_norm chained in, a checkpoint written and
    resumed from, the losses finite (the MLP on MNIST, small)."""
    cfg = _cfg("mnist-easgd", model="mlp", algo=algo, optimizer=optimizer,
               lr=0.05 if optimizer == "sgd" else 1e-3, lr_schedule=schedule,
               warmup_steps=2, clip_norm=1.0, train_size=256, global_batch=64,
               epochs=1, steps=4, transport="inproc", ckpt_dir=str(tmp_path))
    r = _port_run(cfg)
    if algo.startswith("ps-"):
        assert r["last_checkpoint"] == 4 and r["dead_clients"] == []
        assert all(np.isfinite(l).all() for l in r["client_losses"])
        again = _port_run(dataclasses.replace(cfg, resume=True))
        assert again["center_restored"]
        return
    assert r["last_checkpoint"] == r["trained_units"] > 0
    assert np.isfinite(r["round_losses"]).all()
    again = _port_run(dataclasses.replace(cfg, epochs=2, resume=True))
    assert again["resumed_from"] == r["trained_units"] == again["trained_units"]
