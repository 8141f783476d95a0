"""Checkpoints of the port in the reference's file format, against the
JAX package: the bytes of a state equal ``flax.serialization.to_bytes``
of the reference's, stacked conv leaves map to the flax layout, either
package resumes from the other's files, a resume is bit-identical to the
uninterrupted run, and a resumed ``cifar-vgg-sync`` climbs as the
reference's does. All on the CPU; the JAX side on the 8-device CPU mesh
(``topo8``)."""

import dataclasses
import functools
import json
import os
import shutil

import flax.serialization
import jax
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models import LeNet as JaxLeNet
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.parallel import DataParallelTrainer as JaxDP
from mpit_tpu.parallel import DownpourTrainer as JaxDownpour
from mpit_tpu.parallel import EASGDTrainer as JaxEASGD
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import LeNet, TransformerLM
from mpit_tpu_torch.parallel import DataParallelTrainer, DownpourTrainer, EASGDTrainer
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.config import TrainConfig

CPU = torch.device("cpu")
CPU8 = Topology(num_workers=8, device=CPU)
# the f32 trajectory tolerance of tests/test_torch_easgd.py
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
# mnist-easgd's LeNet computes in bf16, which run() cannot change: XLA and
# PyTorch round its activations and products differently by a few bf16
# ulps (tests/test_torch_lenet.py's BF16_TOL on logits), and two rounds of
# momentum SGD from one state carry that to 1.6e-3 on centers of size 0.02
# to 0.5 (the same rounds in f32 agree to 3e-7 relative). 5e-3 absolute
# leaves room; TRAJ_TOL holds the f32 trainers.
BF16_TRAJ_TOL = dict(rtol=0, atol=5e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomized(state, seed):
    """The reference's state with every float leaf replaced by seeded
    values and every counter by a nonzero int, so no leaf is a zero or a
    copy of another."""
    rng = np.random.default_rng(seed)

    def leaf(a):
        a = np.asarray(a)
        if a.dtype == np.int32:
            return np.full(a.shape, 7, np.int32)
        return rng.normal(size=a.shape).astype(a.dtype)

    return jax.tree.map(leaf, state)


def _ref_and_port_state(case, topo8):
    x = np.zeros((2, 28, 28, 1), np.float32)
    opt_r = optax.chain(optax.clip_by_global_norm(1.0),
                        optax.sgd(optax.cosine_decay_schedule(0.05, 10), momentum=0.9))
    opt_m = optim.chain(optim.clip_by_global_norm(1.0),
                        optim.SGD(optim.cosine_decay_schedule(0.05, 10), 0.9))
    if case == "lenet-easgd":
        js = JaxEASGD(JaxLeNet(), opt_r, topo8, tau=2).init_state(jax.random.key(0), x)
        pt = EASGDTrainer(LeNet(device="cpu"), opt_m, CPU8, tau=2)
    elif case == "lenet-downpour":
        js = JaxDownpour(JaxLeNet(), opt_r, topo8, tau=2, staleness=1).init_state(
            jax.random.key(0), x)
        pt = DownpourTrainer(LeNet(device="cpu"), opt_m, CPU8, tau=2, staleness=1)
    elif case == "lenet-sync":
        js = JaxDP(JaxLeNet(), opt_r, topo8).init_state(jax.random.key(0), x)
        pt = DataParallelTrainer(LeNet(device="cpu"), opt_m, CPU8)
    else:  # the 2-layer transformer, AdamW under warmup-cosine
        jm = JaxLM(vocab_size=31, num_layers=2, d_model=32, num_heads=4, max_len=64)
        js = JaxDP(jm, optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 8)),
                   topo8).init_state(jax.random.key(0), np.zeros((1, 64), np.int32))
        pt = DataParallelTrainer(
            TransformerLM(31, num_layers=2, d_model=32, num_heads=4, max_len=64,
                          device="cpu"),
            optim.AdamW(optim.warmup_cosine_decay_schedule(0.0, 3e-4, 2, 8)), CPU8)
    return js, pt.init_state(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", ["lenet-easgd", "lenet-downpour", "lenet-sync",
                                  "transformer-adamw"])
def test_checkpoint_bytes_equal_flax_to_bytes(case, topo8, tmp_path):
    """The port's checkpoint of a state holding the reference's values is
    ``flax.serialization.to_bytes`` of the reference's state, byte for
    byte (LeNet's stacked 5-D conv leaves, the clip chain with a schedule's
    ``(W,)`` counts, the Downpour ring, AdamW's moments); the reference
    reads the port's file back to the same values, and the port restores
    the reference's bytes into its own state."""
    js, template = _ref_and_port_state(case, topo8)
    js = _randomized(jax.device_get(js), 1)
    want = flax.serialization.to_bytes(js)
    (tmp_path / "ckpt_00000007.msgpack").write_bytes(want)
    port, step = ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 7
    path = ckpt.save_checkpoint(str(tmp_path / "port"), port, step=7)
    got = open(path, "rb").read()
    assert got == want
    back = flax.serialization.from_bytes(js, got)
    for a, b in zip(jax.tree.leaves(js), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_stacked_conv_leaves_and_their_trace_round_trip_through_the_flax_layout(topo8):
    """``convert.to_flax``/``from_flax`` map a stacked (5-D) conv kernel
    between ``(W, O, I, kh, kw)`` and ``(W, kh, kw, I, O)``: the stacked
    LeNet and its momentum trace of a port EASGD state equal the
    reference's ``_stack`` of the same tree, and come back unchanged."""
    model = LeNet(device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    pt = EASGDTrainer(model, optim.SGD(0.05, 0.9), CPU8, tau=2)
    ps = pt.init_state(params=params)
    trace = jax.tree.map(lambda t: t * 3 - 1, ps.worker_params)
    for tree in (ps.worker_params, trace):
        flat = to_flax(tree)
        stacked_ref = jax.tree.map(lambda a: np.broadcast_to(a[None], (8, *a.shape)),
                                   to_flax(jax.tree.map(lambda t: t[0], tree)))
        for a, b in zip(jax.tree.leaves(flat), jax.tree.leaves(stacked_ref)):
            assert a.shape == b.shape and np.array_equal(a, b)
        assert flat["Conv_1"]["kernel"].shape == (8, 5, 5, 32, 64)
        back = from_flax(flat, device="cpu")
        for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
            assert torch.equal(a, b) and b.is_contiguous()


# ------------------------------------------------------------- run()


def _cfg(preset, **over):
    return dataclasses.replace(TrainConfig().apply_preset(preset), **over)


def _port_run(cfg):
    from mpit_tpu_torch.run import run

    return run(cfg, device="cpu")


def _ref_run(cfg):
    from mpit_tpu.run import run

    return run(cfg)


def _load(path):
    return ckpt.msgpack_restore(open(path, "rb").read())


def _assert_states_close(a, b, tol):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape and x.dtype == y.dtype
        if x.dtype == np.int32:
            assert np.array_equal(x, y)
        else:
            np.testing.assert_allclose(x, y, **tol)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_of_either_package_resumes_in_the_other(writer, topo8, tmp_path):
    """``mnist-easgd`` (``train_size`` 512, global batch 64: two rounds an
    epoch): one package's ``run()`` trains the first epoch and
    checkpoints. Both packages restore that file to the same values, bit
    for bit; both packages' ``run()`` resume from copies of it and train
    the second epoch with the reference's counters and units, their
    losses within 1e-3 and their centers within BF16_TRAJ_TOL (the
    preset's LeNet is bf16)."""
    from mpit_tpu.utils.checkpoint import restore_checkpoint as ref_restore

    base = _cfg("mnist-easgd", train_size=512, global_batch=64)
    first = _ref_run if writer == "reference" else _port_run
    first(dataclasses.replace(base, epochs=1, ckpt_dir=str(tmp_path / "first")))

    x = np.zeros((2, 28, 28, 1), np.float32)
    template = JaxEASGD(JaxLeNet(), optax.sgd(base.lr, momentum=base.momentum),
                        topo8, tau=4).init_state(jax.random.key(1), x)
    js, _ = ref_restore(str(tmp_path / "first"), template,
                        shardings=jax.tree.map(lambda a: a.sharding, template))
    pt = EASGDTrainer(LeNet(device="cpu"), optim.SGD(base.lr, base.momentum), CPU8, tau=4)
    ps, step = ckpt.restore_checkpoint(str(tmp_path / "first"),
                                      pt.init_state(torch.Generator().manual_seed(1)))
    assert step == 2 and ps.round == int(js.round) == 2
    want = flax.serialization.to_state_dict(jax.device_get(js))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(ckpt.state_to_host(ps)),
                    strict=True):
        assert np.array_equal(np.asarray(a), b)

    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / name)
    resumed = dataclasses.replace(base, epochs=2, resume=True)
    r = _ref_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "ref")))
    p = _port_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "port")))
    for res in (r, p):
        assert res["resumed_from"] == 2 and res["trained_units"] == 2
        assert res["last_checkpoint"] == 4
    np.testing.assert_allclose(p["final_loss"], r["final_loss"], rtol=1e-3)
    want, got = (_load(tmp_path / d / "ckpt_00000004.msgpack") for d in ("ref", "port"))
    assert want["round"] == got["round"] == 4
    _assert_states_close(want["center"], got["center"], BF16_TRAJ_TOL)


def test_resume_matches_uninterrupted_schedule(tmp_path):
    """Interrupted and resumed training is bit-identical to uninterrupted
    (``tests/test_run_presets.py:186-216``), here with Adam, clip_norm and
    W = 8 stacked workers: the resumed run re-enters the same per-epoch
    data permutations."""
    base = _cfg("mnist-easgd", train_size=512, global_batch=64, optimizer="adam",
                lr=1e-3, clip_norm=1.0)
    straight = _port_run(dataclasses.replace(base, epochs=2, ckpt_dir=str(tmp_path / "a")))
    _port_run(dataclasses.replace(base, epochs=1, ckpt_dir=str(tmp_path / "b")))
    resumed = _port_run(dataclasses.replace(base, epochs=2, ckpt_dir=str(tmp_path / "b"),
                                            resume=True))
    assert straight["last_checkpoint"] == resumed["last_checkpoint"] == 4
    a = (tmp_path / "a" / "ckpt_00000004.msgpack").read_bytes()
    b = (tmp_path / "b" / "ckpt_00000004.msgpack").read_bytes()
    assert a == b, "resumed state diverged from uninterrupted state"
    assert straight["round_losses"][2:] == resumed["round_losses"]


@pytest.mark.parametrize("preset,over,ckpt_every", [
    ("mnist-easgd", dict(lr_schedule="cosine", train_size=512, global_batch=64), 2),
    ("ptb-transformer-large", dict(algo="sync", attn_impl="flash", layers=2,
                                   d_model=32, heads=4, seq_len=64, train_size=64,
                                   clip_norm=1.0), 4),
    ("alexnet-downpour", dict(model="mlp", dataset="mnist", optimizer="adamw",
                              lr=1e-3, lr_schedule="warmup-cosine", warmup_steps=2,
                              train_size=512, global_batch=64, tau=2), 2),
], ids=["easgd-cosine", "sync-lm-warmup-cosine-clip", "downpour-adamw"])
def test_a_preempted_scheduled_run_resumes_bit_identically(preset, over, ckpt_every,
                                                           tmp_path):
    """A schedule's horizon is the whole run (``epochs`` is the total), so
    a preempted run is the straight run cut at a checkpoint: resuming from
    a copy of its mid-run checkpoint gives the straight run's final file
    byte for byte, for each trainer (EASGD, sync with the flash LM,
    Downpour)."""
    base = _cfg(preset, **over, epochs=2)
    straight = _port_run(dataclasses.replace(base, ckpt_dir=str(tmp_path / "a"),
                                             ckpt_every=ckpt_every))
    last = straight["last_checkpoint"]
    mid = last // 2
    os.makedirs(tmp_path / "b")
    for ext in ("msgpack", "json"):
        shutil.copy(tmp_path / "a" / f"ckpt_{mid:08d}.{ext}", tmp_path / "b")
    resumed = _port_run(dataclasses.replace(base, ckpt_dir=str(tmp_path / "b"),
                                            resume=True))
    assert resumed["resumed_from"] == mid and resumed["trained_units"] == last - mid
    assert ((tmp_path / "a" / f"ckpt_{last:08d}.msgpack").read_bytes()
            == (tmp_path / "b" / f"ckpt_{last:08d}.msgpack").read_bytes())


def test_metrics_checkpoint_and_unit_count_on_resume(tmp_path):
    """``tests/test_run_presets.py:171-202`` on the port: periodic saves
    with the config as metadata, ``last_checkpoint``; ``epochs`` is the
    total, so resuming a finished one-epoch run with ``epochs=2`` trains
    exactly the second epoch, and resuming with nothing left is a no-op."""
    cfg = _cfg("mnist-easgd", train_size=512, global_batch=64, epochs=1,
               metrics_path=str(tmp_path / "m.jsonl"), ckpt_dir=str(tmp_path / "ck"),
               ckpt_every=1, log_every=1)
    r = _port_run(cfg)
    assert r["trained_units"] == 2 and r["last_checkpoint"] == 2
    lines = [json.loads(line) for line in open(tmp_path / "m.jsonl").read().splitlines()]
    assert [line["step"] for line in lines] == [1, 2]
    meta = json.load(open(tmp_path / "ck" / "ckpt_00000002.json"))
    assert json.loads(meta["config"])["preset"] == "mnist-easgd" and meta["step"] == 2
    r2 = _port_run(dataclasses.replace(cfg, resume=True, epochs=2, metrics_path=None))
    assert (r2["resumed_from"], r2["trained_units"], r2["last_checkpoint"]) == (2, 2, 4)
    r3 = _port_run(dataclasses.replace(cfg, resume=True, epochs=2, metrics_path=None))
    assert r3["trained_units"] == 0 and r3["last_checkpoint"] == 4
    assert ckpt.list_checkpoints(str(tmp_path / "ck")) == [2, 3, 4]


# the bf16 tolerance tests/test_torch_models.py holds VGG's logits to
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def test_vgg_resumed_from_the_references_step_2_climbs_as_the_reference_does(
        topo8, tmp_path, monkeypatch):
    """``cifar-vgg-sync`` (``train_size`` 512, global batch 64): the
    reference's ``run()`` checkpoints at step 2 (every checkpoint kept);
    both packages' sync trainers, bf16 VGG-small as ``run()`` builds them,
    restore that file and take steps 3-6 on the run's own batches. Their
    losses agree within VGG's bf16 tolerance at every step, so the climb
    of the loss after step 2 and its fall belong to the preset, not to the
    port."""
    import mpit_tpu.utils
    from mpit_tpu import run as ref
    from mpit_tpu.utils.checkpoint import restore_checkpoint as ref_restore
    from mpit_tpu_torch import run as port
    from mpit_tpu_torch.data import Batches

    monkeypatch.setattr(mpit_tpu.utils, "save_checkpoint",
                        functools.partial(mpit_tpu.utils.save_checkpoint, keep=100))
    cfg = _cfg("cifar-vgg-sync", train_size=512, global_batch=64, epochs=1,
               ckpt_dir=str(tmp_path / "all"), ckpt_every=2)
    first = _ref_run(cfg)
    assert first["trained_units"] == 8
    os.makedirs(tmp_path / "two")
    for ext in ("msgpack", "json"):
        shutil.copy(tmp_path / "all" / f"ckpt_00000002.{ext}", tmp_path / "two")

    x, y, _, _, meta = port._load_dataset(cfg)
    total = cfg.epochs * (len(x) // cfg.global_batch)
    jt = ref.build_trainer(cfg, ref._build_model(cfg, meta), ref.build_optimizer(cfg, total),
                           topo8)
    template = jt.init_state(jax.random.key(cfg.seed), x[:2])
    js, _ = ref_restore(str(tmp_path / "two"), template,
                        shardings=jax.tree.map(lambda a: a.sharding, template))
    pt = port.build_trainer(cfg, port.build_model(cfg, CPU, meta),
                            port.build_optimizer(cfg, total), CPU8)
    ps, step = ckpt.restore_checkpoint(str(tmp_path / "two"),
                                      pt.init_state(torch.Generator().manual_seed(0)))
    assert step == 2 and ps.step == int(js.step) == 2
    batches = list(Batches(x, y, global_batch=64, seed=cfg.seed).epoch(0))[2:6]
    losses = []
    for bx, by in batches:
        js, jm = jt.step(js, bx, by)
        ps, pm = pt.step(ps, bx, by)
        losses.append((float(jm["loss"]), float(pm["loss"])))
    want, got = np.array(losses).T
    print(f"cifar-vgg-sync steps 3-6 from the reference's step 2: reference "
          f"{want.tolist()}, port {got.tolist()}")
    np.testing.assert_allclose(got, want, **BF16_TOL)
    assert want.max() > 2.5  # the climb above ln 10 is there in the reference


