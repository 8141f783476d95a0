"""The reference's public surface on the port, against the JAX package on
the CPU mesh:

- the pipeline trainer takes its batch axis by position: on a
  ``("data", "pp")`` world two gpipe steps are bit-equal to the ``("dp",
  "pp")`` run and within ``test_torch_pipeline.py``'s tolerances (losses
  2e-5 relative, params 2e-4) of the reference's trainer on the same mesh;
- ``loss_fn`` (a custom L2 loss over raw params, ``model=None``) for
  :class:`DataParallelTrainer` and :class:`ZeroDataParallelTrainer`: two
  steps against the reference's trainers, f32 within 1e-6;
- ``fit(log_every=)`` prints the reference's lines, character for
  character;
- ``DeviceBatches``, ``Throughput``, ``StepTimer``, ``tree_zeros_like``,
  ``second_axis_for`` and ``MetricsLogger(all_processes=)`` as the
  reference's (``tests/test_utils_aux.py``, ``tests/test_data.py``,
  ``mpit_tpu/run.py:158``).
"""

import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpit_tpu
from mpit_tpu.data import Batches as RefBatches
from mpit_tpu.data import DeviceBatches as RefDeviceBatches
from mpit_tpu.parallel import DataParallelTrainer as RefSync
from mpit_tpu.parallel import ZeroDataParallelTrainer as RefZero
from mpit_tpu.parallel import common as ref_common
from mpit_tpu.parallel import pipeline as ref_pp
from mpit_tpu.run import second_axis_for as ref_second_axis_for
from mpit_tpu.utils import MetricsLogger as RefMetricsLogger
from mpit_tpu.utils import tree_zeros_like as ref_tree_zeros_like
from mpit_tpu.utils.config import TrainConfig as RefConfig
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.data import Batches, DeviceBatches
from mpit_tpu_torch.parallel import DataParallelTrainer, ZeroDataParallelTrainer
from mpit_tpu_torch.parallel import pipeline as pp
from mpit_tpu_torch.run import _world_for, second_axis_for
from mpit_tpu_torch.utils import MetricsLogger, StepTimer, Throughput, tree_zeros_like
from mpit_tpu_torch.utils.config import TrainConfig

CPU = torch.device("cpu")
V, T, L, D, H = 23, 16, 4, 32, 4
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-4)
TIGHT = dict(rtol=1e-6, atol=1e-6)


def _tokens(b=8, seed=0):
    x = np.random.default_rng(seed).integers(0, V, (b, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def test_pipeline_takes_its_batch_axis_by_position(monkeypatch):
    # one init for both packages: the port's draw, placed by the
    # reference's init_state (its own draw is eager and slow on the CPU)
    init = to_flax(pp.init_params(torch.Generator().manual_seed(0), V, L, D, 4 * D, T,
                                  num_heads=H, device="cpu"))
    monkeypatch.setattr(ref_pp, "init_params",
                        lambda *a, **k: jax.tree.map(jnp.asarray, init))
    topo = mpit_tpu.init(axis_names=("data", "pp"), mesh_shape=(2, 2),
                         devices=jax.devices()[:4])
    jt = ref_pp.PipelineParallelTrainer(
        vocab_size=V, num_layers=L, d_model=D, num_heads=H, seq_len=T, topo=topo,
        n_micro=2, donate_state=False)
    js = jt.init_state(jax.random.key(0))
    x, y = _tokens()
    ref = []
    for _ in range(2):
        js, m = jt.step(js, x, y)
        ref.append(float(m["loss"]))
    runs = {}
    for names in (("dp", "pp"), ("data", "pp")):
        tr = pp.PipelineParallelTrainer(
            vocab_size=V, num_layers=L, d_model=D, num_heads=H, seq_len=T,
            topo=Topology(4, CPU, axis_names=names, mesh_shape=(2, 2)), n_micro=2)
        state = tr.init_state(params=from_flax(init, device="cpu"))
        losses = []
        for _ in range(2):
            state, m = tr.step(state, x, y)
            losses.append(m["loss"])
        runs[names] = losses, state
    (want_l, want_s), (got_l, got_s) = runs.values()
    assert all(torch.equal(a, b) for a, b in zip(got_l, want_l))
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(got_s["params"]), jax.tree.leaves(want_s["params"])))
    np.testing.assert_allclose([float(v) for v in got_l], ref, **LOSS_TOL)
    want = jax.tree.map(np.asarray, jax.device_get(js["params"]))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(to_flax(got_s["params"])),
                    strict=True):
        np.testing.assert_allclose(b, a, **PARAM_TOL)


# ------------------------------------------------------------- loss_fn

def _l2(params, x, y):
    return ((x @ params["w"] + params["b"] - y) ** 2).mean()


def _l2_data():
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    x = rng.normal(size=(32, 4)).astype(np.float32)
    y = rng.normal(size=(32, 3)).astype(np.float32)
    return params, x, y


def _port_l2(kind):
    cls = DataParallelTrainer if kind == "sync" else ZeroDataParallelTrainer
    tr = cls(None, optim.SGD(0.1, momentum=0.9), Topology(8, CPU), loss_fn=_l2)
    params, _, _ = _l2_data()
    return tr, tr.init_state(params={k: torch.from_numpy(v) for k, v in params.items()})


def _ref_l2(kind, topo):
    params, _, _ = _l2_data()
    cls = RefSync if kind == "sync" else RefZero
    jt = cls(None, optax.sgd(0.1, momentum=0.9), topo, loss_fn=_l2, donate_state=False)
    params = jax.tree.map(jnp.asarray, params)
    if kind == "sync":
        return jt, jax.device_put(ref_common.TrainState.create(params, jt.optimizer),
                                  topo.replicated_sharding())
    opt_state, _ = jt._build(params)  # the reference's init_state without a model
    return jt, ref_common.TrainState(params=params, opt_state=opt_state,
                                     step=jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("kind", ["sync", "zero"])
def test_loss_fn_over_raw_params_matches_the_reference(kind, topo8):
    _, x, y = _l2_data()
    jt, js = _ref_l2(kind, topo8)
    tr, state = _port_l2(kind)
    for _ in range(2):
        js, jm = jt.step(js, x, y)
        state, m = tr.step(state, x, y)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TIGHT)
    for k in ("w", "b"):
        np.testing.assert_allclose(state.params[k].numpy(), np.asarray(js.params[k]), **TIGHT)


def test_fit_log_every_prints_the_reference_lines(topo8, capsys):
    _, x, y = _l2_data()
    jt, js = _ref_l2("sync", topo8)
    jt.fit(RefBatches(x, y, global_batch=8, seed=3), js, epochs=2, log_every=3)
    want = capsys.readouterr().out.splitlines()
    tr, state = _port_l2("sync")
    tr.fit(Batches(x, y, global_batch=8, seed=3), state, epochs=2, log_every=3)
    got = capsys.readouterr().out.splitlines()
    assert got == want and len(got) == 2 and got[0].startswith("[sync-dp] step=3 loss=")


# ----------------------------------------------------------- utilities

def test_device_batches_yield_the_references_batches(topo8):
    x = np.arange(64 * 4, dtype=np.float32).reshape(64, 4)
    y = np.arange(64, dtype=np.int32)

    def double(xb, yb):
        return xb * 2.0, yb

    ref = RefDeviceBatches(RefBatches(x, y, global_batch=16, seed=1), topo8, depth=2,
                           transform=double)
    db = DeviceBatches(Batches(x, y, global_batch=16, seed=1), Topology(8, CPU), depth=2,
                       transform=double)
    assert db.steps_per_epoch() == ref.steps_per_epoch() == 4
    for e in (0, 1):
        got, want = list(db.epoch(e)), list(ref.epoch(e))
        assert len(got) == len(want) == 4
        for (gx, gy), (wx, wy) in zip(got, want):
            assert isinstance(gx, torch.Tensor) and gx.device == CPU
            np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
            np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    with pytest.raises(ValueError, match="depth"):
        DeviceBatches(Batches(x, y, global_batch=16), Topology(8, CPU), depth=-1)


def test_throughput():
    tp = Throughput()
    assert tp.tick(100) is None
    assert tp.tick(100) > 0
    tp.reset()
    assert tp.tick(5) is None


def test_step_timer_skips_the_first_and_spreads_tuples():
    t = StepTimer(skip_first=1)
    for _ in range(3):
        t.start()
        t.stop(torch.ones(4))
    assert t.count == 2
    s = t.summary()
    assert s["steps"] == 2 and s["mean_s"] > 0 and set(s) == {"steps", "mean_s", "p50_s",
                                                              "max_s"}
    t = StepTimer(skip_first=0)
    t.start()
    assert t.stop(({"w": torch.ones(3)}, {"loss": torch.tensor(0.5)})) >= 0
    t.start()
    assert t.stop(None) >= 0 and t.count == 2
    with pytest.raises(RuntimeError, match="without start"):
        t.stop()


def test_tree_zeros_like_matches_the_reference():
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.ones(4, np.int32),
                                                   np.ones((), np.float32)]}
    got = tree_zeros_like(jax.tree.map(torch.from_numpy, tree))
    want = ref_tree_zeros_like(jax.tree.map(jnp.asarray, tree))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert g.shape == w.shape and str(g.dtype).split(".")[-1] == str(w.dtype)
        assert not g.any()


def test_second_axis_for_matches_the_reference_and_shapes_the_world():
    for sp, pp_ in ((1, 1), (4, 2), (2, 8)):
        assert second_axis_for(TrainConfig(sp=sp, pp=pp_)) == ref_second_axis_for(
            RefConfig(sp=sp, pp=pp_))
    cfg = TrainConfig().apply_preset("ptb-transformer-seq")
    world = _world_for(cfg, Topology(8, CPU))
    ax, extent = second_axis_for(cfg)["seq-sync"]
    assert world.axis_names == ("dp", ax) and world.mesh_shape == (8 // extent, extent)


def test_metrics_logger_all_processes(monkeypatch):
    for process, all_processes in ((0, False), (1, False), (1, True)):
        # the module, which the package's `topology` function shadows
        monkeypatch.setattr(importlib.import_module("mpit_tpu_torch.comm.topology"),
                            "current_process", lambda: (process, 2))
        monkeypatch.setattr(jax, "process_index", lambda: process)
        recs = []
        for cls in (MetricsLogger, RefMetricsLogger):
            buf = io.StringIO()
            log = cls(tag="t", echo=False, all_processes=all_processes, _stream=buf)
            log.log(3, loss=0.5, n=np.arange(2))
            recs.append([{k: v for k, v in json.loads(line).items() if k != "ts"}
                         for line in buf.getvalue().splitlines()])
        assert recs[0] == recs[1]
        assert len(recs[0]) == (0 if process and not all_processes else 1)
        if recs[0]:
            assert recs[0][0] == {"tag": "t", "process": process, "step": 3, "loss": 0.5,
                                  "n": [0, 1]}
