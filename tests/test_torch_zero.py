"""The port's ZeRO-1 trainer (``mpit_tpu_torch/parallel/zero.py``) against
the reference's ``ZeroDataParallelTrainer`` and against plain sync DP, on
the CPU: the cases of ``tests/test_zero.py`` (Adam on the chunks equals
replicated Adam, the state's layout, accumulation, the int8 scatter,
the elementwise probe, ``clip_norm``, W invariance), the port against the
reference from the same converted weights, and checkpoints byte-equal to
``flax.serialization.to_bytes`` of the reference's ZeRO state, which each
package resumes from the other's.
"""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.models import LeNet as JaxLeNet
from mpit_tpu.parallel import ZeroDataParallelTrainer as JaxZero
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.data import Batches
from mpit_tpu_torch.models import LeNet
from mpit_tpu_torch.parallel import DataParallelTrainer, ZeroDataParallelTrainer
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.config import TrainConfig

CPU = torch.device("cpu")
CPU8 = Topology(num_workers=8, device=CPU)
# the reference's own limits of ZeRO against plain sync DP (tests/test_zero.py)
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
# its limits of the int8 scatter against the raw one
Q_LOSS_ATOL, Q_PARAM_ATOL = 2e-2, 5e-3
# the port against the reference, f32 LeNet, SGD 0.1 with momentum 0.9, 3
# steps from the same weights: the same sums in other orders, 1e-6 relative
# a step, grown by the momentum; in practice 1e-7
REF_TOL = dict(rtol=1e-5, atol=1e-5)
# with int8 codes on the scatter a gradient element that lands within an
# f32 rounding of a code's half-way point rounds the other way, which moves
# it by one code step (1/127 of its block's absmax, lr 0.1 on it); 3 steps
# of that stay under 1e-3 (measured 2.9e-4)
REF_Q_TOL = dict(rtol=0, atol=1e-3)
# run() of a bf16 preset: XLA and PyTorch round bf16 products differently
# (tests/test_torch_checkpoint.py)
BF16_TRAJ_TOL = dict(rtol=0, atol=5e-3)


def _data(n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    return x, y


def _lenet():
    return LeNet(compute_dtype=torch.float32, device="cpu")


def _params(seed=0):
    return _lenet().init(torch.Generator().manual_seed(seed))


def _steps(trainer, state, x, y, n):
    losses = []
    for _ in range(n):
        state, m = trainer.step(state, x, y)
        losses.append(float(m["loss"]))
    return state, losses


def _assert_trees_close(a, b, **tol):
    for p, q in zip(jax.tree.leaves(a), jax.tree.leaves(b), strict=True):
        np.testing.assert_allclose(np.asarray(p), np.asarray(q), **tol)


def test_adam_on_the_chunks_equals_replicated_adam():
    """``tests/test_zero.py::test_matches_plain_dp_trajectory``: the same
    gradient, the update by chunks of the flat vector against the update
    by leaves; the port is bit for bit (both take the global batch's
    gradient), within the reference's limits a fortiori."""
    x, y = _data()
    p0 = _params()
    out = {}
    for cls in (DataParallelTrainer, ZeroDataParallelTrainer):
        tr = cls(_lenet(), optim.Adam(1e-3), CPU8)
        st, losses = _steps(tr, tr.init_state(params=p0), x, y, 3)
        out[cls] = (losses, st.params, tr.evaluate(st, x, y))
    a, b = out[DataParallelTrainer], out[ZeroDataParallelTrainer]
    assert a[0] == b[0] and a[2] == b[2]
    for p, q in zip(jax.tree.leaves(a[1]), jax.tree.leaves(b[1])):
        assert torch.equal(p, q)


def test_state_layout_is_the_references(topo8):
    """Adam's moments are flat ``(padded,)`` vectors (W-divisible), its
    count a host int, in optax's tuple; the reference's state has the same
    structure and shapes, leaf for leaf."""
    x, _ = _data()
    tr = ZeroDataParallelTrainer(_lenet(), optim.Adam(1e-3), CPU8)
    st = tr.init_state(params=_params())
    n = sum(t.numel() for t in jax.tree.leaves(st.params))
    padded = -(-n // 8) * 8
    adam = st.opt_state[0]
    assert adam.mu.shape == adam.nu.shape == (padded,) and adam.count == 0
    js = JaxZero(JaxLeNet(compute_dtype=jnp.float32), optax.adam(1e-3), topo8,
                 donate_state=False).init_state(jax.random.key(0), x[:2])
    want = flax.serialization.to_state_dict(js)
    got = ckpt.state_to_host(st)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        assert np.shape(a) == np.shape(b) and np.asarray(a).dtype == np.asarray(b).dtype


def test_accumulation_equals_plain_dp():
    """``test_composes_with_grad_accumulation``: ZeRO at accum 2 against
    plain sync DP on the same global batch, and the batch check."""
    x, y = _data(n=32, seed=2)
    p0 = _params()
    ref = DataParallelTrainer(_lenet(), optim.Adam(1e-3), CPU8)
    za = ZeroDataParallelTrainer(_lenet(), optim.Adam(1e-3), CPU8, accum_steps=2)
    st_r, st_z = ref.init_state(params=p0), za.init_state(params=p0)
    for _ in range(2):
        st_r, m_r = ref.step(st_r, x, y)
        st_z, m_z = za.step(st_z, x, y)
        np.testing.assert_allclose(float(m_z["loss"]), float(m_r["loss"]), rtol=LOSS_RTOL)
    _assert_trees_close(st_z.params, st_r.params, rtol=0, atol=PARAM_ATOL)
    with pytest.raises(ValueError, match="accum_steps"):
        za.step(st_z, x[:8], y[:8])  # per-worker 1 % 2 != 0


@pytest.mark.parametrize("accum", [1, 2])
def test_the_quantized_scatter_tracks_the_raw_one(accum):
    """``test_quantized_scatter_tracks_raw``: int8 codes on the scatter stay
    within the reference's limits of the raw scatter (with accumulation the
    scatter runs once a slice); a bad mode is refused."""
    x, y = _data(n=32, seed=4)
    p0 = _params()
    out = {}
    for mode in ("off", "int8"):
        tr = ZeroDataParallelTrainer(_lenet(), optim.SGD(0.1, momentum=0.9), CPU8,
                                     quant=mode, accum_steps=accum)
        assert tr.quant == mode
        out[mode] = _steps(tr, tr.init_state(params=p0), x, y, 3)
    assert np.isfinite(out["int8"][1]).all()
    np.testing.assert_allclose(out["int8"][1], out["off"][1], rtol=0, atol=Q_LOSS_ATOL)
    _assert_trees_close(out["int8"][0].params, out["off"][0].params, rtol=0,
                        atol=Q_PARAM_ATOL)
    with pytest.raises(ValueError, match="quant"):
        ZeroDataParallelTrainer(_lenet(), optim.SGD(0.1), CPU8, quant="fp4")


def test_a_cross_leaf_optimizer_is_refused():
    with pytest.raises(ValueError, match="ELEMENTWISE"):
        ZeroDataParallelTrainer(
            _lenet(), optim.chain(optim.clip_by_global_norm(1.0), optim.SGD(0.1)), CPU8)
    ZeroDataParallelTrainer(_lenet(), optim.AdamW(1e-3), CPU8)  # elementwise


def test_clip_norm_equals_the_chained_clip_on_plain_dp():
    """``TestClipNorm``: clip_norm over the chunks equals the chained
    global-norm clip on plain sync DP (where the chain is safe), with the
    threshold far below the gradient's norm; 0 is refused."""
    x, y = _data()
    p0 = _params()
    c = 0.05
    ref = DataParallelTrainer(
        _lenet(), optim.chain(optim.clip_by_global_norm(c), optim.SGD(0.1)), CPU8)
    zt = ZeroDataParallelTrainer(_lenet(), optim.SGD(0.1), CPU8, clip_norm=c)
    st_r, st_z = ref.init_state(params=p0), zt.init_state(params=p0)
    g, _ = ref._vg(st_r.params, torch.from_numpy(x), torch.from_numpy(y))
    assert float(torch.stack([t.square().sum() for t in jax.tree.leaves(g)]).sum().sqrt()) > c
    for _ in range(3):
        st_r, mr = ref.step(st_r, x, y)
        st_z, mz = zt.step(st_z, x, y)
        assert float(mz["loss"]) == pytest.approx(float(mr["loss"]), rel=1e-6)
    _assert_trees_close(st_z.params, st_r.params, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="clip_norm"):
        ZeroDataParallelTrainer(_lenet(), optim.SGD(0.1), CPU8, clip_norm=0.0)


def test_fit_and_w_invariance():
    """``test_fit_and_w_invariance``: fit() through the shared loop; W = 8
    equals W = 1 on the same global batches."""
    x, y = _data(n=32, seed=1)
    p0 = _params()
    out = {}
    for w in (8, 1):
        tr = ZeroDataParallelTrainer(_lenet(), optim.SGD(0.1, momentum=0.9),
                                     Topology(num_workers=w, device=CPU))
        st, m = tr.fit(Batches(x, y, global_batch=16, seed=0), tr.init_state(params=p0),
                       epochs=2)
        out[w] = (float(m["loss"]), st.params)
    assert out[8][0] == pytest.approx(out[1][0], rel=1e-5)
    _assert_trees_close(out[8][1], out[1][1], rtol=0, atol=3e-5)


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_three_steps_match_the_reference_trainer(quant, topo8):
    """The port against the reference's ZeRO trainer on the 8-device mesh,
    from the same converted weights: losses and params after each of 3
    steps (SGD 0.1, momentum 0.9; the int8 scatter too)."""
    x, y = _data(n=32, seed=3)
    jt = JaxZero(JaxLeNet(compute_dtype=jnp.float32), optax.sgd(0.1, momentum=0.9), topo8,
                 donate_state=False, quant=quant)
    js = jt.init_state(jax.random.key(0), x[:2])
    pt = ZeroDataParallelTrainer(_lenet(), optim.SGD(0.1, momentum=0.9), CPU8, quant=quant)
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.params), device="cpu"))
    tol = REF_TOL if quant == "off" else REF_Q_TOL
    for _ in range(3):
        js, jm = jt.step(js, x, y)
        ps, pm = pt.step(ps, x, y)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), rtol=1e-5)
        _assert_trees_close(to_flax(ps.params), jax.device_get(js.params), **tol)
    assert ps.step == int(js.step) == 3


def test_checkpoints_are_to_bytes_of_the_references_and_resume_both_ways(topo8, tmp_path):
    """The reference's ZeRO state after 2 Adam steps, as ``to_bytes``: the
    port restores it, writes it back byte for byte, and one more step from
    it in each package agrees within REF_TOL; the reference restores the
    port's next checkpoint."""
    x, y = _data(n=16, seed=5)
    jt = JaxZero(JaxLeNet(compute_dtype=jnp.float32), optax.adam(1e-3), topo8,
                 donate_state=False)
    js = jt.init_state(jax.random.key(0), x[:2])
    for _ in range(2):
        js, _ = jt.step(js, x, y)
    want = flax.serialization.to_bytes(js)
    (tmp_path / "ckpt_00000002.msgpack").write_bytes(want)
    pt = ZeroDataParallelTrainer(_lenet(), optim.Adam(1e-3), CPU8)
    ps, step = ckpt.restore_checkpoint(str(tmp_path), pt.init_state(params=_params()))
    assert step == 2 and ps.step == 2 and ps.opt_state[0].count == 2
    path = ckpt.save_checkpoint(str(tmp_path / "port"), ps, step=2)
    assert open(path, "rb").read() == want
    js, _ = jt.step(js, x, y)
    ps, _ = pt.step(ps, x, y)
    _assert_trees_close(to_flax(ps.params), jax.device_get(js.params), **REF_TOL)
    ckpt.save_checkpoint(str(tmp_path / "port"), ps, step=3)
    back = flax.serialization.from_bytes(
        jax.device_get(js), open(tmp_path / "port" / "ckpt_00000003.msgpack", "rb").read())
    assert int(back.step) == 3
    _assert_trees_close(back.opt_state, ckpt.state_to_host(ps.opt_state), rtol=0, atol=0)


def _cfg(preset, **over):
    return dataclasses.replace(TrainConfig().apply_preset(preset), **over)


@pytest.mark.parametrize("case", ["lm", "lenet"])
def test_run_zero_sync_resumes_the_references_checkpoint_as_the_reference_does(
        case, tmp_path):
    """``run()`` with ``--algo zero-sync`` on a narrow ``ptb-transformer-large``
    (flash through the plain versions; bf16) with accumulation and
    clip_norm, and on ``mnist-easgd``'s bf16 LeNet: the reference trains the
    first epoch and checkpoints (the two packages initialize from their own
    generators), both resume from copies of that file for the second. The
    port returns the reference's keys, units and samples, and its losses,
    accuracy and final params and optimizer state agree within the bf16
    trajectory tolerance (``tests/test_torch_checkpoint.py``'s
    BF16_TRAJ_TOL)."""
    import shutil

    from mpit_tpu.run import run as ref_run
    from mpit_tpu_torch.run import run as port_run

    if case == "lm":
        cfg = _cfg("ptb-transformer-large", algo="zero-sync", attn_impl="flash", layers=2,
                   d_model=32, heads=4, seq_len=64, train_size=64, lr=3e-3,
                   warmup_steps=2, grad_accum=2, clip_norm=1.0, global_batch=16)
    else:
        cfg = _cfg("mnist-easgd", algo="zero-sync", train_size=256, global_batch=64)
    ref_run(dataclasses.replace(cfg, epochs=1, ckpt_dir=str(tmp_path / "first")))
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / name)
    resumed = dataclasses.replace(cfg, epochs=2, resume=True)
    r = ref_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "ref")))
    p = port_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "port")), device="cpu")
    assert set(r) <= set(p)
    for key in ("workers", "trained_units", "samples", "resumed_from", "last_checkpoint"):
        assert p[key] == r[key], key
    assert np.isfinite(p["round_losses"]).all()
    for key in ("final_loss", "eval_loss", "accuracy"):
        np.testing.assert_allclose(p[key], r[key], **BF16_TRAJ_TOL, err_msg=key)
    step = r["last_checkpoint"]
    want, got = (ckpt.msgpack_restore(open(tmp_path / d / f"ckpt_{step:08d}.msgpack",
                                           "rb").read()) for d in ("ref", "port"))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    _assert_trees_close(got["params"], want["params"], **BF16_TRAJ_TOL)
