"""The port's pipeline parallelism (``parallel/pipeline.py``, ``--algo
pp-sync``) against the JAX package's on the 8-device CPU mesh.

The reference's 12 cases of ``tests/test_pipeline_parallel.py`` run on the
port's trainer (schedule invariance: every schedule, factorization and
microbatch count trains the unpipelined function; the 1F1B and interleaved
timetables' properties; the optimizers and ``clip_norm``; the refusals),
then the parity cases: the timetables equal to the reference's array for
array; the first loss and three steps of gpipe, 1f1b and interleaved
against the reference's trainer from the same init; ``reference_apply``;
and a pp-sync checkpoint byte-equal to ``flax.serialization.to_bytes`` of
the reference's state, resumed by the other package.

Tolerances: the reference's own (losses 2e-5 relative, params 2e-4 across
factorizations and schedules); against the reference's trainer the same.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpit_tpu
from mpit_tpu.parallel import pipeline as ref_pp
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.parallel import pipeline as pp
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.params import tree_leaves

V, B, T, L, D, H = 23, 8, 16, 8, 32, 4
CPU = torch.device("cpu")
LOSS_TOL = dict(rtol=2e-5, atol=2e-6)
PARAM_TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0):
    x = np.random.default_rng(seed).integers(0, V, (B, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


def _init():
    """The reference's init (numpy, global layer order)."""
    return jax.tree.map(np.asarray, ref_pp.init_params(jax.random.key(0), V, L, D, 4 * D, T,
                                                       num_heads=H))


def _world(shape):
    return Topology(8, CPU, axis_names=("dp", "pp"), mesh_shape=shape)


def _trainer(shape, n_micro, schedule="gpipe", virtual=2, **kw):
    return pp.PipelineParallelTrainer(
        vocab_size=V, num_layers=L, d_model=D, num_heads=H, seq_len=T,
        topo=_world(shape), n_micro=n_micro, schedule=schedule, virtual=virtual, **kw)


def _run(shape, n_micro, steps=3, schedule="gpipe", virtual=2, with_eval=False, **kw):
    tr = _trainer(shape, n_micro, schedule, virtual, **kw)
    state = tr.init_state(params=from_flax(_init(), device="cpu"))
    x, y = _data()
    losses = []
    for _ in range(steps):
        state, m = tr.step(state, x, y)
        losses.append(float(m["loss"]))
    ev = tr.evaluate(state, x, y) if with_eval else None
    params = tr._unpermute(state["params"])
    return (losses, params, ev) if with_eval else (losses, params)


def _close(a, b, tol=PARAM_TOL):
    for p, q in zip(tree_leaves(a), tree_leaves(b), strict=True):
        torch.testing.assert_close(p, q, **tol)


def _ref_loss(params, x, y):
    logits = pp.reference_apply(params, torch.from_numpy(x), H)
    return float(torch.nn.functional.cross_entropy(
        logits.reshape(-1, V), torch.from_numpy(y).long().reshape(-1)))


# ----------------------------------------- the reference's pipeline cases

class TestPipelineParallel:
    def test_first_loss_matches_unpipelined_reference(self):
        losses, _ = _run((1, 8), n_micro=4, steps=1)
        x, y = _data()
        assert losses[0] == pytest.approx(_ref_loss(from_flax(_init(), device="cpu"), x, y),
                                          rel=1e-5)

    def test_factorizations_and_microbatching_match(self):
        ref_losses, ref_params = _run((1, 8), n_micro=4)
        for shape, m in (((2, 4), 4), ((4, 2), 2), ((1, 8), 8)):
            losses, params = _run(shape, n_micro=m)
            np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL,
                                       err_msg=f"mesh {shape} n_micro={m}")
            _close(params, ref_params)

    def test_1f1b_schedule_properties(self):
        """Span 2(M+S−1); in-flight bounded by min(S, M)."""
        for m, s in ((4, 4), (8, 4), (2, 8), (8, 8), (1, 4)):
            tabs = pp.schedule_1f1b(m, s)
            assert tabs["ticks"] == 2 * (m + s - 1), (m, s)
            assert max(tabs["max_inflight"]) <= min(s, m), (m, s)
            op = tabs["op"]
            assert (op == 1).sum(0).tolist() == [m] * s
            assert (op == 2).sum(0).tolist() == [m] * s

    def test_1f1b_matches_gpipe_trajectory(self):
        ref_losses, ref_params = _run((1, 8), n_micro=4)
        for shape, m in (((2, 4), 4), ((4, 2), 2)):
            losses, params = _run(shape, n_micro=m, schedule="1f1b")
            np.testing.assert_allclose(losses, ref_losses, **LOSS_TOL,
                                       err_msg=f"1f1b mesh {shape} n_micro={m}")
            _close(params, ref_params)

    def test_interleaved_matches_gpipe_trajectory(self):
        """Same losses, same (globally reordered) params, same eval as
        GPipe; the storage permutation round-trips."""
        ref = _run((1, 8), n_micro=4, with_eval=True)
        for shape, m, v in (((2, 4), 4, 2), ((4, 2), 2, 2), ((2, 4), 4, 1)):
            losses, params, ev = _run(shape, n_micro=m, schedule="interleaved",
                                      virtual=v, with_eval=True)
            np.testing.assert_allclose(losses, ref[0], **LOSS_TOL,
                                       err_msg=f"interleaved mesh {shape} v={v}")
            _close(params, ref[1])
            assert ev[0] == pytest.approx(ref[2][0], abs=1e-6)

    def test_interleaved_span_wins_when_bubble_dominates(self):
        for m, s in ((4, 4), (8, 8)):
            plain = pp.schedule_pipeline(m, s, 1)["ticks"]
            inter = pp.schedule_pipeline(m, s, 2)["ticks"] / 2
            assert inter < plain, (m, s, inter, plain)
        plain = pp.schedule_pipeline(32, 4, 1)["ticks"]
        inter = pp.schedule_pipeline(32, 4, 2)["ticks"] / 2
        assert inter >= plain, (inter, plain)

    def test_trains_to_low_loss(self):
        tr = _trainer((2, 4), 2, lr=0.3, momentum=0.9)
        state = tr.init_state(torch.Generator().manual_seed(1))
        x = (np.arange(B * T * 2, dtype=np.int32) % V).reshape(-1, T)[:B]
        y = np.roll(x, -1, axis=1).astype(np.int32)
        losses = []
        for _ in range(40):
            state, m = tr.step(state, x, y)
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] * 0.5, losses

    def test_validation(self):
        """The reference's refusals (``mpit_tpu/parallel/pipeline.py:349-396,
        934-945``)."""
        with pytest.raises(ValueError, match="not divisible by pp"):
            pp.PipelineParallelTrainer(vocab_size=V, num_layers=6, d_model=D, num_heads=H,
                                       seq_len=T, topo=_world((1, 8)))
        tr = _trainer((1, 8), 4)
        state = tr.init_state(torch.Generator().manual_seed(0))
        x, y = _data()
        with pytest.raises(ValueError, match="n_micro"):
            tr.step(state, x[:6], y[:6])
        long_x = np.zeros((B, T * 2), np.int32)
        with pytest.raises(ValueError, match="position"):
            tr.step(state, long_x, long_x)
        with pytest.raises(ValueError, match="second axis is 'pp'"):
            pp.PipelineParallelTrainer(vocab_size=V, num_layers=L, d_model=D, num_heads=H,
                                       seq_len=T, topo=Topology(8, CPU))
        with pytest.raises(ValueError, match="schedule"):
            _trainer((2, 4), 4, schedule="zigzag")
        with pytest.raises(ValueError, match="pp x virtual"):
            _trainer((2, 4), 4, schedule="interleaved", virtual=3)


class TestOptaxOptimizer:
    def test_optax_sgd_matches_builtin(self):
        """optim.SGD with momentum is the built-in update."""
        a_l, a_p = _run((2, 4), 4)
        b_l, b_p = _run((2, 4), 4, optimizer=optim.SGD(0.1, momentum=0.9))
        np.testing.assert_allclose(b_l, a_l, rtol=1e-6, atol=1e-7)
        _close(b_p, a_p, dict(rtol=1e-5, atol=1e-6))

    def test_adam_factorization_invariant(self):
        ref = _run((1, 8), 8, optimizer=optim.Adam(1e-2))
        got = _run((4, 2), 2, optimizer=optim.Adam(1e-2))
        np.testing.assert_allclose(got[0], ref[0], **LOSS_TOL)
        _close(got[1], ref[1])

    def test_clip_engages_and_is_factorization_invariant(self):
        c = 0.05
        plain = _run((2, 4), 4, optimizer=optim.SGD(0.1))
        ref = _run((1, 8), 8, optimizer=optim.SGD(0.1), clip_norm=c)
        got = _run((2, 4), 4, optimizer=optim.SGD(0.1), clip_norm=c)
        assert not np.allclose(ref[0], plain[0]), "clip never engaged"
        np.testing.assert_allclose(got[0], ref[0], **LOSS_TOL)
        _close(got[1], ref[1])

    def test_cross_leaf_optimizer_rejected(self):
        with pytest.raises(ValueError, match="ELEMENTWISE"):
            _trainer((2, 4), 4, optimizer=optim.chain(optim.clip_by_global_norm(1.0),
                                                      optim.SGD(0.1)))


# ------------------------------------------------------- against the JAX package

@pytest.mark.parametrize("m,s,v", [(4, 2, 1), (8, 4, 1), (8, 4, 2), (4, 2, 3)])
def test_timetables_equal_the_references(m, s, v):
    want, got = ref_pp.schedule_pipeline(m, s, v), pp.schedule_pipeline(m, s, v)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        else:
            assert got[k] == want[k], k
    if v == 1:
        w1, g1 = ref_pp.schedule_1f1b(m, s), pp.schedule_1f1b(m, s)
        assert all(np.array_equal(np.asarray(g1[k]), np.asarray(w1[k])) for k in w1)


def test_reference_apply_and_init_layout_match_the_references():
    """``reference_apply`` on the reference's params against its own; the
    port's ``init_params`` lays out the reference's tree (keys, shapes)."""
    host = _init()
    x, _ = _data(seed=2)
    want = np.asarray(ref_pp.reference_apply(jax.tree.map(jnp.asarray, host),
                                             jnp.asarray(x), H))
    got = pp.reference_apply(from_flax(host, device="cpu"), torch.from_numpy(x), H)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    mine = pp.init_params(torch.Generator().manual_seed(0), V, L, D, 4 * D, T, num_heads=H)
    assert (jax.tree.structure(jax.tree.map(np.asarray, to_flax(mine)))
            == jax.tree.structure(host))
    for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(to_flax(mine)), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("schedule,virtual", [("gpipe", 1), ("1f1b", 1), ("interleaved", 2)])
def test_three_steps_match_the_reference_trainer(schedule, virtual):
    """The first loss and three steps of each schedule on a (2, 4) mesh
    from the reference's init: losses, params (global layer order) and
    the evaluation against the reference's trainer."""
    mpit_tpu.finalize()
    topo = mpit_tpu.init(axis_names=("dp", "pp"), mesh_shape=(2, 4))
    jt = ref_pp.PipelineParallelTrainer(
        vocab_size=V, num_layers=L, d_model=D, num_heads=H, seq_len=T, topo=topo,
        n_micro=4, lr=0.1, momentum=0.9, schedule=schedule, virtual=virtual,
        donate_state=False)
    js = jt.init_state(jax.random.key(0))
    x, y = _data()
    want = []
    for _ in range(3):
        js, m = jt.step(js, x, y)
        want.append(float(m["loss"]))
    want_ev = jt.evaluate(js, x, y)
    want_p = jax.tree.map(np.asarray, jax.device_get(jt._unpermute(js["params"])))
    mpit_tpu.finalize()
    losses, params, ev = _run((2, 4), 4, schedule=schedule, virtual=virtual, with_eval=True)
    np.testing.assert_allclose(losses, want, **LOSS_TOL)
    for a, b in zip(jax.tree.leaves(want_p), jax.tree.leaves(to_flax(params)), strict=True):
        np.testing.assert_allclose(b, a, **PARAM_TOL)
    assert ev[0] == pytest.approx(want_ev[0], abs=1e-6)
    assert ev[1] == pytest.approx(want_ev[1], rel=1e-5)


@pytest.mark.parametrize("optimizer", ["builtin", "adam"])
def test_checkpoint_bytes_equal_flax_to_bytes_and_resume_across(optimizer, tmp_path):
    """An interleaved pp-sync state after a step (chunk storage order; the
    built-in SGD's momentum, or Adam's opt_state) saved by the port is
    ``flax.serialization.to_bytes`` of the reference's same state, byte for
    byte, and each package restores the other's file."""
    kw = {} if optimizer == "builtin" else {"optimizer": optim.Adam(1e-2)}
    tr = _trainer((2, 4), 4, schedule="interleaved", **kw)
    state = tr.init_state(params=from_flax(_init(), device="cpu"))
    x, y = _data()
    state, _ = tr.step(state, x, y)
    path = ckpt.save_checkpoint(str(tmp_path / "port"), state, step=1)
    host = ckpt.state_to_host(state)
    mpit_tpu.finalize()
    topo = mpit_tpu.init(axis_names=("dp", "pp"), mesh_shape=(2, 4))
    jt = ref_pp.PipelineParallelTrainer(
        vocab_size=V, num_layers=L, d_model=D, num_heads=H, seq_len=T, topo=topo,
        n_micro=4, schedule="interleaved",
        optimizer=None if optimizer == "builtin" else optax.adam(1e-2), donate_state=False)
    template = jt.init_state(jax.random.key(1))
    ref_state = flax.serialization.from_state_dict(template, host)
    want = flax.serialization.to_bytes(ref_state)
    assert open(path, "rb").read() == want
    # the reference's bytes restore into the port's state, and back
    (tmp_path / "ref").mkdir()
    (tmp_path / "ref" / "ckpt_00000001.msgpack").write_bytes(want)
    back, step = ckpt.restore_checkpoint(str(tmp_path / "ref"),
                                         tr.init_state(torch.Generator().manual_seed(0)))
    assert step == 1 and back["step"] == 1
    for a, b in zip(tree_leaves(back["params"]), tree_leaves(state["params"]), strict=True):
        assert torch.equal(a, b)
    restored = flax.serialization.from_bytes(template, open(path, "rb").read())
    assert int(restored["step"]) == 1


def test_convert_round_trips_the_pipeline_and_moe_trees():
    """``convert.from_flax``/``to_flax`` carry the pipeline's ``{"blocks",
    "rest"}`` tree (3-D stacked Dense kernels) and an MoE LM's tree (3-D
    expert kernels) across unchanged, both ways, bit for bit."""
    from mpit_tpu.models.transformer import TransformerLM as JaxLM

    moe = JaxLM(vocab_size=V, num_layers=1, d_model=D, num_heads=H, max_len=T,
                moe_experts=4, compute_dtype=jnp.float32)
    moe_params = jax.tree.map(np.asarray, moe.init(jax.random.key(1),
                                                   jnp.zeros((1, T), jnp.int32))["params"])
    assert moe_params["Block_0"]["moe_w_up"].ndim == 3
    for host in (_init(), moe_params):
        tree = from_flax(host, device="cpu")
        back = to_flax(tree)
        assert jax.tree.structure(back) == jax.tree.structure(host)
        for a, b in zip(jax.tree.leaves(host), jax.tree.leaves(back), strict=True):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    blocks = from_flax(_init(), device="cpu")["blocks"]
    assert tuple(blocks["Dense_0"]["kernel"].shape) == (L, D, 3 * D)

