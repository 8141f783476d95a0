"""Sequence parallelism of the port (``seq-sync``) against the JAX
package's on the 8-device CPU mesh: ``ppermute_ring``, ring and Ulysses
attention over the stacked sequence ring, the sp-sharded transformer, the
``SeqParallelTrainer`` at three mesh shapes, ``run()`` of
``ptb-transformer-seq`` and a seq-sync checkpoint's bytes.

The reference runs each sequence block on its own device inside
``shard_map``; the port stacks the blocks on dim 0 of one tensor
(``mpit_tpu_torch/ops/ring_attention.py``). Inputs come from numpy seeds.
"""

import dataclasses
import shutil

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu.comm import collectives as ref_coll
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.ops import dense_attention as ref_dense
from mpit_tpu.ops import make_ring_attention as ref_make_ring
from mpit_tpu.ops.ulysses import ulysses_attention as ref_ulysses
from mpit_tpu.parallel import SeqParallelTrainer as JaxSeq
from mpit_tpu_torch import optim
from mpit_tpu_torch.comm import collectives as coll
from mpit_tpu_torch.comm.topology import Topology, finalize, init
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import TransformerLM
from mpit_tpu_torch.ops.ring_attention import (
    from_blocks, make_ring_attention, ring_attention, to_blocks,
)
from mpit_tpu_torch.ops.ulysses import ulysses_attention
from mpit_tpu_torch.parallel import SeqParallelTrainer
from mpit_tpu_torch.utils import checkpoint as ckpt
from mpit_tpu_torch.utils.config import TrainConfig

CPU = torch.device("cpu")
# the reference's limits: ring vs dense attention (tests/test_ring_attention.py:42,54),
# the sharded apply (tests/test_seq_parallel.py:105) and mesh-shape invariance
# of trainer steps (tests/test_seq_parallel.py:62-79)
ATT_TOL = {np.float32: 2e-5, jnp.bfloat16: 3e-2}
APPLY_TOL = dict(rtol=2e-4, atol=2e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
PARAM_TOL = dict(rtol=5e-5, atol=5e-5)
# run() of the bf16 preset: tests/test_torch_checkpoint.py's BF16_TRAJ_TOL on
# params (XLA and PyTorch round bf16 products differently); the losses of
# ~log(V) agree to the same absolute error
BF16_TRAJ_TOL = dict(rtol=0, atol=5e-3)
V, B, T = 31, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (several test processes
    share the machine; small CPU ops oversubscribed run many times slower)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def port_world(request):
    """The port's global world, on the CPU, with the mesh of ``request.param``."""
    names, shape = request.param
    finalize()
    yield init(device="cpu", axis_names=names, mesh_shape=shape)
    finalize()


def _ref_world(names, shape):
    mpit_tpu.finalize()
    return mpit_tpu.init(axis_names=names, mesh_shape=shape)


# ------------------------------------------------------------ ppermute_ring

@pytest.mark.parametrize("port_world", [(("dp",), (8,))], indirect=True)
@pytest.mark.parametrize("shift", [1, -1, 3])
def test_ppermute_ring_matches_the_reference(shift, port_world, topo8):
    """Worker i's value lands at (i + shift) % 8, bit for bit
    (``tests/test_comm.py:196-201``)."""
    x = np.random.default_rng(shift % 7).normal(size=(8, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda s: ref_coll.ppermute_ring(s, shift=shift), mesh=topo8.mesh,
        in_specs=P("dp", None), out_specs=P("dp", None), check_vma=False))(x))
    got = coll.ppermute_ring({"x": torch.from_numpy(x)}, shift=shift)["x"].numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.roll(x, shift, axis=0))


@pytest.mark.parametrize("port_world", [(("dp", "sp"), (2, 4))], indirect=True)
@pytest.mark.parametrize("axis", ["dp", "sp"])
def test_ppermute_ring_over_one_axis_of_a_2d_mesh(axis, port_world):
    """On a (2, 4) mesh the ring runs along the named axis only, the worker
    keeping its place on the other, as ``lax.ppermute`` over that axis."""
    topo = _ref_world(("dp", "sp"), (2, 4))
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda s: ref_coll.ppermute_ring(s, shift=1, axis_name=axis), mesh=topo.mesh,
        in_specs=P(("dp", "sp")), out_specs=P(("dp", "sp")), check_vma=False))(x))
    got = coll.ppermute_ring(torch.from_numpy(x), 1, axis_name=axis).numpy()
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        coll.ppermute_ring(torch.from_numpy(x), axis_name="pp")


def test_a_mesh_the_world_cannot_hold_is_refused():
    with pytest.raises(ValueError, match="does not cover"):
        Topology(8, CPU, axis_names=("dp", "sp"), mesh_shape=(2, 2))
    # the sp ring may span processes: 4 processes of 2 workers hold half a
    # ring each
    topo = Topology(8, CPU, process_index=3, process_count=4, axis_names=("dp", "sp"),
                    mesh_shape=(2, 4))
    span = topo.axis_span("sp")
    assert (topo.local_workers, span.start, span.count, span.line) == (2, 2, 2, (2, 3))
    assert (topo.axis_span("dp").start, topo.peers("sp").line) == (1, (1, 3))
    # ...but a process must hold whole inner groups or an equal share of one
    with pytest.raises(ValueError, match="cannot hold"):
        Topology(12, CPU, process_count=2, axis_names=("dp", "sp"), mesh_shape=(3, 4))
    assert Topology(8, CPU, process_count=2, axis_names=("dp", "sp"),
                    mesh_shape=(2, 4)).local_workers == 4
    # the pipeline's stages may span processes too: each of 4 processes of
    # 2 workers holds 2 of its dp group's 4 stages
    from mpit_tpu_torch.parallel.pipeline import PipelineParallelTrainer

    for p in range(4):
        world = Topology(8, CPU, process_index=p, process_count=4, axis_names=("dp", "pp"),
                         mesh_shape=(2, 4))
        tr = PipelineParallelTrainer(31, 4, 32, 2, T, topo=world)
        span = world.axis_span("pp")
        assert (span.start, span.count, span.line) == (2 * (p % 2), 2, (p - p % 2, p - p % 2 + 1))
        assert tr._pp_span == span and tr._stages == [span.start, span.start + 1]
        assert tr._dp_peers.line == (p % 2, p % 2 + 2)
    # ...but a mesh whose process's workers form no block is still refused:
    # 6 workers a process cover a row and a half of the (pp, sp) plane
    with pytest.raises(ValueError, match="do not form a block"):
        PipelineParallelTrainer(31, 3, 32, 2, T, topo=Topology(
            12, CPU, process_count=2, axis_names=("dp", "pp", "sp"), mesh_shape=(1, 3, 4)))


# --------------------------------------------------------------- attention

def _qkv(b=2, t=64, h=8, d=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3))


def _ref_ulysses(mesh, axis, causal):
    spec = P(None, axis)
    return jax.jit(jax.shard_map(
        lambda q, k, v: ref_ulysses(q, k, v, axis, causal=causal), mesh=mesh,
        in_specs=(spec, spec, spec), out_specs=spec, check_vma=False))


def _port_ulysses(sp, causal):
    def run(q, k, v):
        return from_blocks(ulysses_attention(*(to_blocks(a, sp) for a in (q, k, v)),
                                             causal=causal))
    return run


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_matches_the_reference(impl, causal, dtype, topo8):
    """Ring and Ulysses attention over 8 stacked blocks against the
    reference's over the 8-device mesh, at the reference's tolerances."""
    qkv = _qkv()
    jq = tuple(jnp.asarray(a, dtype) for a in qkv)
    tq = tuple(torch.from_numpy(np.array(a, np.float32)).to(
        torch.float32 if dtype == np.float32 else torch.bfloat16) for a in jq)
    if impl == "ring":
        want = ref_make_ring(topo8.mesh, "dp", causal=causal)(*jq)
        got = make_ring_attention(8, causal=causal)(*tq)
    else:
        want = _ref_ulysses(topo8.mesh, "dp", causal)(*jq)
        got = _port_ulysses(8, causal)(*tq)
    assert got.dtype == tq[0].dtype and got.shape == tq[0].shape
    tol = ATT_TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    # and both against dense attention over the whole sequence
    dense = ref_dense(*jq, causal=causal)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(dense, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_causal_prefix_invariance(impl):
    """A causal row's output does not change when the keys and values after
    it change, across block boundaries (``tests/test_ring_attention.py``)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(t=32))
    att = make_ring_attention(8, causal=True) if impl == "ring" else _port_ulysses(8, True)
    base = att(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 20:], v2[:, 20:] = 7.0, -3.0
    got = att(q, k2, v2)
    torch.testing.assert_close(got[:, :20], base[:, :20], rtol=1e-5, atol=1e-5)
    assert not torch.allclose(got[:, 21:], base[:, 21:])


def test_head_divisibility_and_bad_rank_errors(topo8):
    """Ulysses needs H % sp == 0, with the reference's message; a rank
    other than the blocks' is refused."""
    q = np.zeros((2, 64, 2, 8), np.float32)
    with pytest.raises(ValueError) as ref_err:
        _ref_ulysses(topo8.mesh, "dp", True)(q, q, q)
    blocks = to_blocks(torch.from_numpy(q), 8)
    with pytest.raises(ValueError) as port_err:
        ulysses_attention(blocks, blocks, blocks, causal=True, axis_name="dp")
    assert str(port_err.value) == str(ref_err.value)
    for fn in (ring_attention, ulysses_attention):
        with pytest.raises(ValueError, match=r"\(sp, B, T, H, D\)"):
            fn(torch.zeros(2, 64, 2, 8), torch.zeros(2, 64, 2, 8), torch.zeros(2, 64, 2, 8))
    with pytest.raises(ValueError, match=r"\(B, T, H, D\)"):
        make_ring_attention(8)(blocks, blocks, blocks)


def test_unknown_seq_impl_is_refused_with_the_references_error():
    x = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError) as ref_err:
        JaxLM(vocab_size=V, max_len=8, seq_impl="tree").init(jax.random.key(0), x)
    with pytest.raises(ValueError) as port_err:
        TransformerLM(V, max_len=8, seq_impl="tree", device="cpu")
    assert str(port_err.value) == str(ref_err.value)


# ------------------------------------------------------------------ model

def _models(seq_axis, layers=2, seq_impl="ring"):
    kw = dict(num_layers=layers, d_model=32, num_heads=2, max_len=T)
    return (JaxLM(vocab_size=V, compute_dtype=jnp.float32, seq_axis=seq_axis,
                  seq_impl=seq_impl, **kw),
            TransformerLM(V, compute_dtype=torch.float32, seq_axis=seq_axis,
                          seq_impl=seq_impl, device="cpu", **kw))


def _data(seed=0, n=B):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, V, (n, T)).astype(np.int32)
    return x, np.roll(x, -1, axis=1).astype(np.int32)


@pytest.mark.parametrize("seq_impl", ["ring", "ulysses"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
def test_sharded_apply_matches_the_references(shape, seq_impl):
    """The sp-sharded model's logits (global positions, sequence-parallel
    attention) against the reference's ``shard_map`` apply
    (``tests/test_seq_parallel.py:81-107``). Ulysses needs heads % sp == 0,
    so it runs with 8 heads at (1, 8) and 4 at (2, 4)."""
    topo = _ref_world(("dp", "sp"), shape)
    sp = shape[1]
    heads = sp if seq_impl == "ulysses" else 2
    kw = dict(num_layers=2, d_model=32, num_heads=heads, max_len=T)
    jm = JaxLM(vocab_size=V, compute_dtype=jnp.float32, seq_axis="sp",
               seq_impl=seq_impl, **kw)
    pm = TransformerLM(V, compute_dtype=torch.float32, seq_axis="sp",
                       seq_impl=seq_impl, device="cpu", **kw)
    x, _ = _data(seed=3, n=2)
    params = JaxSeq(jm, optax.sgd(0.1), topo, donate_state=False).init_state(
        jax.random.key(1), x[:, : T // sp]).params
    want = jax.jit(jax.shard_map(
        lambda p, t: jm.apply({"params": p}, t), mesh=topo.mesh,
        in_specs=(P(), P("dp", "sp")), out_specs=P("dp", "sp"), check_vma=False,
    ))(params, jnp.asarray(x))
    tp = from_flax(jax.tree.map(np.asarray, params), device="cpu")
    got = from_blocks(pm.apply(tp, to_blocks(torch.from_numpy(x), sp)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **APPLY_TOL)
    # at sp = 1 the blocked model is the dense one
    dense = TransformerLM(V, compute_dtype=torch.float32, device="cpu", **kw)
    one = pm.apply(tp, to_blocks(torch.from_numpy(x), 1))[0]
    torch.testing.assert_close(one, dense.apply(tp, torch.from_numpy(x)), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exceeds max_len"):
        pm.apply(tp, torch.zeros(2 * sp, 2, T // sp, dtype=torch.int64))


# ---------------------------------------------------------------- trainer

def _ref_steps(shape, steps=3):
    topo = _ref_world(("dp", "sp"), shape)
    jm, _ = _models("sp", layers=1)
    trainer = JaxSeq(jm, optax.sgd(0.1, momentum=0.9), topo, donate_state=False)
    x, y = _data()
    state = trainer.init_state(jax.random.key(0), x[: B // shape[0], : T // shape[1]])
    init_params = jax.tree.map(np.asarray, jax.device_get(state.params))
    losses = []
    for _ in range(steps):
        state, m = trainer.step(state, x, y)
        losses.append(float(m["loss"]))
    params = jax.tree.map(np.asarray, jax.device_get(state.params))
    return init_params, losses, params, trainer.evaluate(state, x, y)


@pytest.mark.parametrize("shape", [(8, 1), (2, 4), (1, 8)], ids=["8x1", "2x4", "1x8"])
def test_three_steps_match_the_reference_trainer(shape):
    """Three f32 SGD-momentum steps of a 1-layer LM on one global batch:
    the port's losses, params and evaluation against the reference
    ``SeqParallelTrainer``'s at the same mesh shape, within the reference's
    mesh-invariance limits."""
    init_params, want_losses, want_params, (want_acc, want_loss) = _ref_steps(shape)
    _, pm = _models("sp", layers=1)
    topo = Topology(8, CPU, axis_names=("dp", "sp"), mesh_shape=shape)
    trainer = SeqParallelTrainer(pm, optim.SGD(0.1, momentum=0.9), topo)
    state = trainer.init_state(params=from_flax(init_params, device="cpu"))
    x, y = _data()
    losses = []
    for _ in range(3):
        state, m = trainer.step(state, x, y)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    for a, b in zip(jax.tree.leaves(want_params), jax.tree.leaves(to_flax(state.params)),
                    strict=True):
        np.testing.assert_allclose(b, a, **PARAM_TOL)
    acc, loss = trainer.evaluate(state, x, y)
    assert acc == pytest.approx(want_acc, abs=1e-6)
    assert loss == pytest.approx(want_loss, rel=1e-4)
    assert state.step == 3


def test_trainer_refusals_match_the_references():
    """A 1-D world, a model without the world's sequence axis, a batch the
    mesh does not divide and an eval length sp does not divide are refused
    (``mpit_tpu/parallel/seq.py:61-78,152-158,203-217``)."""
    _, pm = _models("sp", layers=1)
    with pytest.raises(ValueError, match="2-D mesh"):
        SeqParallelTrainer(pm, optim.SGD(0.1), Topology(8, CPU))
    topo = Topology(8, CPU, axis_names=("dp", "sp"), mesh_shape=(2, 4))
    with pytest.raises(ValueError, match="seq_axis"):
        SeqParallelTrainer(_models(None, layers=1)[1], optim.SGD(0.1), topo)
    trainer = SeqParallelTrainer(pm, optim.SGD(0.1), topo)
    state = trainer.init_state(torch.Generator().manual_seed(0))
    x, y = _data()
    with pytest.raises(ValueError, match="not divisible by mesh"):
        trainer.step(state, x[:3], y[:3])
    with pytest.raises(ValueError, match="not divisible by mesh"):
        trainer.step(state, x[:, :62], y[:, :62])
    with pytest.raises(ValueError, match="sequence length 62"):
        trainer.evaluate(state, x[:, :62], y[:, :62])
    # the eval set's length owes the mesh nothing
    acc, _ = trainer.evaluate(state, x[:5], y[:5])
    assert 0.0 <= acc <= 1.0


def test_seq_sync_checkpoint_bytes_equal_flax_to_bytes(tmp_path):
    """A seq-sync state (params, SGD's trace, the step) saved by the port is
    ``flax.serialization.to_bytes`` of the reference's, byte for byte, and
    the port restores the reference's bytes."""
    topo = _ref_world(("dp", "sp"), (2, 4))
    jm, pm = _models("sp", layers=1)
    js = JaxSeq(jm, optax.sgd(0.1, momentum=0.9), topo, donate_state=False).init_state(
        jax.random.key(0), np.zeros((4, T // 4), np.int32))
    rng = np.random.default_rng(1)
    js = jax.tree.map(lambda a: (np.full(a.shape, 5, np.int32) if a.dtype == np.int32
                                 else rng.normal(size=a.shape).astype(a.dtype)),
                      jax.device_get(js))
    want = flax.serialization.to_bytes(js)
    (tmp_path / "ckpt_00000005.msgpack").write_bytes(want)
    trainer = SeqParallelTrainer(
        pm, optim.SGD(0.1, momentum=0.9),
        Topology(8, CPU, axis_names=("dp", "sp"), mesh_shape=(2, 4)))
    state, step = ckpt.restore_checkpoint(
        str(tmp_path), trainer.init_state(torch.Generator().manual_seed(0)))
    assert step == 5 and state.step == 5
    path = ckpt.save_checkpoint(str(tmp_path / "port"), state, step=5)
    assert open(path, "rb").read() == want


# ------------------------------------------------------------------- run()

def _cfg(**over):
    return dataclasses.replace(TrainConfig().apply_preset("ptb-transformer-seq"),
                               train_size=32, global_batch=8, seq_len=32, **over)


@pytest.mark.parametrize("over", [dict(sp=2, remat=True), dict(sp=4)],
                         ids=["sp2-remat", "sp4"])
def test_run_resumes_the_references_checkpoint_as_the_reference_does(over, tmp_path):
    """``run()`` of ``ptb-transformer-seq`` (bf16): the reference trains
    the first epoch (4 steps) and checkpoints; both packages resume from
    copies of that file for the second. The port returns the reference's
    keys with its ``workers`` (the dp extent), units and samples, and its
    losses, accuracy and final params agree within the bf16 trajectory
    tolerance."""
    from mpit_tpu.run import run as ref_run
    from mpit_tpu_torch.run import run as port_run

    base = _cfg(**over)
    ref_run(dataclasses.replace(base, epochs=1, ckpt_dir=str(tmp_path / "first")))
    for name in ("ref", "port"):
        shutil.copytree(tmp_path / "first", tmp_path / name)
    resumed = dataclasses.replace(base, epochs=2, resume=True)
    r = ref_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "ref")))
    p = port_run(dataclasses.replace(resumed, ckpt_dir=str(tmp_path / "port")), device="cpu")
    assert set(r) <= set(p)
    for key in ("workers", "trained_units", "samples", "resumed_from", "last_checkpoint"):
        assert p[key] == r[key], key
    assert p["workers"] == 8 // over["sp"]
    for key in ("final_loss", "eval_loss", "accuracy"):
        np.testing.assert_allclose(p[key], r[key], **BF16_TRAJ_TOL, err_msg=key)
    want, got = (ckpt.msgpack_restore(open(tmp_path / d / "ckpt_00000008.msgpack",
                                           "rb").read()) for d in ("ref", "port"))
    for a, b in zip(jax.tree.leaves(want["params"]), jax.tree.leaves(got["params"]),
                    strict=True):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a), **BF16_TRAJ_TOL)


def test_run_refuses_an_sp_that_does_not_divide_the_workers_and_warns_as_the_reference():
    """``sp`` must divide the world (``mpit_tpu/run.py:_world_for``);
    ``seq_impl`` and ``remat`` off their algo or model warn with the
    reference's words (``tests/test_run_presets.py:95-125``)."""
    from mpit_tpu import run as ref
    from mpit_tpu_torch import run as port

    with pytest.raises(ValueError, match="does not divide"):
        port.run(_cfg(sp=3), device="cpu")
    for over, match in ((dict(algo="sync", seq_impl="ulysses"), "seq_impl"),
                        (dict(model="mlp", dataset="mnist", remat=True),
                         "remat is implemented")):
        cfg = _cfg(**over)
        with pytest.warns(UserWarning, match=match) as ref_w:
            ref._build_model(cfg, {"vocab_size": V})
        with pytest.warns(UserWarning, match=match) as port_w:
            port.build_model(cfg, "cpu", {"vocab_size": V})
        assert [str(w.message) for w in port_w] == [str(w.message) for w in ref_w]
