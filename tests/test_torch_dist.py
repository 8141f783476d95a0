"""The port's process world: ``python -m mpit_tpu_torch.launch -n 2
--jax-distributed`` over gloo on the CPU (2 ranks × W = 2 stacked workers),
against a 1-process W = 4 run, and the collective interface against the
reference's under ``shard_map`` on the 8-device CPU mesh (``topo8``).

Every rank is a subprocess started through the port's launcher with a
timeout, as ``tests/test_launch.py`` starts the reference's (the test
process itself imports ``mpit_tpu`` through ``tests/conftest.py``)."""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import mpit_tpu
from mpit_tpu.comm import collectives as ref
from mpit_tpu_torch.comm import collectives as port
from mpit_tpu_torch.comm.topology import (
    finalize, init, process_count, process_rank, rank,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "mpit_tpu_torch", "examples", "multihost_sync.py")
TIMEOUT_S = 240
# the f32 trajectory tolerance of tests/test_torch_easgd.py: two processes
# sum the same gradients in another order than one
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("MPIT_", "JAX_COORDINATOR"))}
    env.update(extra)
    env["JAX_PLATFORMS"] = "cpu"
    # one intra-op thread a rank: the suite runs several test processes at
    # once, and oversubscribed small CPU ops run many times slower
    env["OMP_NUM_THREADS"] = "1"
    return env


def _launch(n, args, distributed=True, **env):
    cmd = [sys.executable, "-m", "mpit_tpu_torch.launch", "-n", str(n)]
    if distributed:
        cmd.append("--jax-distributed")
    return subprocess.run([*cmd, *args], cwd=REPO, env=_env(**env), capture_output=True,
                          text=True, timeout=TIMEOUT_S)


@pytest.mark.parametrize("algo", ["sync", "easgd", "zero", "sync-bf16"])
def test_two_gloo_ranks_train_as_one_process_of_the_same_world(algo, tmp_path):
    """2 ranks × W = 2 over gloo: ``num_workers`` is 4 (the reference's
    arithmetic), both ranks report the same losses, which equal a
    1-process W = 4 run's within TRAJ_TOL; the checkpoint every rank
    gathers, rank 0 writes and every rank restores round-trips bit for
    bit, and a 1-process W = 4 state restores from it. ``zero`` is ZeRO-1
    with Adam (each rank holds half the optimizer state; the checkpoint
    gathers it); ``sync-bf16`` the bucketed exchange under
    ``MPIT_DP_QUANT=bf16``, whose codes cross the processes as bytes."""
    out, one = str(tmp_path / "two"), str(tmp_path / "one")
    env = {"MPIT_DP_QUANT": "bf16"} if algo == "sync-bf16" else {}
    algo = algo.removesuffix("-bf16")
    common = ["--algo", algo, "--steps", "8", "--device", "cpu"]
    r = _launch(2, [SCRIPT, *common, "--local-devices", "2",
                    "--ckpt-dir", str(tmp_path / "ck"), "--out", out], **env)
    assert r.returncode == 0, r.stdout + r.stderr
    r1 = _launch(1, [SCRIPT, *common, "--local-devices", "4", "--out", one],
                 distributed=False, **env)
    assert r1.returncode == 0, r1.stdout + r1.stderr
    ranks = [json.load(open(f"{out}.rank{i}.json")) for i in range(2)]
    solo = json.load(open(f"{one}.rank0.json"))
    for m in ranks:
        assert (m["num_workers"], m["process_count"]) == (4, 2)
        assert m["ckpt_roundtrip"] is True
        assert m["last_loss"] < m["first_loss"]
    assert ranks[0]["last_loss"] == ranks[1]["last_loss"]
    assert ranks[0]["first_loss"] == ranks[1]["first_loss"]
    np.testing.assert_allclose([ranks[0]["first_loss"], ranks[0]["last_loss"]],
                               [solo["first_loss"], solo["last_loss"]], **TRAJ_TOL)

    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.models import MLP
    from mpit_tpu_torch.optim import SGD, Adam
    from mpit_tpu_torch.parallel import (
        DataParallelTrainer, EASGDTrainer, ZeroDataParallelTrainer,
    )
    from mpit_tpu_torch.utils.checkpoint import restore_checkpoint

    topo = Topology(4, torch.device("cpu"))
    model = MLP(hidden=(64,), compute_dtype=torch.float32, device="cpu")
    trainer = {"sync": lambda: DataParallelTrainer(model, SGD(0.2), topo),
               "zero": lambda: ZeroDataParallelTrainer(model, Adam(1e-3), topo),
               "easgd": lambda: EASGDTrainer(model, SGD(0.2, 0.9), topo, tau=4)}[algo]()
    state, step = restore_checkpoint(str(tmp_path / "ck"),
                                     trainer.init_state(torch.Generator().manual_seed(0)))
    assert step == 8
    if algo == "easgd":
        assert state.round == 8
        assert state.worker_params["Dense_0"]["kernel"].shape[0] == 4
    if algo == "zero":
        assert state.opt_state[0].count == 8
        assert state.opt_state[0].mu.shape == (-(-sum(
            t.numel() for t in jax.tree.leaves(state.params)) // 4) * 4,)


def test_nccl_needs_a_card_per_rank():
    """More ranks than visible cards under NCCL raises and says why; it
    does not fall back to gloo."""
    r = _launch(2, [SCRIPT, "--steps", "1"])
    assert r.returncode != 0
    assert ("visible card" in r.stdout + r.stderr
            or "no CUDA device" in r.stdout + r.stderr)


# ------------------------------------------------------- the collectives

COLLECTIVES = "sum avg max min prod bcast allgather allgather_tiled reduce_scatter".split()


def _data(w=8):
    rng = np.random.default_rng(0)
    return {"a": rng.normal(size=(w, 8, 6)).astype(np.float32),
            "b": (rng.uniform(0.5, 1.5, size=(w, 16)) * rng.choice([-1, 1], (w, 16))
                  ).astype(np.float32)}


def _ref_collective(name, tree, mesh):
    fns = {
        "sum": lambda t: ref.allreduce(t, ref.SUM),
        "avg": lambda t: ref.allreduce(t, ref.AVG),
        "max": lambda t: ref.allreduce(t, ref.MAX),
        "min": lambda t: ref.allreduce(t, ref.MIN),
        "prod": lambda t: ref.allreduce(t, ref.PROD),
        "bcast": lambda t: ref.bcast(t, root=5),
        "allgather": lambda t: ref.allgather(t),
        "allgather_tiled": lambda t: ref.allgather(t, tiled=True),
        "reduce_scatter": lambda t: ref.reduce_scatter(t),
    }
    per_worker = name == "reduce_scatter"

    def body(t):
        out = fns[name](jax.tree.map(lambda a: a[0], t))
        return jax.tree.map(lambda a: a[None], out)

    run = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("dp"), out_specs=P("dp"),
                                check_vma=False))
    out = jax.device_get(run(tree))
    # every worker holds the same result except reduce_scatter's shards
    return out if per_worker else jax.tree.map(lambda a: a[0], out)


def _port_collective(name, tree):
    fns = {
        "sum": lambda t: port.allreduce(t, port.SUM),
        "avg": lambda t: port.allreduce(t, port.AVG),
        "max": lambda t: port.allreduce(t, port.MAX),
        "min": lambda t: port.allreduce(t, port.MIN),
        "prod": lambda t: port.allreduce(t, port.PROD),
        "bcast": lambda t: port.bcast(t, root=5),
        "allgather": lambda t: port.allgather(t),
        "allgather_tiled": lambda t: port.allgather(t, tiled=True),
        "reduce_scatter": lambda t: port.reduce_scatter(t),
    }
    return jax.tree.map(lambda t: t.numpy(), fns[name](tree))


@pytest.fixture
def port8():
    finalize()
    yield init(num_workers=8, device="cpu")
    finalize()


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collectives_match_the_reference_under_shard_map(name, topo8, port8):
    """Each collective over the 8 stacked workers against the reference's
    inside ``shard_map`` on the 8-device mesh: MAX, MIN, bcast and
    allgather bit for bit (they move or pick values), the sums and the
    product within one rounding per term (another order)."""
    data = _data()
    want = _ref_collective(name, data, topo8.mesh)
    got = _port_collective(name, jax.tree.map(torch.from_numpy, data))
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got), strict=True):
        assert np.shape(a) == b.shape
        if name in ("max", "min", "bcast", "allgather", "allgather_tiled"):
            assert np.array_equal(np.asarray(a), b)
        else:
            np.testing.assert_allclose(b, np.asarray(a), rtol=1e-6, atol=1e-6)


def test_barriers_rank_and_the_unported_exchange(topo8, port8):
    assert int(port.device_barrier()) == 8 == int(jax.jit(jax.shard_map(
        lambda: ref.device_barrier()[None], mesh=topo8.mesh, in_specs=(),
        out_specs=P("dp"), check_vma=False))()[0])
    port.barrier("mpit_test")  # one process: returns at once
    assert rank().tolist() == list(range(8))
    assert (process_rank(), process_count()) == (0, 1)
    with pytest.raises(ValueError, match="out of range"):
        port.bcast(torch.zeros(8, 2), root=8)
    # the quantized exchange, item A6, runs: int8 codes of rows with absmax
    # 127 sum exactly, as under shard_map (tests/test_quant_collectives.py)
    x = torch.tensor([[127.0, -3.0]] * 8)
    assert torch.equal(port.allreduce(x, quant="int8"), x.sum(0))
    # ppermute_ring: worker i's row lands at i + shift, as under shard_map
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    for shift in (1, -1, 3):
        want = np.asarray(jax.jit(jax.shard_map(
            lambda s: ref.ppermute_ring(s, shift=shift), mesh=topo8.mesh,
            in_specs=P("dp"), out_specs=P("dp"), check_vma=False))(x))
        assert np.array_equal(port.ppermute_ring(torch.from_numpy(x), shift).numpy(), want)


_ACROSS = """
import json, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
import mpit_tpu_torch as m
from mpit_tpu_torch.comm import collectives as c
topo = m.init(num_workers=int(sys.argv[1]), device="cpu")
rng = np.random.default_rng(0)
full = {{"a": rng.normal(size=(4, 4, 6)).astype(np.float32),
        "b": rng.uniform(0.5, 1.5, size=(4, 8)).astype(np.float32)}}
mine = topo.local_slice(4)
tree = {{k: torch.from_numpy(v[mine]) for k, v in full.items()}}
out = {{name: {{k: v.tolist() for k, v in fn(tree).items()}} for name, fn in (
    ("sum", c.psum), ("avg", c.pmean), ("max", c.pmax), ("min", c.pmin),
    ("prod", lambda t: c.allreduce(t, c.PROD)), ("bcast", lambda t: c.bcast(t, 3)),
    ("allgather", c.allgather), ("reduce_scatter", c.reduce_scatter),
    ("ppermute", lambda t: c.ppermute_ring(t, 3)),
    ("qsum_int8", lambda t: c.allreduce(t, c.SUM, quant="int8")),
    ("qavg_bf16", lambda t: c.allreduce(t, c.AVG, quant="bf16")),
    ("qres_int8", lambda t: c.quantized_allreduce(t, mode="int8", mean=True)[1]),
    ("qscatter_int8", lambda t: {{k: c.quantized_psum_scatter(v.reshape(len(v), -1), "int8")
                                  for k, v in t.items()}}))}}
out["barrier"] = int(c.device_barrier())
c.barrier()
json.dump(out, open(sys.argv[2] + f".rank{{topo.process_index}}.json", "w"))
m.finalize()
"""


def test_collectives_across_two_gloo_processes(tmp_path):
    """The same collectives with the 4 workers split 2 + 2 over two gloo
    processes: each process's results equal one process's of all 4
    (``reduce_scatter``, ``ppermute_ring`` and the per-worker outputs of
    the quantized exchange its own workers' rows), bit for bit where the
    values are moved or picked, and for the quantized exchange, whose
    all-to-all delivers each worker's rows in world order to the same
    f32 sums (bf16 codes crossing as bytes)."""
    script = tmp_path / "across.py"
    script.write_text(_ACROSS.format(repo=REPO))
    r = _launch(2, [str(script), "2", str(tmp_path / "two")])
    assert r.returncode == 0, r.stdout + r.stderr
    r = _launch(1, [str(script), "4", str(tmp_path / "one")], distributed=False)
    assert r.returncode == 0, r.stdout + r.stderr
    one = json.load(open(tmp_path / "one.rank0.json"))
    for rank in range(2):
        two = json.load(open(tmp_path / f"two.rank{rank}.json"))
        assert two["barrier"] == one["barrier"] == 4
        for name in ("sum", "avg", "max", "min", "prod", "bcast", "allgather",
                     "reduce_scatter", "ppermute", "qsum_int8", "qavg_bf16",
                     "qres_int8", "qscatter_int8"):
            for k in ("a", "b"):
                want = np.array(one[name][k])
                if name in ("reduce_scatter", "ppermute", "qres_int8", "qscatter_int8"):
                    want = want[2 * rank:2 * rank + 2]
                got = np.array(two[name][k])
                if name in ("max", "min", "bcast", "allgather", "ppermute") or name[0] == "q":
                    assert np.array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
