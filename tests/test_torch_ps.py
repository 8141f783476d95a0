"""The port's host-async parameter server against the reference's.

``mpit_tpu_torch``'s ring placement, membership, dedup window and
``PServer``/``PClient`` are copies of the reference's numpy code, so they
are held equal bit for bit: the same scripted calls and messages give the
same returns, counts and centers. The trainer and ``run()`` run the
clients' local steps in PyTorch, so they are held within a stated
tolerance, and the reference's own behaviour tests run on the port.
"""

import dataclasses
import json
import importlib
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import mpit_tpu.run as ref_run
from mpit_tpu.data import load_mnist
from mpit_tpu.models import MLP as JaxMLP
from mpit_tpu.models import LeNet as JaxLeNet
from mpit_tpu.parallel import AsyncPSTrainer as RefTrainer
from mpit_tpu.parallel import elastic as ref_elastic
from mpit_tpu.parallel import pclient as ref_pclient
from mpit_tpu.parallel import pserver as ref_pserver
from mpit_tpu.transport import Broker as RefBroker
from mpit_tpu.utils.config import TrainConfig as RefConfig
from mpit_tpu_torch import quant as port_quant
from mpit_tpu_torch import run as port_run
from mpit_tpu_torch.comm.topology import Topology
from mpit_tpu_torch.convert import from_flax, to_flax
from mpit_tpu_torch.models import MLP, LeNet
from mpit_tpu_torch.optim import SGD
from mpit_tpu_torch.parallel import AsyncPSTrainer, EASGDTrainer
from mpit_tpu_torch.parallel import elastic as port_elastic
from mpit_tpu_torch.parallel import pclient as port_pclient
from mpit_tpu_torch.parallel import pserver as port_pserver
from mpit_tpu_torch.parallel import ps_roles
from mpit_tpu_torch.transport import Broker as PortBroker
from mpit_tpu_torch.utils.config import TrainConfig
from mpit_tpu_torch.utils.params import tree_leaves, tree_map

from mpit_tpu import quant as ref_quant

# the submodules: both ``comm`` packages re-export a ``topology()``
# function that shadows the module of the same name
ref_topo = importlib.import_module("mpit_tpu.comm.topology")
port_topo = importlib.import_module("mpit_tpu_torch.comm.topology")

CPU = "cpu"
# the reference's own limits for a 1-client PS run against a trajectory
# it should reproduce (tests/test_async_ps.py:157)
PS_TOL = dict(rtol=2e-4, atol=2e-5)
# the reference's ps_trainer tests shard this set (tests/test_async_ps.py:17)
_MNIST = {}


def mnist():
    if not _MNIST:
        _MNIST["data"] = load_mnist(synthetic_train=2048, synthetic_test=512)
    return _MNIST["data"]


# ------------------------------------------------------------- placement


MEMBER_SETS = [(0,), (0, 1), (0, 1, 2), (2, 0, 1, 0), (3, 7, 11, 12), tuple(range(8))]


@pytest.mark.parametrize("members", MEMBER_SETS, ids=str)
@pytest.mark.parametrize("vnodes", [64, 7])
def test_ring_placement_and_reshard_schedule_equal_the_reference(members, vnodes):
    ref_ring = ref_topo.HashRing(members, vnodes=vnodes)
    ring = port_topo.HashRing(members, vnodes=vnodes)
    assert (ring.members, ring.vnodes, ring.version) == (
        ref_ring.members, ref_ring.vnodes, ref_ring.version)
    assert [ring.owner(k) for k in range(500)] == [ref_ring.owner(k) for k in range(500)]
    assert repr(ring) == repr(ref_ring)
    for size, shards in [(300, 12), (97, 6), (1_000_003, 64), (5, 9)]:
        sm = port_topo.ShardMap(ring, size, shards)
        ref_sm = ref_topo.ShardMap(ref_ring, size, shards)
        assert sm.layout == ref_sm.layout == ref_topo.shard_layout(size, shards)
        assert port_topo.shard_layout(size, shards) == ref_sm.layout
        assert sm.assignment == ref_sm.assignment
        assert sm.server_ranks() == ref_sm.server_ranks()
        for r in set(members) | {99}:
            assert sm.ranges_for(r) == ref_sm.ranges_for(r)
            assert sm.owned_size(r) == ref_sm.owned_size(r)
        for leaver in sorted(set(members))[:-1] if len(set(members)) > 1 else []:
            new, ref_new = sm.with_ring(ring.without(leaver)), ref_sm.with_ring(
                ref_ring.without(leaver))
            assert new.ring.version == ref_new.ring.version == 1
            moves = port_topo.reshard_schedule(sm, new)
            assert moves == ref_topo.reshard_schedule(ref_sm, ref_new)
            assert port_topo.schedule_peak_elems(moves, sm) == ref_topo.schedule_peak_elems(
                moves, ref_sm)
    grown, ref_grown = ring.with_member(42), ref_ring.with_member(42)
    assert (grown.members, grown.version) == (ref_grown.members, ref_grown.version)
    assert [grown.owner(k) for k in range(200)] == [ref_grown.owner(k) for k in range(200)]


def test_ring_assignment_pin_and_errors_match():
    """The reference's golden pin (``tests/test_sharding.py``), a
    wire-visible constant, holds in the port too."""
    assert port_topo.ShardMap(port_topo.HashRing((0, 1)), 97, 6).assignment == (
        1, 1, 0, 1, 0, 1)
    with pytest.raises(ValueError, match="at least one member"):
        port_topo.HashRing([])
    with pytest.raises(ValueError, match="positive"):
        port_topo.shard_layout(10, 0)
    a = port_topo.ShardMap(port_topo.HashRing([0, 1]), 300, 12)
    with pytest.raises(ValueError, match="identical layout"):
        port_topo.reshard_schedule(a, port_topo.ShardMap(a.ring, 301, 12))


def test_partition_bounds_equal_the_reference():
    for total in (0, 1, 7, 103, 1_663_370):
        for n in (1, 2, 3, 4, 16):
            assert port_pserver.partition_bounds(total, n) == ref_pserver.partition_bounds(
                total, n)


def _script_membership(mod):
    m = mod.ElasticMembership(2, [1, 2])
    out = [m.register(1, epoch=111), m.register(1, epoch=111), m.register(1, epoch=222),
           m.teardown_complete()]
    m.dead.add(2)
    m.stopped.add(1)
    out.append(m.teardown_complete())
    out.append(m.register(7, epoch=int.from_bytes(b"\xff" * 8, "big")))
    out.append(m.teardown_complete())
    m.leave(7)
    out += [m.teardown_complete(), m.register(2, epoch=5), m.view_epoch]
    other = mod.ElasticMembership(1, [1])
    dead = other.dead
    other.load_state(m.state())
    out += [other.dead is dead, other.state() == m.state()]
    return out, m.state()


def test_membership_returns_and_state_equal_the_reference():
    assert _script_membership(port_elastic) == _script_membership(ref_elastic)


def _script_dedup(mod):
    w = mod._DedupWindow(size=4)
    out = [w.admit(src, ep, seq) for src, ep, seq in [
        (1, 9, 1), (1, 9, 1), (1, 9, 3), (1, 9, 2), (1, 9, 8), (1, 9, 4), (1, 9, 3),
        (2, 9, 1), (1, 10, 1), (1, 9, 9), (1, 9, 5), (1, 9, 12), (1, 9, 7)]]
    other = mod._DedupWindow(size=4)
    other.admit(1, 9, 20)
    other.admit(3, 1, 2)
    other.absorb(w.state())
    out.append(other.admit(1, 9, 12))
    copy = mod._DedupWindow(size=4)
    copy.load_state(other.state())
    with pytest.raises(ValueError, match="window size"):
        mod._DedupWindow(size=0)
    return out, w.state(), other.state(), copy.state()


def test_dedup_window_returns_and_state_equal_the_reference():
    assert _script_dedup(port_pserver) == _script_dedup(ref_pserver)


# ------------------------------------------------------- scripted server

DIM = 37


def _vec(seed, n=DIM):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _flat_script(q):
    """(src, tag, payload) messages for a flat (one-chunk) server; ``q``
    is the package's quant module, so a quantized chunk is the class its
    server checks for."""
    pk = ref_pserver
    e1, e2 = 0xA1, int.from_bytes(b"\xfe" * 8, "big")
    return [
        (1, pk.TAG_FETCH, 11),
        (2, pk.TAG_JOIN, (21, e2)),
        (1, pk.TAG_PUSH_EASGD, (e1, 1, 0, _vec(1))),
        (2, pk.TAG_PUSH_DELTA, (e2, 1, 1, _vec(2))),
        (1, pk.TAG_PUSH_EASGD, (e1, 1, 0, _vec(1))),            # duplicate
        (1, pk.TAG_PUSH_EASGD, (e1, 2, _vec(3))),               # legacy envelope
        (2, pk.TAG_PUSH_EASGD, _vec(4)),                        # bare chunk
        (1, pk.TAG_PUSH_EASGD, (e1, 3, 2, q.quantize(_vec(5), "bf16"))),
        (2, pk.TAG_PUSH_DELTA, (e2, 2, 3, q.quantize(_vec(6), "int8"))),
        (1, pk.TAG_PUSH_EASGD, (e1, 4, 3, _vec(7, DIM + 1))),   # wrong shape
        (2, pk.TAG_HEARTBEAT, None),
        (1, pk.TAG_FETCH, None),                                # legacy fetch
        (2, pk.TAG_JOIN, ("x",)),                               # malformed
        (1, pk.TAG_SHARD_MAP, (5, [0])),                        # flat: no-op
        (2, pk.TAG_PUSH_DELTA, (e2, 3, 9, _vec(8))),
        (2, pk.TAG_LEAVE, None),
        (1, pk.TAG_STOP, None),
    ]


def _sharded_script(q):
    """Messages for a ring-sharded server (rank 0 owns all 5 shards of a
    one-member ring): part envelopes, a malformed part, a handoff of the
    shards a new view gives rank 3, their return as pending shards, one
    adopted by an EASGD part and one installed by a RESHARD transfer."""
    pk = ref_pserver
    layout = port_topo.shard_layout(DIM, 5)
    e1 = 0xC3

    def parts(seed, sids, quant=None):
        v = _vec(seed)
        return [(s, q.quantize(v[a:b], quant) if quant else v[a:b])
                for s, (a, b) in enumerate(layout) if s in sids]

    moved = [s for s in range(5)
             if port_topo.HashRing([0, 3]).owner(s) == 3]
    assert moved and len(moved) < 5
    stay = [s for s in range(5) if s not in moved]
    a, b = layout[moved[-1]]
    return [
        (1, pk.TAG_JOIN, (31, e1)),
        (1, pk.TAG_PUSH_EASGD, (e1, 1, 0, parts(11, range(5)))),
        (2, pk.TAG_PUSH_DELTA, (e1, 1, 1, parts(12, range(5), "int8"))),
        (1, pk.TAG_PUSH_EASGD, (e1, 1, 0, parts(11, range(5)))),   # duplicate
        (1, pk.TAG_PUSH_EASGD, (e1, 2, 1, parts(13, [0, 3]))),     # partial
        (1, pk.TAG_PUSH_EASGD, (e1, 3, 1, [(7, _vec(1, 3))])),     # bad shard id
        (1, pk.TAG_FETCH, 32),
        (2, pk.TAG_SHARD_MAP, (1, [0, 3])),                        # hand off
        (2, pk.TAG_SHARD_MAP, (1, [0, 3])),                        # same view
        (1, pk.TAG_PUSH_EASGD, (e1, 4, 2, parts(14, stay))),
        (1, pk.TAG_PUSH_DELTA, (e1, 5, 2, parts(15, moved))),      # misrouted
        (2, pk.TAG_SHARD_MAP, (2, [0])),                           # back: pending
        (1, pk.TAG_PUSH_EASGD, (e1, 6, 3, parts(16, moved[:1]))),  # adopts
        (3, pk.TAG_RESHARD, (2, moved[-1], 7, _vec(17, b - a),
                             [[1, e1, 40, [39, 40]]])),
        (1, pk.TAG_PUSH_EASGD, (e1, 39, 3, parts(18, range(5)))),  # absorbed: dup
        (1, pk.TAG_FETCH, 33),
        (2, pk.TAG_STOP, None),
        (1, pk.TAG_STOP, None),
    ]


def _serve_script(pkg, script_fn, sharded, ckpt_path=None):
    pserver, broker, q = pkg
    tps = broker(4).transports()
    shard_map = None
    if sharded:
        topo = port_topo if pserver is port_pserver else ref_topo
        shard_map = topo.ShardMap(topo.HashRing([0]), DIM, 5)
    server = pserver.PServer(
        tps[0], _vec(0), num_clients=2, alpha=0.5, server_lr=0.5,
        client_ranks=[1, 2], quant="off", shard_map=shard_map, ckpt_path=ckpt_path,
    )
    for src, tag, payload in script_fn(q):
        tps[src].send(0, tag, payload)
    server.start()  # runs the whole script in this thread, to its STOPs
    replies = {}
    for r in (1, 2, 3):
        got = []
        while tps[r].probe():
            m = tps[r].recv(timeout=1)
            got.append((m.src, m.tag, _plain(m.payload)))
        replies[r] = got
    snap = server._snapshot_state()
    return dict(
        center=server.snapshot().tobytes(), counts=server.counts,
        version=server.version, gen=server.gen, dead=server.dead_clients,
        staleness=server.staleness_by_src, dedup=snap["dedup"],
        membership=snap["membership"], shards=snap["shards"], ring=snap["ring"],
        owned=server.owned_ranges(), replies=replies, error=server.error,
    )


def _plain(payload):
    """A payload with arrays as (dtype, shape, bytes), for exact equality."""
    if isinstance(payload, np.ndarray):
        return (payload.dtype.str, payload.shape, payload.tobytes())
    if isinstance(payload, (tuple, list)):
        return type(payload).__name__, [_plain(p) for p in payload]
    return payload


PORT = (port_pserver, PortBroker, port_quant)
REF = (ref_pserver, RefBroker, ref_quant)


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_scripted_server_ends_bit_equal_to_the_reference(sharded):
    """One list of messages (fetches, joins, EASGD and Downpour pushes in
    every envelope shape, quantized chunks, a duplicate, malformed
    frames, a leave and stops; sharded: part envelopes, a handoff and the
    return of pending shards) into a reference server and a port server:
    the same center bytes, counts, versions, membership, dedup window,
    staleness and replies."""
    script = _sharded_script if sharded else _flat_script
    want = _serve_script(REF, script, sharded)
    got = _serve_script(PORT, script, sharded)
    assert want["error"] is None and got["error"] is None
    del want["error"], got["error"]
    assert got == want
    c = got["counts"]
    assert c["dup_dropped"] >= 1 and c["malformed_dropped"] >= 1
    if sharded:
        assert c["handoff_sent"] >= 1 and c["reshard"] == 1 and c["adopted_shards"] == 2
        assert c["misrouted_parts"] >= 1
    else:
        assert c["leave"] == 1 and c["join"] == 1 and c["push_delta"] == 3


# -------------------------------------------------- in-process interop


def _client_script(client, dim):
    """A client's exchanges: fetch, EASGD and Downpour pushes, a join."""
    got = [client.fetch()]
    client.push_easgd(_vec(41, dim))
    got.append(client.fetch())
    client.push_delta(_vec(42, dim))
    got.append(client.join())
    client.push_easgd(_vec(43, dim))
    got.append(client.fetch())
    client.stop()
    return got


def _interop(server_pkg, client_mod, num_servers):
    pserver, broker, _ = server_pkg
    tps = broker(num_servers + 1).transports()
    bounds = pserver.partition_bounds(DIM, num_servers)
    servers = [pserver.PServer(tps[r], _vec(0)[s:e], num_clients=1, alpha=0.5,
                               server_lr=0.5, client_ranks=[num_servers], quant="off")
               for r, (s, e) in enumerate(bounds)]
    threads = [pserver.spawn_server_thread(s) for s in servers]
    client = client_mod.PClient(tps[num_servers], list(range(num_servers)), DIM,
                                timeout=10, quant="off")
    fetched = _client_script(client, DIM)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    assert all(s.error is None for s in servers)
    return (np.concatenate([s.snapshot() for s in servers]).tobytes(),
            [s.counts for s in servers], [s.version for s in servers],
            [s.staleness_by_src for s in servers], [f.tobytes() for f in fetched],
            dict(client.push_sent), client.server_version)


@pytest.mark.parametrize("num_servers", [1, 2])
@pytest.mark.parametrize("server,client", [("ref", "port"), ("port", "ref")])
def test_clients_and_servers_of_the_two_packages_interoperate(server, client, num_servers):
    """A port PClient against a reference PServer over the reference's
    broker, and the reverse: the same centers, fetches and counts as the
    client of the server's own package (quant off)."""
    pkg = REF if server == "ref" else PORT
    other = port_pclient if client == "port" else ref_pclient
    own = ref_pclient if server == "ref" else port_pclient
    assert _interop(pkg, other, num_servers) == _interop(pkg, own, num_servers)


# ------------------------------------------------------ trainer parity


def _ref_ps(model, steps, bs, seed=0, **kw):
    x_tr, y_tr, *_ = mnist()
    tr = RefTrainer(model, optax.sgd(0.05, momentum=0.9), num_clients=1, num_servers=1,
                    algo="easgd", alpha=0.5, tau=4, transport="inproc", **kw)
    init = model.init(jax.random.key(seed), jnp.asarray(x_tr[:2]))["params"]
    center, stats = tr.train(x_tr, y_tr, steps=steps, batch_size=bs, seed=seed)
    return jax.tree.map(np.asarray, init), center, stats


def _port_ps(model, init, steps, bs, seed=0, **kw):
    x_tr, y_tr, *_ = mnist()
    tr = AsyncPSTrainer(model, SGD(0.05, 0.9), num_clients=1, num_servers=1,
                        algo="easgd", alpha=0.5, tau=4, device=CPU, **kw)
    return tr.train(x_tr, y_tr, steps=steps, batch_size=bs, seed=seed, init_params=init)


@pytest.mark.parametrize("model,bs", [("mlp", 32), ("lenet", 32), ("mlp", 17)])
def test_one_client_trainer_matches_the_reference(model, bs):
    """1 client, 1 server, EASGD α = 0.5, τ = 4, 24 steps of batch 32 (and
    an odd batch, whose indices the port draws for all steps in one call
    where the reference draws per step), f32, from the reference's init
    (converted): the port's center matches the reference's within its own
    limits (rtol 2e-4, atol 2e-5; largest |err| measured on the CPU: 6.0e-8
    for the MLP, 7.2e-7 for LeNet, so LeNet needs no wider limit), and the
    server counts are equal."""
    jax_model, port_model = {
        "mlp": (JaxMLP(compute_dtype=jnp.float32), MLP(compute_dtype=torch.float32,
                                                       device=CPU)),
        "lenet": (JaxLeNet(compute_dtype=jnp.float32), LeNet(compute_dtype=torch.float32,
                                                             device=CPU)),
    }[model]
    init, ref_center, ref_stats = _ref_ps(jax_model, 24, bs)
    center, stats = _port_ps(port_model, from_flax(init, device=CPU), 24, bs)
    for a, g in zip(jax.tree.leaves(ref_center), jax.tree.leaves(to_flax(center))):
        np.testing.assert_allclose(g, np.asarray(a), **PS_TOL)
    assert stats["server_counts"] == ref_stats["server_counts"]
    assert stats["server_counts"][0]["push_easgd"] == 6
    assert stats["server_counts"][0]["fetch"] == 7
    np.testing.assert_allclose(stats["losses"][0], ref_stats["losses"][0], rtol=1e-5)
    assert set(stats) == set(ref_stats)


def _port_collective(model, params, steps, bs, tau, alpha, seed):
    """The port's collective EASGD at W = 1, fed the PS client's batch
    schedule: ``default_rng(seed + 1000)`` over the whole shard."""
    x_tr, y_tr, *_ = mnist()
    col = EASGDTrainer(model, SGD(0.05, 0.9), Topology(1, torch.device(CPU)),
                       tau=tau, alpha=alpha)
    state = col.init_state(params=params)
    rng = np.random.default_rng(seed + 1000)
    for _ in range(steps // tau):
        idx = [rng.integers(0, len(x_tr), bs) for _ in range(tau)]
        state, _ = col.step(state, np.stack([x_tr[i] for i in idx]),
                            np.stack([y_tr[i] for i in idx]))
    return state.center


def test_ps_run_matches_the_collective_trainer_trajectory():
    """The two EASGD runtimes of the port implement the same math (the
    reference's ``test_ps_easgd_matches_collective_trajectory``, on
    LeNet f32): a 1-client PS run reproduces the collective trainer's
    center at W = 1 from the same init and batches (``chip_smoke.py``'s
    ``ps-parity`` phase, on the CPU)."""
    model = LeNet(compute_dtype=torch.float32, device=CPU)
    params = model.init(torch.Generator().manual_seed(9))
    center, _ = AsyncPSTrainer(
        model, SGD(0.05, 0.9), num_clients=1, algo="easgd", alpha=0.5, tau=4, device=CPU,
    ).train(*mnist()[:2], steps=24, batch_size=32, seed=0, init_params=params)
    want = _port_collective(model, params, 24, 32, 4, 0.5, 0)
    for g, w in zip(jax.tree.leaves(to_flax(center)), jax.tree.leaves(to_flax(want))):
        np.testing.assert_allclose(g, w, **PS_TOL)


@pytest.mark.parametrize("seed", [9, 6])
def test_lenet_trajectory_sensitivity_behind_the_parity_seed(seed):
    """Why ``ps-parity`` starts from init seed 9: a last-bit change of the
    init (relative 6e-8, eight seeded draws) leaves seed 9's 24-step PS
    center within 1.2e-7, while at seed 6 it moves the center by more than
    1e-3 (LeNet f32, lr 0.05, momentum 0.9, τ = 4: a max-pool picks
    another element and the early trajectory amplifies it). On the card
    the two runtimes' convolutions and products round slightly apart, so
    only a seed like 9 can hold the reference's limits there."""
    model = LeNet(compute_dtype=torch.float32, device=CPU)
    params = model.init(torch.Generator().manual_seed(seed))

    def center(p):
        c, _ = AsyncPSTrainer(model, SGD(0.05, 0.9), num_clients=1, algo="easgd",
                              alpha=0.5, tau=4, device=CPU).train(
            *mnist()[:2], steps=24, batch_size=32, seed=0, init_params=p)
        return tree_leaves(c)

    base = center(params)
    moved = []
    for k in range(8):
        gen = torch.Generator().manual_seed(100 + k)
        nudged = tree_map(lambda a: a * (1 + 6e-8 * torch.randn(a.shape, generator=gen)),
                          params)
        moved.append(max(float((a - b).abs().max()) for a, b in zip(center(nudged), base)))
    if seed == 9:
        assert max(moved) <= 1.2e-7, moved
    else:
        assert max(moved) > 1e-3, moved


def test_local_step_matches_the_collective_vmapped_step():
    """One LeNet f32 step of the PS client (plain autograd) and of the
    collective trainer (vmap over W = 1) round alike: LeNet copies its
    one-channel input into NCHW strides, so both convolutions take the
    same algorithm. With the permuted view alone the plain conv ran
    channels-last, and the two steps differed by 3.1e-5 in ``Conv_0``'s
    bias alone, which LeNet's trajectory amplifies (``ps-parity``)."""
    model = LeNet(compute_dtype=torch.float32, device=CPU)
    params = model.init(torch.Generator().manual_seed(0))
    opt = SGD(0.05, 0.9)
    x_tr, y_tr, *_ = mnist()
    got, _, _ = ps_roles.make_local_step(model, opt)(
        params, opt.init(params), torch.as_tensor(x_tr[:32]), torch.as_tensor(y_tr[:32]))
    col = EASGDTrainer(model, opt, Topology(1, torch.device(CPU)), tau=1, alpha=0.0)
    state, _ = col.step(col.init_state(params=params), x_tr[:32][None], y_tr[:32][None])
    want = [w[0] for w in tree_leaves(state.worker_params)]
    for g, w in zip(tree_leaves(got), want, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6)


def test_local_step_is_safe_from_two_threads():
    """The shared local step from two threads at once gives each thread
    what it gives alone (no lock between them): the forward runs on a
    model copy per thread, the gradient is ``autograd.grad``."""
    model = LeNet(compute_dtype=torch.float32, device=CPU)
    opt = SGD(0.05, 0.9)
    step = ps_roles.make_local_step(model, opt)
    x_tr, y_tr, *_ = mnist()
    runs = {}

    def run(k, params, n=6):
        p, o = params, opt.init(params)
        for i in range(n):
            sl = slice(32 * (i + k), 32 * (i + k + 1))
            p, o, loss = step(p, o, torch.as_tensor(x_tr[sl]), torch.as_tensor(y_tr[sl]))
        return p, float(loss)

    inits = [model.init(torch.Generator().manual_seed(k)) for k in range(2)]
    alone = [run(k, inits[k]) for k in range(2)]
    threads = [threading.Thread(target=lambda k=k: runs.__setitem__(k, run(k, inits[k])))
               for k in range(2)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often, inside the steps
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    # a forward on the other thread's parameters would differ by O(1)
    for k in range(2):
        assert runs[k][1] == pytest.approx(alone[k][1], rel=1e-5)
        for a, b in zip(jax.tree.leaves(to_flax(runs[k][0])),
                        jax.tree.leaves(to_flax(alone[k][0]))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


# ------------------------------- the reference's behaviour tests, ported


def test_easgd_2client_1server_trains():
    x_tr, y_tr, x_te, y_te = mnist()
    trainer = AsyncPSTrainer(
        MLP(compute_dtype=torch.float32, device=CPU), SGD(0.05, 0.9),
        num_clients=2, num_servers=1, algo="easgd", alpha=0.5, tau=4, device=CPU,
    )
    center, stats = trainer.train(x_tr, y_tr, steps=120, batch_size=64)
    acc = trainer.evaluate(center, x_te, y_te)
    assert acc > 0.9, f"async EASGD center failed to learn: acc={acc}, {stats['server_counts']}"
    counts = stats["server_counts"][0]
    # each client: one initial fetch + (steps/tau) push+fetch rounds
    assert counts["push_easgd"] == 2 * (120 // 4)
    assert counts["fetch"] == 2 * (120 // 4 + 1)
    assert [s["rounds"] for s in trainer.exchange_stats] == [30, 30]


def test_downpour_sharded_servers_train():
    x_tr, y_tr, x_te, y_te = mnist()
    trainer = AsyncPSTrainer(
        MLP(compute_dtype=torch.float32, device=CPU), SGD(0.05),
        num_clients=3, num_servers=2, algo="downpour", tau=4, server_lr=0.5, device=CPU,
    )
    center, stats = trainer.train(x_tr, y_tr, steps=160, batch_size=64)
    acc = trainer.evaluate(center, x_te, y_te)
    assert acc > 0.85, f"async Downpour failed: acc={acc}"
    # both servers saw every client's traffic
    for counts in stats["server_counts"]:
        assert counts["push_delta"] == 3 * (160 // 4)


def test_ring_sharded_trainer_trains():
    """``ps_shards``: the flat vector in 5 ring-placed shards over 2
    servers; every client's push reaches the servers that own shards."""
    x_tr, y_tr, x_te, y_te = mnist()
    trainer = AsyncPSTrainer(
        MLP(compute_dtype=torch.float32, device=CPU), SGD(0.05, 0.9),
        num_clients=2, num_servers=2, algo="easgd", tau=4, ps_shards=5, device=CPU,
    )
    center, stats = trainer.train(x_tr, y_tr, steps=40, batch_size=64)
    assert stats["ps_shards"] == 5 and trainer.evaluate(center, x_te, y_te) > 0.5
    owners = set(port_topo.ShardMap(port_topo.HashRing([0, 1]), 1, 5).assignment)
    for r, counts in enumerate(stats["server_counts"]):
        assert counts["push_easgd"] == (2 * (40 // 4) if r in owners else 0)


def test_server_error_surfaces():
    """An unknown tag kills the server; the error is recorded, not buried
    in a daemon thread."""
    tps = PortBroker(2).transports()
    server = port_pserver.PServer(tps[0], np.zeros(4, np.float32), num_clients=1)
    thread = port_pserver.spawn_server_thread(server)
    tps[1].send(0, tag=999, payload=None)
    thread.join(timeout=5)
    assert not thread.is_alive()
    assert isinstance(server.error, ValueError)
    assert "unknown tag" in str(server.error)


def test_client_error_surfaces_from_train():
    """A client thread that fails makes train() raise, after the servers
    are released."""
    def bad_loss(params, x, y):
        raise ArithmeticError("boom")

    trainer = AsyncPSTrainer(MLP(device=CPU), SGD(0.1), num_clients=2, loss_fn=bad_loss,
                             device=CPU)
    x_tr, y_tr, *_ = mnist()
    with pytest.raises(ArithmeticError, match="boom"):
        trainer.train(x_tr, y_tr, steps=4, batch_size=8)


def test_bad_algo_and_counts_raise():
    with pytest.raises(ValueError, match="unknown algo"):
        AsyncPSTrainer(MLP(device=CPU), SGD(0.1), algo="gossip", device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        AsyncPSTrainer(MLP(device=CPU), SGD(0.1), num_clients=0, device=CPU)
    with pytest.raises(ValueError, match="transport"):
        AsyncPSTrainer(MLP(device=CPU), SGD(0.1), transport="carrier-pigeon", device=CPU)
    with pytest.raises(ValueError, match="positive"):
        AsyncPSTrainer(MLP(device=CPU), SGD(0.1), client_timeout=0, device=CPU)


def test_server_persists_and_restores_center(tmp_path):
    path = str(tmp_path / "center_0.npy")
    tps = PortBroker(2).transports()
    server = port_pserver.PServer(tps[0], np.zeros(16, np.float32), num_clients=1,
                                  alpha=0.5, ckpt_path=path, ckpt_every=1)
    thread = port_pserver.spawn_server_thread(server)
    tps[1].send(0, port_pserver.TAG_PUSH_EASGD, np.ones(16, np.float32))
    tps[1].send(0, port_pserver.TAG_STOP, None)
    thread.join(timeout=10)
    assert not thread.is_alive() and server.error is None
    want = server.snapshot()
    assert want[0] == pytest.approx(0.5)
    # the file is the reference's format: its server restores it too
    for mod, broker in ((port_pserver, PortBroker), (ref_pserver, RefBroker)):
        revived = mod.PServer(broker(2).transports()[0], np.zeros(16, np.float32),
                              num_clients=1, ckpt_path=path)
        assert revived.restored
        np.testing.assert_array_equal(revived.snapshot(), want)
    with pytest.raises(ValueError, match="shape"):
        port_pserver.PServer(PortBroker(2).transports()[0], np.zeros(17, np.float32),
                             num_clients=1, ckpt_path=path)


def test_trainer_resume_continues_from_persisted_center(tmp_path):
    from mpit_tpu_torch.data import synthetic_image_classification

    x, y, *_ = synthetic_image_classification(256, 64, (8, 8, 1), 10, seed=0)
    kw = dict(num_clients=2, num_servers=2, tau=4, transport="inproc",
              ckpt_dir=str(tmp_path), ckpt_every=1, device=CPU)

    def mk(**extra):
        return AsyncPSTrainer(
            MLP(hidden=(16,), compute_dtype=torch.float32, in_shape=(8, 8, 1), device=CPU),
            SGD(0.1), **kw, **extra)

    center, stats = mk().train(x, y, steps=8, batch_size=32)
    assert stats["center_restored"] is False  # nothing to restore yet
    assert sorted(p.name for p in tmp_path.glob("center_*.npy")) == [
        "center_0.npy", "center_1.npy"]
    saved = np.concatenate([np.load(tmp_path / f"center_{r}.npy") for r in (0, 1)])
    # a restarted job (same dir) picks the persisted center up
    trainer = mk()
    _, stats = trainer.train(x, y, steps=0, batch_size=32)
    assert stats["center_restored"] is True
    from mpit_tpu_torch.utils.params import flatten_params

    np.testing.assert_array_equal(flatten_params(center)[0].numpy(), saved)
    # a deliberate fresh start drops the stale chunks instead
    _, stats = mk(resume=False).train(x, y, steps=8, batch_size=32)
    assert stats["center_restored"] is False


# ------------------------------------------------------------ run()


def _ps_cfg(mod_config, **kw):
    return dataclasses.replace(mod_config().apply_preset("mnist-ps"), steps=16,
                               transport="inproc", **kw)


def test_run_mnist_ps_returns_the_reference_keys_and_warns_as_it_does():
    """``run()`` on the mnist-ps preset cut to 16 steps, in both packages:
    the port's results carry the reference's keys (and three of its own,
    ``client_losses``, ``exchange_ms_per_round`` and ``transport_used``),
    the counts are the
    reference's, and
    ``grad_accum`` and ``exchange_dtype`` warn in both."""
    kw = dict(grad_accum=2, exchange_dtype="bf16")
    with pytest.warns(UserWarning) as ref_warned:
        want = ref_run.run(_ps_cfg(RefConfig, **kw))
    with pytest.warns(UserWarning) as port_warned:
        got = port_run.run(_ps_cfg(TrainConfig, **kw), device=CPU)
    msgs = lambda rec: sorted(str(w.message) for w in rec)  # noqa: E731
    assert msgs(port_warned) == msgs(ref_warned) and len(msgs(port_warned)) == 2
    assert set(got) == set(want) | {"client_losses", "exchange_ms_per_round",
                                    "transport_used"}
    assert [len(l) for l in got["client_losses"]] == [16, 16]
    assert got["final_loss"] == np.mean([l[-1] for l in got["client_losses"]])
    assert got["server_counts"] == want["server_counts"]
    assert got["server_counts"][0]["push_easgd"] == 2 * (16 // 4)
    assert got["server_counts"][0]["fetch"] == 2 * (16 // 4 + 1)
    assert got["dead_clients"] == [] and got["samples"] == want["samples"] == 16 * 256
    assert np.isfinite(got["final_loss"]) and 0.0 <= got["accuracy"] <= 1.0
    assert len(got["exchange_ms_per_round"]) == 2
    assert all(ms > 0 for ms in got["exchange_ms_per_round"])


def _threads():
    return {t.name for t in threading.enumerate()}


def _threads_settle(before, timeout_s=5.0):
    """The live threads once the run's own have ended (the black box's
    watcher parks within its poll interval)."""
    deadline = time.monotonic() + timeout_s
    while _threads() != before and time.monotonic() < deadline:
        time.sleep(0.05)
    return _threads()


@pytest.mark.parametrize("case", ["obs-env", "obs-arg"])
def test_the_obs_plane_journals_every_rank(case, monkeypatch, tmp_path):
    """The obs plane, by environment knob (through ``run()``) or by the
    trainer's ``obs`` argument, wraps every rank: each writes its journal
    with wire, span and dynamics records, the stats carry the per-(peer,
    tag) counters, and no thread of the run outlives it."""
    from mpit_tpu_torch.obs import ObsConfig

    before = _threads()
    if case == "obs-env":
        monkeypatch.setenv("MPIT_OBS_DIR", str(tmp_path))
        res = port_run.run(_ps_cfg(TrainConfig), device=CPU)
        assert res["server_counts"][0]["push_easgd"] == 2 * (16 // 4)
    else:
        x, y, _, _ = mnist()
        trainer = AsyncPSTrainer(MLP(device=CPU), SGD(0.1), transport="inproc",
                                 tau=4, device=CPU, obs=ObsConfig(dir=str(tmp_path)))
        _, stats = trainer.train(x[:512], y[:512], steps=8, batch_size=32)
        tel = stats["telemetry"]
        assert [t["rank"] for t in tel] == [0, 1, 2]
        # each client fetched 3 times (the initial pull and 2 rounds) and
        # pushed twice; the server answered every fetch
        for c in (1, 2):
            assert tel[c]["send"]["0:2"]["msgs"] == 2  # TAG_PUSH_EASGD
            assert tel[c]["send"]["0:1"]["msgs"] == 3  # TAG_FETCH
        assert sum(v["msgs"] for k, v in tel[0]["send"].items()) == 6
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".jsonl")) == [
        "obs_rank0.jsonl", "obs_rank1.jsonl", "obs_rank2.jsonl"]
    for r in range(3):
        evs = {json.loads(line)["ev"] for line in open(tmp_path / f"obs_rank{r}.jsonl")}
        want = {"send", "recv"} | ({"push_stale", "param_version"} if r == 0
                                   else {"span_b", "span_e", "dynamics"})
        assert want <= evs, (r, evs)
    assert sorted(os.listdir(tmp_path / "blackbox")) == [f"rank_{r}.jsonl" for r in range(3)]
    assert _threads_settle(before) == before


def test_run_refuses_ps_off_mnist_and_keeps_checkpoints_for_a5b(tmp_path):
    """``ps-*`` off MNIST runs since A8, as the reference's ``_run_async_ps``
    takes any model (here a 1-layer transformer on PTB windows). Since A5b
    ``ckpt_dir`` checkpoints the PS run as the reference's does: every
    server persists its center chunk, the final center goes to a
    ``ps_center`` checkpoint that loads into the model's tree, and a run
    with ``resume`` restores the chunks (``center_restored``) and trains
    with the same counts."""
    res = port_run.run(dataclasses.replace(
        TrainConfig().apply_preset("ptb-transformer-large"), algo="ps-easgd",
        layers=1, d_model=16, heads=2, seq_len=16, train_size=64, steps=4,
        global_batch=8, tau=2, optimizer="sgd", lr=0.1, lr_schedule="constant",
        transport="inproc"), device=CPU)
    assert res["server_counts"][0]["push_easgd"] == 2 * (4 // 2)
    assert all(len(l) == 4 and np.isfinite(l).all() for l in res["client_losses"])

    from mpit_tpu_torch.utils.checkpoint import restore_checkpoint

    cfg = _ps_cfg(TrainConfig, model="mlp", ckpt_dir=str(tmp_path))
    first = port_run.run(cfg, device=CPU)
    again = port_run.run(dataclasses.replace(cfg, resume=True), device=CPU)
    assert (first["center_restored"], again["center_restored"]) == (False, True)
    for r in (first, again):
        assert r["last_checkpoint"] == 16 and r["dead_clients"] == []
        assert r["server_counts"][0]["push_easgd"] == 2 * (16 // 4)
    meta = json.load(open(tmp_path / "ckpt_00000016.json"))
    assert meta["kind"] == "ps_center" and meta["step"] == 16
    template = MLP(device=CPU).init(torch.Generator().manual_seed(0))
    center, step = restore_checkpoint(str(tmp_path), template)
    assert step == 16
    assert not torch.equal(center["Dense_0"]["kernel"], template["Dense_0"]["kernel"])


# ------------------------------------------------------------------ C4


def _c4_cfgs(config):
    return {
        "grad_accum": dataclasses.replace(config().apply_preset("mnist-easgd"),
                                          grad_accum=2),
        "exchange_dtype": dataclasses.replace(config().apply_preset("mnist-easgd"),
                                              algo="sync", exchange_dtype="bf16"),
        "moe_experts": dataclasses.replace(config().apply_preset("mnist-easgd"),
                                           moe_experts=4),
        "seq_impl": dataclasses.replace(config().apply_preset("mnist-easgd"),
                                        seq_impl="ulysses"),
    }


@pytest.mark.parametrize("case", ["grad_accum", "exchange_dtype", "moe_experts",
                                  "seq_impl"])
def test_flags_that_do_not_apply_warn_in_both_packages(case, topo8):
    """ROADMAP.md C4: the port warns where the reference warns, with its
    wording."""
    ref_cfg, cfg = _c4_cfgs(RefConfig)[case], _c4_cfgs(TrainConfig)[case]
    with pytest.warns(UserWarning, match=case) as ref_warned:
        if case in ("moe_experts", "seq_impl"):
            ref_run._build_model(ref_cfg, {})
        else:
            ref_run.build_trainer(ref_cfg, ref_run._build_model(ref_cfg, {}),
                                  optax.sgd(0.05), topo8)
    with pytest.warns(UserWarning, match=case) as port_warned:
        model = port_run.build_model(cfg, CPU)
        if case not in ("moe_experts", "seq_impl"):
            port_run.build_trainer(cfg, model, SGD(0.05), Topology(8, torch.device(CPU)))
    assert [str(w.message) for w in port_warned] == [str(w.message) for w in ref_warned]


# ------------------------------------------------- transports in thread mode


@pytest.mark.parametrize("transport,used", [("auto", "native"), ("native", "native"),
                                            ("inproc", "inproc"), ("socket", "socket")])
def test_run_mnist_ps_trains_over_every_transport(transport, used):
    """``run()`` on mnist-ps (the MLP, 8 steps) over each message plane:
    ``auto`` takes the C++ broker where it builds, as the reference's does,
    and every plane gives the reference's counts."""
    cfg = dataclasses.replace(_ps_cfg(TrainConfig), model="mlp", steps=8,
                              train_size=1024, transport=transport)
    got = port_run.run(cfg, device=CPU)
    assert got["transport_used"] == used
    assert got["server_counts"][0]["push_easgd"] == 2 * (8 // 4)
    assert got["server_counts"][0]["fetch"] == 2 * (8 // 4 + 1)
    assert got["dead_clients"] == [] and np.isfinite(got["final_loss"])


# --------------------------------------------------------- shard snapshot


@pytest.mark.parametrize("sharded", [False, True], ids=["flat", "sharded"])
def test_shard_snapshot_is_flax_msgpack_byte_for_byte(sharded, tmp_path):
    """The scripted server (every envelope, a duplicate, a join, a leave,
    in sharded mode a handoff) persists its full shard snapshot at its
    clean stop: the port's file equals the reference's byte for byte, and
    both equal ``flax.serialization.msgpack_serialize`` of the state."""
    from flax import serialization

    from mpit_tpu.utils import checkpoint as ref_ckpt
    from mpit_tpu_torch.utils import checkpoint as port_ckpt

    script = _sharded_script if sharded else _flat_script
    ref_path, port_path = tmp_path / "ref.msgpack", tmp_path / "port.msgpack"
    _serve_script(REF, script, sharded, ckpt_path=str(ref_path))
    _serve_script(PORT, script, sharded, ckpt_path=str(port_path))
    got, want = port_path.read_bytes(), ref_path.read_bytes()
    assert got == want
    state = ref_ckpt.load_shard_state(str(ref_path))
    assert set(state) == {"center", "version", "gen", "dedup", "membership", "shards", "ring"}
    assert (state["shards"] is None) is (not sharded)
    assert serialization.msgpack_serialize(state) == got
    assert port_ckpt.msgpack_serialize(state) == got


def _same_tree(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and list(a) == list(b) and all(
            _same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return isinstance(b, list) and len(a) == len(b) and all(
            _same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return type(a) is type(b) and a == b


def test_each_package_loads_the_others_shard_snapshot(tmp_path):
    from mpit_tpu.utils import checkpoint as ref_ckpt
    from mpit_tpu_torch.utils import checkpoint as port_ckpt

    state = {"center": _vec(3), "version": 7, "gen": 2, "ring": [3, [0, 1]],
             "shards": [[0, 0, 18, 4], [2, 30, 37, 1]],
             "dedup": [[1, 2**64 - 5, 9, [7, 8, 9]], [2, 123, 0, []]],
             "membership": {"min_quorum": None, "expected": [1, 2], "dead": [],
                            "stopped": [2], "left": [], "epochs": [[1, 2**63 + 1]],
                            "view_epoch": 3}}
    ref_ckpt.save_shard_state(str(tmp_path / "ref.msgpack"), state)
    port_ckpt.save_shard_state(str(tmp_path / "port.msgpack"), state)
    for path in ("ref.msgpack", "port.msgpack"):
        got = port_ckpt.load_shard_state(str(tmp_path / path))
        want = ref_ckpt.load_shard_state(str(tmp_path / path))
        assert _same_tree(got, want)
    assert _same_tree(port_ckpt.load_shard_state(str(tmp_path / "ref.msgpack")),
                      ref_ckpt.load_shard_state(str(tmp_path / "port.msgpack")))


_PKGS = {"ref": (ref_pserver, ref_pclient, RefBroker),
         "port": (port_pserver, port_pclient, PortBroker)}


def _snapshot_world(pkg, path):
    pserver, _, broker = _PKGS[pkg]
    tps = broker(2).transports()
    server = pserver.PServer(tps[0], np.zeros(DIM, np.float32), num_clients=1, alpha=0.5,
                             client_ranks=[1], ckpt_path=path, ckpt_every=1)
    return tps, server, pserver.spawn_server_thread(server)


@pytest.mark.parametrize("killed,restored", [("ref", "port"), ("port", "ref"),
                                             ("port", "port")])
def test_kill_and_restore_keeps_exactly_once(killed, restored, tmp_path):
    """The reference's check (tests/test_elastic.py:205) across the
    packages: a server of one package is "killed" after two pushes, a
    server of the other restores its snapshot; the version continues, the
    generation bumps, the center is the one persisted, and a replayed
    pre-kill push is dropped as a duplicate."""
    import shutil
    import time

    path, frozen = str(tmp_path / "shard_0.msgpack"), str(tmp_path / "killed.msgpack")
    tps, server, thread = _snapshot_world(killed, path)
    client = _PKGS[killed][1].PClient(tps[1], [0], DIM)
    client.join()
    client.push_easgd(np.ones(DIM, np.float32))
    client.push_easgd(np.full(DIM, 2.0, np.float32))
    deadline = time.monotonic() + 5
    while server.version < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert server.version == 2
    want_center = server.snapshot()
    shutil.copy(path, frozen)  # the snapshot as a preempted server left it
    client.stop()
    thread.join(timeout=5)
    assert not thread.is_alive() and server.error is None

    tps2, revived, thread2 = _snapshot_world(restored, frozen)
    assert revived.restored and revived.version == 2 and revived.gen == 1
    np.testing.assert_array_equal(revived.snapshot(), want_center)
    tps2[1].send(0, port_pserver.TAG_PUSH_EASGD,
                 (client._epoch, 2, np.full(DIM, 2.0, np.float32)))
    tps2[1].send(0, port_pserver.TAG_STOP, None)
    thread2.join(timeout=5)
    assert not thread2.is_alive() and revived.error is None
    assert revived.counts["dup_dropped"] == 1 and revived.counts["push_easgd"] == 0
    assert revived.version == 2
    np.testing.assert_array_equal(revived.snapshot(), want_center)


def test_oversized_arrays_are_chunked_as_flax_chunks_them(monkeypatch, tmp_path):
    """flax writes an array above its chunk limit as a dict of flat pieces;
    with the limit cut to 64 bytes in both, a snapshot's center is chunked
    to the same bytes, and each package restores the other's."""
    from flax import serialization

    from mpit_tpu_torch.utils import checkpoint as port_ckpt

    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(port_ckpt, "_MAX_CHUNK_SIZE", 64)
    state = {"center": _vec(5, 50), "version": 3, "nested": {"big": _vec(6, 20)},
             "rows": [_vec(7, 40)]}
    got = port_ckpt.msgpack_serialize(state)
    assert got == serialization.msgpack_serialize(state)
    assert b"__msgpack_chunked_array__" in got
    assert _same_tree(port_ckpt.msgpack_restore(got), serialization.msgpack_restore(got))
    assert port_ckpt.msgpack_restore(got)["center"].tobytes() == state["center"].tobytes()
