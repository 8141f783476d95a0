"""The port's serving fleet against the reference's, on the CPU.

The reference's own fleet cases (``tests/test_fleet.py``) run again on the
port's objects: the dispatch policies, the in-process fleet (all-finish,
seeded replay, the kill leg, rolling refreshes, the controller's spare),
admission shedding, the controller core and pooled latencies. Then the
two packages side by side: ``choose_replica`` and ``decide`` over grids of
inputs, both ``FleetHarness`` runs on all-at-once arrivals (the same
routes, the same tokens; the port's weights from ``convert.from_flax``),
weight pushes (names, arrays and frames byte for byte, and a reference
push installed into a port replica), and the audit of one journal. The
CLI runs once as processes with a kill, and the reference's protocol
extractor and model checker read the port's fleet.
"""

import dataclasses
import glob
import itertools
import json
import os
import random
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpit_tpu import fleet as jfleet
from mpit_tpu.fleet import weights as jweights
from mpit_tpu.loadgen import Request as JaxRequest
from mpit_tpu.models import Server as JaxServer
from mpit_tpu.models.transformer import TransformerLM as JaxLM
from mpit_tpu.transport import wire as jwire
from mpit_tpu_torch.convert import from_flax
from mpit_tpu_torch.fleet import (
    TAG_FLEET_STOP,
    TAG_REPLY,
    TAG_ROUTE,
    TAG_WEIGHT_PUSH,
    TAG_WEIGHT_SUB,
    FleetHarness,
    ReplicaServer,
    Router,
    StaticWeightSource,
    WeightPublisher,
    audit_lifecycle,
    choose_replica,
    decide,
    flatten_named,
    format_audit,
    unflatten_like,
)
from mpit_tpu_torch.loadgen import Request, ServeChaos, pooled_latencies
from mpit_tpu_torch.models import Server, generate_fast
from mpit_tpu_torch.models.transformer import TransformerLM
from mpit_tpu_torch.transport import wire
from mpit_tpu_torch.transport.inproc import Broker
from mpit_tpu_torch.utils.params import tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, T = 17, 64
CLI_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs several
    test processes at once, and small CPU ops oversubscribed across all of
    them run many times slower. Restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lm():
    """The reference's fleet model (tests/test_fleet.py ``_model_params``)
    and the port's, holding the same weights."""
    jm = JaxLM(vocab_size=V, num_layers=2, d_model=32, num_heads=4, max_len=T,
               compute_dtype=jnp.float32)
    params = jm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]
    pm = TransformerLM(V, num_layers=2, d_model=32, num_heads=4, max_len=T,
                       compute_dtype=torch.float32, device="cpu")
    return jm, params, pm, from_flax(jax.tree.map(np.asarray, params), device="cpu")


def _journals(d):
    return sorted(glob.glob(os.path.join(str(d), "obs_rank*.jsonl")))


def _immediate_requests(n, seed=0, max_new=(3, 7), cls=Request):
    """All-at-once arrivals (the reference's helper): the router submits
    every request in its first loop iteration, which makes routing
    decisions a pure function of (policy, seed)."""
    rng = random.Random(seed)
    lo, hi = max_new
    return [
        cls(arrival_s=0.0,
            prompt=tuple(rng.randrange(1, V) for _ in range(rng.randrange(1, 7))),
            max_new=rng.randrange(lo, hi), slo_ms=60_000.0)
        for _ in range(n)
    ]


def _factory(model, params, out=None):
    from mpit_tpu_torch.obs.core import ObsConfig

    def factory(rank):
        obs = (ObsConfig(dir=os.path.join(str(out), f"rep{rank}"))
               if out is not None else None)
        return Server(model, params, max_batch=2, segment=4, obs=obs, device="cpu")

    return factory


def _routes(obs_dir):
    """[(rid, replica), ...] in journal order — the routing decisions."""
    out = []
    for path in _journals(obs_dir):
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("ev") == "req_route":
                    out.append((rec["rid"], rec["replica"]))
    return out


def _bump(params, v):
    return tree_map(lambda a: a + 1e-3 * v, params)


# ------------------------------------------------------ dispatch policies


class TestChooseReplica:
    def test_least_loaded_ties_by_rank(self):
        assert choose_replica("least", 0, 0, {3: 1, 1: 2, 2: 1}) == 2
        assert choose_replica("least", 0, 0, {3: 0, 1: 0, 2: 0}) == 1
        assert choose_replica("least", 9, 5, {3: 1, 1: 2, 2: 1}) == 2

    def test_p2c_deterministic_and_seeded(self):
        loads = {1: 0, 2: 0, 3: 0}
        a = [choose_replica("p2c", 7, rid, loads) for rid in range(64)]
        b = [choose_replica("p2c", 7, rid, loads) for rid in range(64)]
        assert a == b
        c = [choose_replica("p2c", 8, rid, loads) for rid in range(64)]
        assert a != c
        assert set(a) == {1, 2, 3}

    def test_p2c_prefers_less_loaded_candidate(self):
        picks = [choose_replica("p2c", 3, rid, {1: 0, 2: 100}) for rid in range(200)]
        assert picks.count(2) < picks.count(1)
        assert picks.count(2) == sum(
            1 for rid in range(200)
            if choose_replica("p2c", 3, rid, {1: 0, 2: 0, 3: 0}) is not None
            and picks[rid] == 2
        )

    def test_rejects_unknown_policy_and_empty_loads(self):
        with pytest.raises(ValueError, match="policy"):
            choose_replica("random", 0, 0, {1: 0})
        with pytest.raises(ValueError, match="alive"):
            choose_replica("p2c", 0, 0, {})


LOADS = [{1: 0, 2: 0, 3: 0}, {3: 1, 1: 2, 2: 1}, {1: 5, 3: 5}, {1: 0, 2: 100},
         {4: 1, 2: 1, 7: 0}, {1: 3}, {2: 0.5, 5: 0.25, 9: 0.5}]


@pytest.mark.parametrize("policy", ["least", "p2c"])
@pytest.mark.parametrize("seed", [0, 1, 7, 2**40 + 3])
def test_choose_replica_equals_reference(policy, seed):
    for loads, rid in itertools.product(LOADS, range(48)):
        assert choose_replica(policy, seed, rid, loads) == jfleet.choose_replica(
            policy, seed, rid, loads), (loads, rid)


# ----------------------------------------------------- the fleet harness


class TestFleetRuns:
    def test_all_finish_and_audit_ok(self, lm, tmp_path):
        _, _, model, params = lm
        rep = FleetHarness(_factory(model, params), _immediate_requests(9),
                           n_replicas=3, seed=0, obs_dir=str(tmp_path)).run()
        assert len(rep.results) == 9 and rep.shed == 0
        audit = audit_lifecycle([str(tmp_path)])
        assert audit["ok"], audit
        assert audit["admitted"] == audit["finished"] == 9
        assert audit["lost"] == [] and audit["unrouted"] == []
        for res in rep.results.values():
            assert res["replica"] in (1, 2, 3)
            assert res["serving_weights_version"] == 0

    def test_same_seed_routes_identically(self, lm, tmp_path):
        _, _, model, params = lm
        dirs = []
        for leg in ("a", "b"):
            out = tmp_path / leg
            rep = FleetHarness(_factory(model, params), _immediate_requests(8),
                               n_replicas=3, policy="p2c", seed=5,
                               obs_dir=str(out)).run()
            assert len(rep.results) == 8
            dirs.append(out)
        ra, rb = _routes(dirs[0]), _routes(dirs[1])
        assert ra == rb and len(ra) == 8

    def test_kill_redispatches_orphans_zero_lost(self, lm, tmp_path):
        _, _, model, params = lm
        reqs = _immediate_requests(12)
        rep = FleetHarness(_factory(model, params), reqs, n_replicas=3, seed=1,
                           obs_dir=str(tmp_path), chaos=ServeChaos(seed=1, kill_after=1),
                           kill_rank=1).run()
        assert rep.killed_ranks == [1]
        assert rep.redispatched > 0
        assert len(rep.results) == 12
        audit = audit_lifecycle([str(tmp_path)])
        assert audit["ok"], audit
        assert audit["lost"] == []
        assert audit["dead_replicas"] == [1]
        assert audit["redispatched"] == rep.redispatched
        assert 1 not in audit["replicas_finished"] or (
            audit["replicas_finished"][1] + rep.redispatched >= 1)
        # a redispatched request's tokens are its solo call's
        for r in reqs:
            assert rep.results[r.rid]["tokens"] == generate_fast(
                model, params, list(r.prompt), r.max_new, device="cpu")

    def test_rolling_refresh_versions_monotonic(self, lm, tmp_path):
        _, _, model, params = lm
        source = StaticWeightSource(params, version=1)
        rep = FleetHarness(_factory(model, params), _immediate_requests(10),
                           n_replicas=2, seed=2, obs_dir=str(tmp_path), source=source,
                           refresh_boundaries=(1,),
                           refresh_params_fn=lambda v: _bump(params, v)).run()
        assert len(rep.results) == 10
        assert source.version == 2
        assert rep.weights_pushed == {1: 2, 2: 2}
        audit = audit_lifecycle([str(tmp_path)])
        assert audit["ok"] and audit["versions_monotonic"], audit
        versions = [res["serving_weights_version"] for res in rep.results.values()]
        assert set(versions) <= {0, 1, 2}

    def test_refresh_before_route_serves_new_version(self, lm, tmp_path):
        _, _, model, params = lm
        transports = Broker(2).transports()
        rep = ReplicaServer(_factory(model, params)(1), transports[1], router_rank=0)
        t = threading.Thread(target=rep.run, daemon=True)
        t.start()
        router = Router(transports[0], [1], obs_dir=str(tmp_path))
        source = StaticWeightSource(params, version=1)
        publisher = WeightPublisher(transports[0], source)
        source.bump(_bump(params, 1))
        publisher.publish_to(1)
        rid = router.submit([1, 2, 3], 3)
        assert router.poll(timeout=60.0) == rid
        assert router.results[rid]["serving_weights_version"] == 2
        router.stop()
        t.join(timeout=30.0)
        assert not t.is_alive()
        router.close()

    def test_controller_spawns_spare_not_dead_rank(self, lm, tmp_path):
        _, _, model, params = lm
        rep = FleetHarness(_factory(model, params), _immediate_requests(12),
                           n_replicas=3, spares=1, seed=3, obs_dir=str(tmp_path),
                           chaos=ServeChaos(seed=3, kill_after=1), kill_rank=1,
                           use_controller=True).run()
        assert rep.killed_ranks == [1]
        assert rep.spawned_ranks == [4]
        acts = [(a.kind, a.rank, a.reason) for a in rep.controller_log]
        assert ("retire", 1, "dead_rank") in acts
        assert ("spawn", 4, "dead_rank") in acts
        assert len(rep.results) == 12
        assert audit_lifecycle([str(tmp_path)])["ok"]


@pytest.mark.parametrize("policy", ["p2c", "least"])
def test_fleet_routes_and_tokens_equal_reference(lm, policy, tmp_path):
    """All-at-once arrivals, the same seed: both packages' harnesses route
    every request to the same replica, and each reply's tokens are equal
    (the port's weights are the reference's, through ``from_flax``)."""
    jm, jp, model, params = lm

    def jax_factory(rank):
        return JaxServer(jm, jp, max_batch=2, segment=4)

    jreqs = _immediate_requests(10, seed=6, cls=JaxRequest)
    preqs = _immediate_requests(10, seed=6)
    want = jfleet.FleetHarness(jax_factory, jreqs, n_replicas=3, policy=policy, seed=4,
                               obs_dir=str(tmp_path / "jax")).run()
    got = FleetHarness(_factory(model, params), preqs, n_replicas=3, policy=policy,
                       seed=4, obs_dir=str(tmp_path / "port")).run()
    routes = _routes(tmp_path / "port")
    assert routes == _routes(tmp_path / "jax") and len(routes) == 10
    assert len({r for _, r in routes}) > 1
    assert {rid: res["tokens"] for rid, res in got.results.items()} == {
        rid: res["tokens"] for rid, res in want.results.items()}
    assert {rid: res["replica"] for rid, res in got.results.items()} == {
        rid: res["replica"] for rid, res in want.results.items()}


# ---------------------------------------------------- admission shedding


def test_shed_at_admission_is_refusal_not_loss(tmp_path):
    transports = Broker(2).transports()
    router = Router(transports[0], [1], max_outstanding=1, obs_dir=str(tmp_path))
    assert router.submit([1, 2], 3) == 0
    assert router.submit([3], 2) is None
    assert router.shed == 1 and router.outstanding == 1
    router.close()
    audit = audit_lifecycle([str(tmp_path)])
    assert audit["shed"] == 1 and audit["admitted"] == 1
    assert audit["lost"] == [0] and not audit["ok"]


# ------------------------------------------------------- controller core


class TestDecide:
    def test_dead_rank_retires_and_spawns_avoiding_dead(self):
        acts = decide([{"kind": "dead_rank", "rank": 1}], alive={1, 2, 3},
                      all_ranks=[1, 2, 3, 4], max_replicas=3)
        assert [(a.kind, a.rank) for a in acts] == [("retire", 1), ("spawn", 4)]
        acts = decide([{"kind": "dead_rank", "rank": 1}], alive={1, 2, 3},
                      all_ranks=[1, 2, 3], max_replicas=3)
        assert [(a.kind, a.rank) for a in acts] == [("retire", 1)]

    def test_slo_burn_spawns_then_sheds_at_capacity(self):
        burn = [{"kind": "slo_burn", "rank": -1}]
        acts = decide(burn, alive={1, 2}, all_ranks=[1, 2, 3], max_replicas=3)
        assert [(a.kind, a.rank) for a in acts] == [("spawn", 3)]
        acts = decide(burn, alive={1, 2, 3}, all_ranks=[1, 2, 3], max_replicas=3)
        assert [a.kind for a in acts] == ["shed"]

    def test_straggler_sheds_only_when_sole_replica(self):
        strag = [{"kind": "straggler", "rank": 1}]
        assert decide(strag, alive={1, 2}, all_ranks=[1, 2], max_replicas=2) == []
        acts = decide(strag, alive={1}, all_ranks=[1], max_replicas=1)
        assert [a.kind for a in acts] == ["shed"]

    def test_idle_unshed(self):
        acts = decide([], alive={1}, all_ranks=[1], max_replicas=1, outstanding=1,
                      max_outstanding=8)
        assert [a.kind for a in acts] == ["unshed"]
        assert decide([], alive={1}, all_ranks=[1], max_replicas=1, outstanding=7,
                      max_outstanding=8) == []

    def test_pure(self):
        args = ([{"kind": "dead_rank", "rank": 2}], {1, 2}, [1, 2, 3], 2)
        assert decide(*args) == decide(*args)


ALERTS = [
    [],
    [{"kind": "dead_rank", "rank": 1}],
    [{"kind": "dead_rank", "rank": 2}, {"kind": "slo_burn", "rank": -1}],
    [{"kind": "slo_burn", "rank": -1}, {"kind": "slo_burn", "rank": -1}],
    [{"kind": "straggler", "rank": 1}],
    [{"kind": "dead_rank", "rank": 9}, {"kind": "straggler", "rank": 2}],
]


@pytest.mark.parametrize("alerts", range(len(ALERTS)))
def test_decide_equals_reference(alerts):
    grid = itertools.product(
        [{1}, {1, 2}, {1, 2, 3}], [[1, 2, 3], [1, 2, 3, 4, 5]], [1, 3, 4],
        [(0, 0), (1, 8), (7, 8), (3, 0)], [(), (4,), (1, 5)])
    for alive, pool, cap, (outstanding, max_out), dead in grid:
        kw = dict(outstanding=outstanding, max_outstanding=max_out, dead=dead)
        got = decide(ALERTS[alerts], alive, pool, cap, **kw)
        want = jfleet.decide(ALERTS[alerts], alive, pool, cap, **kw)
        assert [(a.kind, a.rank, a.reason) for a in got] == [
            (a.kind, a.rank, a.reason) for a in want], (alive, pool, cap, kw)


# ------------------------------------------------------------- weights


def test_flatten_named_equals_reference(lm):
    _, jp, _, params = lm
    names, arrays = flatten_named(params)
    jnames, jarrays = jweights.flatten_named(jp)
    assert names == jnames and len(names) == 24
    for a, b in zip(arrays, jarrays):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    rebuilt = unflatten_like(params, names, arrays)
    assert tree_map(lambda a: a.shape, rebuilt) == tree_map(lambda a: a.shape, params)
    assert all(torch.equal(a, b) for a, b in zip(
        jax.tree.leaves(rebuilt), jax.tree.leaves(params)))
    with pytest.raises(ValueError, match="do not match this replica's model"):
        unflatten_like(params, names[::-1], arrays[::-1])


def _frame_bytes(encode_frame, version, payload):
    return b"".join(bytes(b) for b in encode_frame(0, TAG_WEIGHT_PUSH, payload,
                                                   version=version))


def _decode(data: bytes):
    version, flags, hlen, hcrc = wire.split_preamble(data[:wire.PREAMBLE_SIZE])
    header = data[wire.PREAMBLE_SIZE:wire.PREAMBLE_SIZE + hlen]
    return wire.decode_frame(flags, hcrc, header, data[wire.PREAMBLE_SIZE + hlen:])


@pytest.mark.parametrize("quant", ["off", "bf16", "int8"])
def test_push_frames_equal_reference_and_install(lm, quant):
    """A push of the same weights is the same frame byte for byte through
    either package's encoder, and a reference push, decoded by the port's
    wire, installs into a port replica's ``Server``."""
    _, jp, model, params = lm
    src = _bump(params, 3)
    jsrc = jax.tree.map(lambda a: a + 1e-3 * 3, jp)
    payload = (2, *WeightPublisher(None, StaticWeightSource(src), quant)._encode(src))
    jpayload = (2, *jfleet.WeightPublisher(None, jfleet.StaticWeightSource(jsrc),
                                           quant)._encode(jsrc))
    data = _frame_bytes(wire.encode_frame, wire.WIRE_FORMAT_VERSION, payload)
    jdata = _frame_bytes(jwire.encode_frame, jwire.WIRE_FORMAT_VERSION, jpayload)
    assert data == jdata
    src_rank, tag, (version, names, arrays) = _decode(jdata)
    assert (src_rank, tag, version) == (0, TAG_WEIGHT_PUSH, 2)
    rep = ReplicaServer(Server(model, params, max_batch=2, segment=4, device="cpu"),
                        Broker(2).transports()[1])
    rep._install(version, names, arrays)
    assert rep.server.weights_version == 2
    want = jweights.unflatten_like(jp, *jpayload[1:])
    for got, ref in zip(flatten_named(rep.server.params)[1], jax.tree.leaves(want)):
        assert got.tobytes() == np.asarray(ref, np.float32).tobytes()
    rep._install(1, names, arrays)  # stale: ignored
    assert rep.server.weights_version == 2


# ------------------------------------------------------------- the audit


def _fixture_journal(path):
    recs = []
    for rid in range(6):
        recs.append({"ev": "req_enqueue", "rid": rid, "t": rid})
        recs.append({"ev": "req_route", "rid": rid, "replica": 1 + rid % 3})
    recs.append({"ev": "req_shed", "outstanding": 6})
    recs.append({"ev": "req_redispatch", "rid": 1, "replica": 3, "from_replica": 2})
    recs.append({"ev": "req_redispatch", "rid": 4, "replica": 1, "from_replica": 2})
    for rid, rep, ver in ((0, 1, 1), (1, 3, 1), (2, 3, 2), (3, 1, 2), (4, 1, 1)):
        recs.append({"ev": "req_finish", "rid": rid, "replica": rep,
                     "serving_weights_version": ver, "gen": 3, "reason": "fleet"})
    recs.append({"ev": "req_enqueue", "rid": 9})
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r) + "\n")


def test_audit_equals_reference(tmp_path):
    _fixture_journal(tmp_path / "obs_rank0.jsonl")
    got = audit_lifecycle([str(tmp_path)])
    assert got == jfleet.audit_lifecycle([str(tmp_path)])
    assert got["lost"] == [5] and got["unrouted"] == [9] and not got["ok"]
    assert got["dead_replicas"] == [2] and not got["versions_monotonic"]
    assert format_audit(got) == jfleet.format_audit(got)


# ------------------------------------------- pooled replica-side latency


def test_pooled_latencies_keeps_colliding_rids_apart(tmp_path):
    for rep, (t0, t1) in (("a", (1.0, 1.5)), ("b", (2.0, 2.25))):
        d = tmp_path / rep
        d.mkdir()
        (d / "obs_rank0.jsonl").write_text(
            json.dumps({"ev": "req_enqueue", "rid": 0, "t": t0}) + "\n"
            + json.dumps({"ev": "req_first_token", "rid": 0, "t": t1}) + "\n")
    lat = pooled_latencies([_journals(tmp_path / "a"), _journals(tmp_path / "b")],
                           names=("ttft",))
    assert lat["ttft"]["count"] == 2
    assert 200 <= lat["ttft"]["p50_ms"] <= 300
    assert 450 <= lat["ttft"]["p99_ms"] <= 600


# ---------------------------------------------------- the CLI, as processes


def test_importing_the_fleet_loads_no_jax():
    code = ("import sys, mpit_tpu_torch.fleet, mpit_tpu_torch.fleet.__main__\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'mpit_tpu'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_cli_process_fleet_survives_a_kill(tmp_path):
    """``run --procs --device cpu``: three replica processes over the
    socket transport, all requests arriving at once, rank 1 SIGKILLed at
    the first boundary; its orphans are redispatched and nothing is lost."""
    out = str(tmp_path / "fleet")
    env = {k: v for k, v in os.environ.items() if not k.startswith("MPIT_")}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "mpit_tpu_torch.fleet", "run", "--procs", "--device",
         "cpu", "--out", out, "--requests", "12", "--rate", "1e6", "--kill-after", "1",
         "--kill-rank", "1"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    assert r.returncode == 0, r.stderr[-3000:]
    report = json.loads(r.stdout.strip().splitlines()[-1])
    assert report["fleet"]["ok"] and report["fleet"]["lost"] == []
    assert report["fleet"]["dead_replicas"] == [1] and report["fleet"]["redispatched"] > 0
    assert report["client"]["killed_ranks"] == [1]
    summaries = []
    for rank in (2, 3):
        with open(os.path.join(out, f"rep{rank}.out")) as f:
            summaries.append(json.loads(f.read().strip().splitlines()[-1]))
    assert [s["rank"] for s in summaries] == [2, 3]
    assert all(s["device"] == "cpu" and not s["killed"] for s in summaries)
    assert len({s["pid"] for s in summaries}) == 2
    with open(os.path.join(out, "rep1.out")) as f:
        assert f.read() == ""  # SIGKILLed: no summary
    a = subprocess.run([sys.executable, "-m", "mpit_tpu_torch.fleet", "audit", out,
                        "--json"],
                       cwd=REPO, env=env, capture_output=True, text=True, timeout=60)
    assert a.returncode == 0, a.stdout
    audit = json.loads(a.stdout)
    assert audit["ok"] and audit["finished"] == 12
    # the survivors' replies are the finishes credited to them; rank 1 may
    # have answered one before the kill landed (a send to a rank that is
    # still starting waits for it)
    assert [audit["replicas_finished"].get(str(r)) for r in (2, 3)] == [
        s["replies"] for s in summaries]


# ------------------------------------------------ fleet-route model check


def _analysis_project():
    from pathlib import Path

    from mpit_tpu.analysis import lint

    modules = []
    for ap, rel in lint.collect_files([Path(REPO) / "mpit_tpu_torch"]):
        ctx = lint.load_module(ap, rel)
        if ctx is not None:
            modules.append(ctx)
    return lint.Project(modules=modules, config=lint.Config())


@pytest.fixture(scope="module")
def fleet_sem():
    from mpit_tpu.analysis import protocol

    fsem = protocol.extract_fleet_semantics(_analysis_project())
    assert fsem is not None
    return fsem


def test_port_fleet_semantics_extracted_exactly(fleet_sem):
    assert fleet_sem.router_role == "serving_router"
    assert fleet_sem.replica_role == "serving_replica"
    assert fleet_sem.route_tag == TAG_ROUTE == jfleet.TAG_ROUTE
    assert fleet_sem.reply_tag == TAG_REPLY == jfleet.TAG_REPLY
    assert fleet_sem.stop_tag == TAG_FLEET_STOP == jfleet.TAG_FLEET_STOP
    assert (TAG_WEIGHT_SUB, TAG_WEIGHT_PUSH) == (jfleet.TAG_WEIGHT_SUB,
                                                 jfleet.TAG_WEIGHT_PUSH)
    assert fleet_sem.redispatch_on_death
    assert fleet_sem.reply_recv_timeout
    assert fleet_sem.route_send is not None
    assert fleet_sem.route_send.rel == "mpit_tpu_torch/fleet/router.py"


def test_port_fleet_model_is_clean(fleet_sem):
    from mpit_tpu.analysis import mcheck

    r = mcheck.check_fleet(mcheck.fleet_from_protocol(fleet_sem))
    assert r.ok, r.violations
    assert not r.truncated
    assert r.states > 100
    assert r.fault_points > 0


@pytest.mark.parametrize("mutation", [{"redispatch_on_death": False},
                                      {"reply_timeout": False}])
def test_port_fleet_mutations_witness_mpt019(fleet_sem, mutation):
    from mpit_tpu.analysis import mcheck

    bad = dataclasses.replace(mcheck.fleet_from_protocol(fleet_sem), **mutation)
    r = mcheck.check_fleet(bad, mcheck.fleet_config(quick=True))
    assert "MPT019" in r.violations, (mutation, r.violations)
    assert "lost" in r.violations["MPT019"]
