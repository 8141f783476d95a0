"""The port's obs plane against the reference's.

``mpit_tpu_torch/obs/`` is a copy of ``mpit_tpu/obs/`` over the port's
transports, so the same traffic gives the same journals record for record
(after removing the wall-clock fields ``ts``, ``t``, ``dur``, ``wait`` and
the random trace/span ids, whose links are held instead), the same
counters, and the same reader output on the repo's fixtures. The trainers
that arm it (the PS trainer, the bucketed sync step) give the reference's
records too, and each package's readers read the other's journals.
"""

import dataclasses
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpit_tpu.obs import __main__ as ref_cli
from mpit_tpu.obs import alerts as ref_alerts
from mpit_tpu.obs import blackbox as ref_blackbox
from mpit_tpu.obs import core as ref_core
from mpit_tpu.obs import dynamics as ref_dynamics
from mpit_tpu.obs import live as ref_live
from mpit_tpu.obs import merge as ref_merge
from mpit_tpu.obs import postmortem as ref_postmortem
from mpit_tpu.obs import telemetry as ref_telemetry
from mpit_tpu.transport import Broker as RefBroker
from mpit_tpu_torch.obs import __main__ as port_cli
from mpit_tpu_torch.obs import alerts as port_alerts
from mpit_tpu_torch.obs import blackbox as port_blackbox
from mpit_tpu_torch.obs import core as port_core
from mpit_tpu_torch.obs import dynamics as port_dynamics
from mpit_tpu_torch.obs import live as port_live
from mpit_tpu_torch.obs import merge as port_merge
from mpit_tpu_torch.obs import postmortem as port_postmortem
from mpit_tpu_torch.obs import telemetry as port_telemetry
from mpit_tpu_torch.transport import Broker as PortBroker

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CLOCK_FIELDS = ("ts", "t", "dur", "wait")
ID_FIELDS = ("trace", "span", "parent", "from_span")
CPU = "cpu"


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _canonical(recs):
    """The records without their wall-clock fields, each random id replaced
    by the order of its first appearance (so a recv's ``from_span`` still
    names its send's ``span``)."""
    ids: dict = {}
    out = []
    for r in recs:
        r = {k: v for k, v in r.items() if k not in CLOCK_FIELDS}
        for k in ID_FIELDS:
            if r.get(k) is not None:
                r[k] = ids.setdefault(r[k], len(ids))
        out.append(r)
    return out


def _strip_hist(summary):
    """``summary()`` without its latency histograms (wall-clock), which
    must still count every message."""
    out = json.loads(json.dumps(summary))
    for side in ("send", "recv"):
        for stream in out[side].values():
            hist = stream.pop("lat_hist_log2us", {})
            assert sum(hist.values()) == stream["msgs"]
    return out


# ---------------------------------------------------------------- traffic


def _traffic(tps, span, recv_timeout, payloads):
    """One fixed single-threaded exchange over a 3-rank world: plain and
    nonblocking sends, a traced region, tag-filtered and wildcard receives,
    replies parented by the message they answer, and a receive timeout."""
    a, b, c = tps
    for i, p in enumerate(payloads):
        a.send(1, 10 + i % 3, p)
    with span(a, "exchange", round=1):
        a.send(2, 7, payloads[0])
        a.isend(1, 7, None).wait()
    for i in range(len(payloads)):
        b.recv(0, 10 + i % 3)
    b.recv(0, 7)
    b.send(0, 8, (0, 1, payloads[1]))  # a reply in the requester's trace
    c.recv()
    a.recv(1, 8)
    with pytest.raises(recv_timeout):
        c.recv(0, 99, timeout=0.01)
    with span(c, "compute", steps=4):
        pass


def _payloads(seed, tensor):
    rng = np.random.default_rng(seed)
    arr = rng.standard_normal(33).astype(np.float32)
    codes = rng.integers(-127, 128, 17).astype(np.int8)
    return [
        torch.from_numpy(arr) if tensor else arr,
        (3, 1, codes),
        b"\x00" * 11,
        {"k": 1.5, "v": [1, 2]},
        None,
        "text",
        7,
    ]


@pytest.mark.parametrize("trace", [True, False], ids=["trace", "notrace"])
@pytest.mark.parametrize("sample", [1, 2])
def test_journals_equal_the_reference_record_for_record(trace, sample, tmp_path):
    """The same traffic through the reference's ``TelemetryTransport`` over
    its in-process broker and through the port's (which carries a torch
    tensor where the reference carries the same ndarray) writes the same
    journals, record for record, and the same ``summary()``."""
    from mpit_tpu.transport.base import RecvTimeout as RefTimeout
    from mpit_tpu_torch.transport.base import RecvTimeout as PortTimeout

    out = {}
    for name, broker, tel, core, timeout, tensor in (
        ("ref", RefBroker, ref_telemetry, ref_core, RefTimeout, False),
        ("port", PortBroker, port_telemetry, port_core, PortTimeout, True),
    ):
        d = tmp_path / name
        cfg = core.ObsConfig(dir=str(d), trace=trace, sample=sample)
        tps = tel.wrap_obs_transports(broker(3).transports(), cfg)
        _traffic(tps, core.span, timeout, _payloads(0, tensor))
        summaries = [_strip_hist(t.summary()) for t in tps]
        for t in tps:
            t.obs_tracer.close()
        out[name] = (summaries, [_records(d / f"obs_rank{r}.jsonl") for r in range(3)])
    (ref_sum, ref_j), (port_sum, port_j) = out["ref"], out["port"]
    assert port_sum == ref_sum
    assert [_canonical(j) for j in port_j] == [_canonical(j) for j in ref_j]
    # the links: each traced recv of tag 7 names the span of its send
    recvs = [r for j in port_j[1:] for r in j if r["ev"] == "recv" and r["mtag"] == 7]
    sends = {r["span"] for r in port_j[0] if r["ev"] in ("send", "isend") and "span" in r}
    assert len(recvs) == 2 and all((r.get("from_span") in sends) == trace for r in recvs)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros(33, dtype=torch.float32),
    lambda: torch.zeros((4, 5), dtype=torch.int8),
    lambda: torch.zeros(9, dtype=torch.bfloat16),
    lambda: torch.zeros(9, dtype=torch.uint16),
    lambda: (3, 1, torch.zeros(6, dtype=torch.int8)),
], ids=["f32", "int8", "bf16", "u16", "chunk-envelope"])
def test_payload_bytes_count_a_tensor_as_its_array(make):
    """``_approx_nbytes`` counts a torch tensor by its ``nbytes``, exactly
    as the reference counts the same-shaped ndarray."""
    obj = make()

    def as_np(o):
        if isinstance(o, tuple):
            return tuple(as_np(v) for v in o)
        if isinstance(o, torch.Tensor):
            return np.zeros(o.shape, {2: np.uint16, 1: np.int8, 4: np.float32}[o.element_size()])
        return o

    assert port_telemetry._approx_nbytes(obj) == ref_telemetry._approx_nbytes(as_np(obj)) > 0


# ---------------------------------------------------------------- disabled path


@pytest.mark.parametrize("transport", ["inproc", "native"])
def test_disabled_path_is_the_transport_itself_and_one_shared_noop(transport, monkeypatch):
    """With no config ``maybe_wrap`` returns the transport itself and
    ``span()`` the one shared no-op, as ``tests/test_obs.py``
    ``TestDisabledFastPath`` pins for the reference."""
    if transport == "native":
        from mpit_tpu_torch import native

        if not native.is_available():
            pytest.skip("the C++ broker does not build here")
        tp = native.NativeBroker(1).transports()[0]
    else:
        tp = PortBroker(1).transports()[0]
    for k in [k for k in os.environ if k.startswith("MPIT_OBS_")]:
        monkeypatch.delenv(k)
    assert port_telemetry.maybe_wrap(tp, None) is tp
    assert port_telemetry.wrap_from_env(tp) is tp
    s1, s2 = port_core.span(tp, "a", step=1), port_core.span(tp, "b")
    assert s1 is port_core.NULL_SPAN and s2 is port_core.NULL_SPAN
    with s1 as ctx:
        assert ctx is None
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with port_core.span(tp, "hot"):
            pass
    # the reference's generous ceiling for the disabled hook
    assert (time.perf_counter() - t0) / n < 25e-6


ENVS = [
    {},
    {"MPIT_OBS_DIR": "/x"},
    {"MPIT_OBS_TRACE": "0", "MPIT_OBS_SAMPLE": "4"},
    {"MPIT_OBS_DIR": "/x", "MPIT_OBS_LIVE": "1", "MPIT_OBS_LIVE_INTERVAL": "0.5"},
    {"MPIT_OBS_FAULTHANDLER": "1", "MPIT_OBS_RING": "1", "MPIT_OBS_MAX_RECORDS": "9"},
    {"MPIT_OBS_BLACKBOX": "0", "MPIT_OBS_FAULTHANDLER": "12.5"},
    {"MPIT_OBS_BLACKBOX_DUMP_SIGNAL": "USR1", "MPIT_OBS_BLACKBOX_SECONDS": "3"},
    {"MPIT_OBSX": "1", "MPIT_CHAOS_DROP": "0.1"},
]


@pytest.mark.parametrize("env", ENVS, ids=range(len(ENVS)))
def test_config_from_env_reads_the_knobs_as_the_reference(env):
    ref, port = ref_core.config_from_env(env), port_core.config_from_env(env)
    assert (port is None) == (ref is None)
    if ref is not None:
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)


# ---------------------------------------------------------------- journal, black box, live


@pytest.mark.parametrize("mode,cap", [("cap", None), ("cap", 5), ("ring", 5)])
def test_journal_caps_and_ring_equal_the_reference(mode, cap, tmp_path):
    """Cap and ring journals keep the same records and footers."""
    out = []
    for name, core in (("ref", ref_core), ("port", port_core)):
        path = str(tmp_path / f"{name}.jsonl")
        j = core.Journal(path, rank=3, max_records=cap, mode=mode)
        for i in range(12):
            j.event("span_b", i, name="compute", step=i, round=i // 3)
        j.close()
        out.append(_canonical(_records(path)))
    assert out[0] == out[1] and len(out[0]) == (12 if cap is None else cap + 1)


def test_blackbox_dumps_equal_the_reference(tmp_path):
    """The flight recorder's close dump and a dump request give the same
    segments in both packages."""
    out = []
    for name, core, bb in (("ref", ref_core, ref_blackbox), ("port", port_core, port_blackbox)):
        d = tmp_path / name
        box = bb.BlackBox(str(d), 1, max_records=6, max_seconds=60.0)
        j = core.Journal(str(d / "obs_rank1.jsonl"), 1, blackbox=box)
        for i in range(9):
            j.event("send", i, dst=0, mtag=2, n=i, bytes=64)
        bb.request_dump(str(d), "test", incident="inc-1")
        j.close()
        recs = _records(d / "blackbox" / "rank_1.jsonl")
        out.append([{k: v for k, v in r.items() if k not in CLOCK_FIELDS + (
            "t_first", "t_last")} for r in recs])
    assert out[0] == out[1]
    assert [r.get("trigger") for r in out[1] if r["ev"] == "blackbox"] == ["request", "close"]


def test_a_dump_signal_that_names_no_signal_raises():
    with pytest.raises(ValueError, match="names no signal"):
        port_blackbox.arm_process_triggers("NOTASIGNAL")


def test_a_faulthandler_that_cannot_write_raises(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("")
    cfg = port_core.ObsConfig(dir=str(blocker / "sub"), faulthandler=60.0)
    with pytest.raises(OSError):
        port_core.arm_faulthandler(cfg, "t")


class _Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def _registry_snapshots(live):
    clk = _Clock()
    regs = [live.MetricsRegistry(r, clock=clk) for r in range(3)]
    rng = np.random.default_rng(7)
    for step in range(20):
        clk.t = step * 0.5
        for r, reg in enumerate(regs):
            reg.inc(live.M_STEPS, 4)
            reg.inc(live.M_COMPUTE_S, float(rng.uniform(0.1, 0.4)) * (0.05 if r == 1 else 1))
            reg.observe(live.M_EXCHANGE_LAT, float(rng.uniform(1e-4, 1e-2)))
            reg.set_gauge(live.M_ELASTIC_DIST, float(rng.uniform(0, 1)) * (step + 1))
    snaps = {}
    for r, reg in enumerate(regs):
        s = reg.snapshot()
        s.update(seq=20, interval_s=0.1, t=100.0 - (5.0 if r == 2 else 0.0))
        s["uptime_s"] = 10.0
        snaps[r] = s
    return snaps


def _wallclock_free(obj):
    """Snapshots stamp wall-clock ``t`` fields of their own; drop them."""
    if isinstance(obj, dict):
        return {k: _wallclock_free(v) for k, v in obj.items() if k not in ("t", "t0")}
    if isinstance(obj, list):
        return [_wallclock_free(v) for v in obj]
    return obj


def test_live_registry_snapshots_validate_and_aggregate_as_the_reference():
    ref, port = _registry_snapshots(ref_live), _registry_snapshots(port_live)
    ref = {r: {**s, "t": 100.0} for r, s in ref.items()}
    port = {r: {**s, "t": 100.0} for r, s in port.items()}
    assert _wallclock_free(port) == _wallclock_free(ref)
    assert [port_live.validate_snapshot(s) for s in port.values()] == [[], [], []]
    assert port_live.aggregate(port) == ref_live.aggregate(ref)


def test_alert_engine_fires_as_the_reference(tmp_path):
    """A seeded sequence of snapshots (a stale rank, a straggler, a growing
    elastic distance) fires the same alerts in the same order."""
    fired = []
    for name, live, alerts in (("ref", ref_live, ref_alerts), ("port", port_live, port_alerts)):
        snaps = _registry_snapshots(live)
        engine = alerts.AlertEngine(str(tmp_path / f"{name}.jsonl"))
        got = []
        for seq in range(1, 7):
            for r, s in snaps.items():
                s["seq"] = seq
                s["gauges"][live.M_ELASTIC_DIST] = 0.1 * 3 ** seq if r == 0 else 0.1
            got.append(engine.evaluate(snaps, now=100.0))
        fired.append(_wallclock_free(got))
    assert fired[0] == fired[1] and any(fired[1])


@pytest.mark.parametrize("fixture", ["blackbox", "dynamics", "live", "conformance"])
def test_readers_on_the_fixtures_give_the_references_json(fixture):
    """Each of the port's readers gives the reference's JSON on the repo's
    fixtures: the post-mortem, ``aggregate_dynamics``, the live snapshots'
    validation and aggregate, and ``merge``'s Chrome trace."""
    if fixture == "blackbox":
        d = os.path.join(FIXTURES, "blackbox")
        assert port_postmortem.analyze(d) == ref_postmortem.analyze(d) is not None
    elif fixture == "dynamics":
        paths = port_merge.expand_journal_paths([os.path.join(FIXTURES, "dynamics", "good_run")])
        assert paths == ref_merge.expand_journal_paths(
            [os.path.join(FIXTURES, "dynamics", "good_run")])
        assert port_dynamics.aggregate_dynamics(paths) == ref_dynamics.aggregate_dynamics(paths)
        assert port_merge.roofline(paths) == ref_merge.roofline(paths)
        assert port_merge.summarize(paths) == ref_merge.summarize(paths)
    elif fixture == "live":
        d = os.path.join(FIXTURES, "live")
        snaps = port_live.read_snapshots(d)
        assert snaps == ref_live.read_snapshots(d) and snaps
        assert {r: port_live.validate_snapshot(s) for r, s in snaps.items()} == {
            r: ref_live.validate_snapshot(s) for r, s in snaps.items()}
        assert port_live.aggregate(snaps) == ref_live.aggregate(snaps)
    else:
        d = os.path.join(FIXTURES, "conformance", "good_run")
        paths = ref_merge.expand_journal_paths([d])
        assert port_merge.merge_to_chrome_trace(paths) == ref_merge.merge_to_chrome_trace(paths)


CLI_CASES = [
    ("summary", "dynamics/good_run"),
    ("roofline --json", "dynamics/good_run"),
    ("dynamics --json", "dynamics/good_run"),
    ("postmortem --json", "blackbox"),
    ("live --once --json --validate", "live"),
    ("summary --diff", "dynamics/good_run conformance/good_run"),
    ("slo --json", "dynamics/good_run"),
]


@pytest.mark.parametrize("cmd,dirs", CLI_CASES, ids=[c[0].split()[0] + ("-diff" if "diff" in c[0]
                                                                        else "") for c in CLI_CASES])
def test_the_cli_prints_and_exits_as_the_reference(cmd, dirs, capsys):
    argv = cmd.split()[:1] + [os.path.join(FIXTURES, d) for d in dirs.split()] + cmd.split()[1:]
    outs = []
    for main in (ref_cli.main, port_cli.main):
        rc = main(list(argv))
        outs.append((rc, capsys.readouterr().out))
    assert outs[1] == outs[0]


# ---------------------------------------------------------------- the trainers


def _ps_runs(tmp_path):
    """One f32 LeNet ``AsyncPSTrainer`` run in each package (2 clients, 1
    server, in-process broker, 12 steps at τ = 4), obs armed into
    ``tmp_path/<package>``. The counts do not depend on the weights, so
    each package draws its own init."""
    from mpit_tpu.models import LeNet as JaxLeNet
    from mpit_tpu.parallel import AsyncPSTrainer as RefTrainer
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import AsyncPSTrainer

    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (512, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 512).astype(np.int32)
    ref = RefTrainer(JaxLeNet(compute_dtype=jnp.float32), optax.sgd(0.05), transport="inproc",
                     tau=4, obs=ref_core.ObsConfig(dir=str(tmp_path / "ref")))
    _, ref_stats = ref.train(x, y, steps=12, batch_size=32)
    port = AsyncPSTrainer(LeNet(compute_dtype=torch.float32, device=CPU), SGD(0.05),
                          transport="inproc", tau=4, device=CPU,
                          obs=port_core.ObsConfig(dir=str(tmp_path / "port")))
    _, port_stats = port.train(x, y, steps=12, batch_size=32)
    return ref_stats, port_stats


@pytest.fixture(scope="module")
def ps_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("ps_obs")
    return d, _ps_runs(d)


def _counts(summary):
    return {side: {k: (v["msgs"], v["bytes"]) for k, v in summary[side].items()}
            for side in ("send", "recv")}


def test_ps_trainer_runs_count_the_references_messages_and_bytes(ps_runs):
    """Per-(peer, tag) message counts and byte totals of every rank, and
    the set of record kinds each rank journals, are the reference's."""
    d, (ref_stats, port_stats) = ps_runs
    assert [_counts(s) for s in port_stats["telemetry"]] == [
        _counts(s) for s in ref_stats["telemetry"]]
    for r in range(3):
        kinds = [{rec["ev"] for rec in _records(d / pkg / f"obs_rank{r}.jsonl")}
                 for pkg in ("ref", "port")]
        assert kinds[1] == kinds[0], r


@pytest.mark.parametrize("reader", ["merge", "roofline", "dynamics", "postmortem", "summary"])
def test_each_packages_readers_read_the_others_journals(reader, ps_runs):
    """The reference's readers read the port's journals (and the port's
    the reference's) without error, to the same structure."""
    d, _ = ps_runs
    results = {}
    for pkg in ("ref", "port"):
        paths = ref_merge.expand_journal_paths([str(d / pkg)])
        for name, merge, dyn, pm in (("ref", ref_merge, ref_dynamics, ref_postmortem),
                                     ("port", port_merge, port_dynamics, port_postmortem)):
            if reader == "merge":
                got = merge.merge_to_chrome_trace(paths)
                got = sorted({(e.get("ph"), e.get("name")) for e in got["traceEvents"]})
            elif reader == "roofline":
                got = merge.roofline(paths)
                got = {r: (v["role"], v["sends"], v["recvs"], v["exchanges"])
                       for r, v in got["ranks"].items()}
            elif reader == "dynamics":
                got = dyn.aggregate_dynamics(paths)
                got = {c: v["rounds"] for c, v in got["clients"].items()}
            elif reader == "postmortem":
                got = pm.analyze(str(d / pkg))
                got = {r: v["records"] for r, v in got["ranks"].items()}
            else:
                got = {r: (v["sends"], v["recvs"], v["bytes"])
                       for r, v in merge.summarize(paths).items()}
            results[(pkg, name)] = got
    assert results[("port", "ref")] == results[("port", "port")]
    assert results[("ref", "port")] == results[("ref", "ref")]
    assert results[("port", "port")] == results[("ref", "ref")]


# ---------------------------------------------------------------- the sync step, armed


def _sync_runs(topo8, tmp_path, quant, steps=2):
    from mpit_tpu.models import LeNet as JaxLeNet
    from mpit_tpu.parallel import DataParallelTrainer as JaxDP
    from mpit_tpu_torch import optim
    from mpit_tpu_torch.comm.topology import Topology
    from mpit_tpu_torch.convert import from_flax
    from mpit_tpu_torch.models import LeNet
    from mpit_tpu_torch.parallel import DataParallelTrainer

    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (64, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 64).astype(np.int32)
    kw = dict(quant=quant, bucket_bytes=64 << 10)
    jt = JaxDP(JaxLeNet(compute_dtype=jnp.float32), optax.sgd(0.1, momentum=0.9), topo8,
               donate_state=False, obs=ref_core.ObsConfig(dir=str(tmp_path / "ref")), **kw)
    js = jt.init_state(jax.random.key(0), x[:2])
    pt = DataParallelTrainer(LeNet(compute_dtype=torch.float32, device=CPU),
                             optim.SGD(0.1, momentum=0.9),
                             Topology(num_workers=8, device=torch.device(CPU)),
                             obs=port_core.ObsConfig(dir=str(tmp_path / "port")), **kw)
    ps = pt.init_state(params=from_flax(jax.tree.map(np.asarray, js.params), device=CPU))
    for _ in range(steps):
        js, _ = jt.step(js, x, y)
        ps, _ = pt.step(ps, x, y)
    jt.close_obs()
    pt.close_obs()
    return [_records(tmp_path / pkg / "obs_rank0.jsonl") for pkg in ("ref", "port")]


@pytest.mark.parametrize("quant", ["off", "int8", "bf16"])
def test_the_armed_bucketed_step_journals_the_references_records(quant, topo8, tmp_path):
    """The reference's bucketed step and the port's, armed, write the same
    sequence of ``compute``/``send``/``dynamics`` records with the same hop
    bytes, and ``elastic``, ``push_norm`` and ``param_norm`` within 1e-5
    relative (f32, two steps)."""
    ref, port = _sync_runs(topo8, tmp_path, quant)
    shape = lambda recs: [(r["ev"], r.get("name"), r.get("bytes")) for r in recs]  # noqa: E731
    assert shape(port) == shape(ref) and len(ref) > 8
    dyn = [[r for r in recs if r["ev"] == "dynamics"] for recs in (ref, port)]
    assert [d["round"] for d in dyn[1]] == [1, 2]
    for a, b in zip(*dyn):
        assert (b["algo"], b["fetch_delta"]) == (a["algo"], a["fetch_delta"])
        for k in ("elastic", "push_norm", "param_norm", "ratio"):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=0 if a[k] else 1e-12)


# ---------------------------------------------------------------- the PS trainer, armed


def _mnist_small():
    rng = np.random.default_rng(2)
    return (rng.uniform(0, 1, (1024, 28, 28, 1)).astype(np.float32),
            rng.integers(0, 10, 1024).astype(np.int32))


def _port_ps(tmp_path, obs, chaos=None):
    from mpit_tpu_torch.models import MLP
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import AsyncPSTrainer

    return AsyncPSTrainer(MLP(compute_dtype=torch.float32, device=CPU),
                          SGD(0.05, momentum=0.9), tau=4, transport="inproc", chaos=chaos,
                          obs=obs, max_exchange_failures=5, fetch_timeout=1.0,
                          fetch_retries=3, device=CPU)


def test_a_chaos_run_merges_with_cross_rank_traces_and_faults(tmp_path):
    """The reference's acceptance run on the port (``tests/test_obs.py``
    ``TestTrainerIntegration``): 2-client EASGD under seeded chaos with obs
    and the live plane armed. The fault log lands beside the journals and
    the merger places its faults; traces cross ranks; each rank's live
    snapshot carries its injected-fault counts."""
    from mpit_tpu_torch.transport import ChaosConfig

    x, y = _mnist_small()
    chaos = ChaosConfig(seed=11, drop=0.05, corrupt=0.05, truncate=0.05, tags=(1, 2, 4))
    trainer = _port_ps(tmp_path, port_core.ObsConfig(dir=str(tmp_path), live=True,
                                                     live_interval=0.2), chaos)
    _, stats = trainer.train(x, y, steps=24, batch_size=32)
    assert all(np.isfinite(l).all() for l in stats["losses"] if l)
    assert [t["rank"] for t in stats["telemetry"]] == [0, 1, 2]
    faults = tmp_path / "faults.jsonl"
    journals = [str(tmp_path / f"obs_rank{r}.jsonl") for r in range(3)]
    trace = port_merge.merge_to_chrome_trace(journals, str(faults))
    evs = trace["traceEvents"]
    by_rank = port_merge.trace_ids_by_rank(journals)
    cross = [t for t in set().union(*by_rank.values())
             if sum(t in ids for ids in by_rank.values()) >= 2]
    markers = [e for e in evs if e.get("cat") == "chaos"]
    assert cross and markers and all(e["ph"] == "i" for e in markers)
    assert any(e["ph"] == "B" and e["name"] == "exchange" for e in evs)
    for j in journals:
        ts = [r["t"] for r in port_merge.read_journal(j) if "t" in r]
        assert ts == sorted(ts), j
    snaps = port_live.read_snapshots(str(tmp_path / "live"))
    injected = sum(sum(s["collect"]["chaos"].values()) for s in snaps.values())
    assert sorted(snaps) == [0, 1, 2] and injected == len(_records(faults)) > 0


def test_obs_off_adds_no_key_and_writes_nothing(tmp_path, monkeypatch):
    for k in [k for k in os.environ if k.startswith("MPIT_OBS_")]:
        monkeypatch.delenv(k)
    x, y = _mnist_small()
    _, stats = _port_ps(tmp_path, None).train(x, y, steps=8, batch_size=32)
    assert "telemetry" not in stats and os.listdir(tmp_path) == []


def test_a_journal_dir_that_cannot_be_written_raises(tmp_path):
    """A plane that fails to arm raises before any client thread starts;
    it is never swallowed."""
    blocker = tmp_path / "file"
    blocker.write_text("")
    x, y = _mnist_small()
    trainer = _port_ps(tmp_path, port_core.ObsConfig(dir=str(blocker / "obs")))
    with pytest.raises(OSError):
        trainer.train(x, y, steps=8, batch_size=32)
