"""The port's fault injector against the reference's.

``mpit_tpu_torch/transport/chaos.py`` is a copy of the reference's: for
the same seed and the same sends it must make the same decisions, event
for event. Each package's ``ChaosTransport`` wraps its own in-process
broker; one fixed send script runs through both, and the fault logs and
the delivered payloads are held equal, with the config given as an
argument and as ``MPIT_CHAOS_*`` knobs. The trainer under the
reference's acceptance schedule applies every push exactly once and
replays its fault log.
"""

import struct

import numpy as np
import pytest
import torch

from mpit_tpu.quant import QuantArray as RefQuantArray
from mpit_tpu.transport import Broker as RefBroker
from mpit_tpu.transport import RecvTimeout as RefRecvTimeout
from mpit_tpu.transport import chaos as ref_chaos
from mpit_tpu_torch.data import load_mnist
from mpit_tpu_torch.models import MLP
from mpit_tpu_torch.optim import SGD
from mpit_tpu_torch.parallel import AsyncPSTrainer
from mpit_tpu_torch.parallel.pserver import TAG_FETCH, TAG_PARAM, TAG_PUSH_EASGD
from mpit_tpu_torch.quant import QuantArray
from mpit_tpu_torch.transport import Broker, RecvTimeout, chaos
from mpit_tpu_torch.transport.base import CorruptedPayload

ALL_KINDS = dict(drop=0.1, duplicate=0.15, delay=0.1, delay_s=0.0005, reset=0.08,
                 blackhole=0.02, blackhole_len=3, corrupt=0.07, truncate=0.07,
                 jitter_s=0.0002, slow_ranks=(2,))
ENV = {"MPIT_CHAOS_DROP": "0.1", "MPIT_CHAOS_DUP": "0.15", "MPIT_CHAOS_DELAY": "0.1",
       "MPIT_CHAOS_DELAY_S": "0.0005", "MPIT_CHAOS_RESET": "0.08",
       "MPIT_CHAOS_BLACKHOLE": "0.02", "MPIT_CHAOS_BLACKHOLE_LEN": "3",
       "MPIT_CHAOS_CORRUPT": "0.07", "MPIT_CHAOS_TRUNCATE": "0.07",
       "MPIT_CHAOS_TAGS": "1,2,3,4", "MPIT_CHAOS_DUP_TAGS": "2,3",
       "MPIT_CHAOS_KILL_RANK": "2", "MPIT_CHAOS_KILL_AFTER": "40"}


def _plain(v):
    if isinstance(v, (QuantArray, RefQuantArray)):
        return ("quant", v.mode, struct.pack("!f", v.scale), _plain(v.data))
    if isinstance(v, CorruptedPayload) or type(v).__name__ == "CorruptedPayload":
        return ("corrupt", v.src, v.dst, v.tag, v.n)
    if isinstance(v, np.ndarray):
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, (tuple, list)):
        return (type(v).__name__, [_plain(x) for x in v])
    return (type(v).__name__, v)


def _payload(i, quant_cls):
    """The send script's i-th payload: envelopes with arrays and quantized
    chunks, bare arrays and scalars (so truncate both cuts and degrades)."""
    arr = np.arange(i % 7 + 1, dtype=np.float32) * (i + 1)
    kind = i % 4
    if kind == 0:
        return (i, 3, arr)
    if kind == 1:
        return (i, quant_cls("int8", 0.25, np.arange(i % 5 + 2, dtype=np.int8)))
    if kind == 2:
        return arr
    return i


def _run_script(pkg, config, quant_cls):
    """Ranks 0..2 send 150 messages in a fixed order over their package's
    broker, wrapped in its ChaosTransport; returns the fault log and
    what each rank received, in order."""
    broker = RefBroker(3) if pkg is ref_chaos else Broker(3)
    inner = broker.transports()
    wrapped, log = pkg.wrap_transports(inner, config)
    resets = []
    for i in range(150):
        src, dst, tag = i % 3, (i + 1 + i // 3) % 3, 1 + i % 4
        try:
            wrapped[src].send(dst, tag, _payload(i, quant_cls))
        except ConnectionError as e:
            resets.append((i, str(e)))
    received = []
    for r in range(3):
        got = []
        while True:
            try:
                m = inner[r].recv(timeout=0)
            except (RecvTimeout, RefRecvTimeout):
                break
            got.append((m.src, m.tag, _plain(m.payload)))
        received.append(got)
    events = [(e.kind, e.src, e.dst, e.tag, e.n) for e in log.events()]
    return events, received, resets, log.counts()


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("source", ["argument", "env"])
def test_the_same_seed_gives_the_same_faults_and_deliveries(seed, source):
    if source == "argument":
        kw = dict(ALL_KINDS, seed=seed, kill_after={2: 40}, duplicate_tags=(2, 3),
                  tags=(1, 2, 3, 4))
        ref_cfg, port_cfg = ref_chaos.ChaosConfig(**kw), chaos.ChaosConfig(**kw)
    else:
        env = dict(ENV, MPIT_CHAOS_SEED=str(seed), MPIT_CHAOS_JITTER_S="0.0002",
                   MPIT_CHAOS_SLOW_RANKS="2")
        ref_cfg, port_cfg = ref_chaos.config_from_env(env), chaos.config_from_env(env)
        assert ref_cfg is not None and port_cfg is not None
    want = _run_script(ref_chaos, ref_cfg, RefQuantArray)
    got = _run_script(chaos, port_cfg, QuantArray)
    assert got == want
    events, received, resets, counts = got
    for kind in ("drop", "duplicate", "reset", "corrupt", "truncate", "kill", "jitter"):
        assert counts.get(kind, 0) > 0, counts
    assert sum(len(r) for r in received) > 0


def test_config_from_env_reads_every_knob_as_the_reference_does():
    import dataclasses

    for env in ({}, {"OTHER": "1"}, {"MPIT_CHAOS_SOAK_OFFSET": "2"},
                dict(ENV, MPIT_CHAOS_SEED="5", MPIT_CHAOS_SLOW_RANKS="1,2",
                     MPIT_CHAOS_JITTER_S="0.5", MPIT_CHAOS_DROP_TAGS="1",
                     MPIT_CHAOS_DELAY_TAGS="4", MPIT_CHAOS_RESET_TAGS="2",
                     MPIT_CHAOS_BLACKHOLE_TAGS="3", MPIT_CHAOS_CORRUPT_TAGS="1,2",
                     MPIT_CHAOS_TRUNCATE_TAGS="4")):
        ref, port = ref_chaos.config_from_env(env), chaos.config_from_env(env)
        if ref is None:
            assert port is None
        else:
            assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_scripted_faults_and_the_mix_hash_match():
    assert [chaos._mix(*v) for v in [(), (0,), (1, 2, 3), (-1, 2**70, 5)]] == [
        ref_chaos._mix(*v) for v in [(), (0,), (1, 2, 3), (-1, 2**70, 5)]]
    scripted = {(0, 1, 2, 0): "drop", (0, 1, 2, 1): "duplicate", (0, 1, 2, 2): "corrupt",
                (0, 1, 2, 3): "truncate", (0, 1, 2, 4): "reset"}
    want = _run_script(ref_chaos, ref_chaos.ChaosConfig(scripted=scripted), RefQuantArray)
    got = _run_script(chaos, chaos.ChaosConfig(scripted=scripted), QuantArray)
    assert got == want
    assert list(chaos.iter_fault_lines([chaos.FaultEvent("drop", 0, 1, 2, 3)])) == list(
        ref_chaos.iter_fault_lines([ref_chaos.FaultEvent("drop", 0, 1, 2, 3)]))


def test_duplication_preserves_fifo():
    tps = Broker(2).transports()
    wrapped = chaos.ChaosTransport(tps[0], chaos.ChaosConfig(seed=0, duplicate=1.0))
    for i in range(20):
        wrapped.send(1, 3, i)
    got = [tps[1].recv(0, 3, timeout=1).payload for _ in range(40)]
    assert got == [i // 2 for i in range(40)]


# the reference's acceptance schedule (tests/test_chaos.py:337-344)
ACCEPT = dict(drop=0.06, drop_tags=(TAG_FETCH, TAG_PARAM), duplicate=0.12, reset=0.08,
              reset_tags=(TAG_FETCH, TAG_PUSH_EASGD),
              tags=(TAG_FETCH, TAG_PARAM, TAG_PUSH_EASGD))


def _trainer(cfg, transport="inproc"):
    return AsyncPSTrainer(MLP(compute_dtype=torch.float32, device="cpu"),
                          SGD(0.05, 0.9), num_clients=2, num_servers=1, alpha=0.5,
                          tau=4, transport=transport, chaos=cfg, max_exchange_failures=5,
                          fetch_timeout=1.0, fetch_retries=3, device="cpu")


def _assert_exactly_once(stats):
    for s, counts in enumerate(stats["server_counts"]):
        sent = sum(per_client.get(s, 0) for per_client in stats["push_sent"])
        assert counts["push_easgd"] == sent, (counts, stats["push_sent"])


@pytest.fixture(scope="module")
def data():
    return load_mnist(synthetic_train=2048, synthetic_test=512)


def test_trainer_under_the_seeded_schedule_is_exactly_once_and_replays(data):
    x, y, *_ = data

    def one_run():
        trainer = _trainer(chaos.ChaosConfig(seed=1234, **ACCEPT))
        _, stats = trainer.train(x, y, steps=24, batch_size=32)
        return stats, trainer.fault_log

    stats, log = one_run()
    assert all(np.isfinite(l).all() for l in stats["losses"] if l)
    _assert_exactly_once(stats)
    for kind in ("drop", "duplicate", "reset"):
        assert stats["chaos_faults"].get(kind, 0) > 0, stats["chaos_faults"]
    stats2, log2 = one_run()
    assert log.events() == log2.events()
    _assert_exactly_once(stats2)


def test_env_knobs_activate_chaos_in_the_trainer(data, monkeypatch):
    x, y, *_ = data
    monkeypatch.setenv("MPIT_CHAOS_SEED", "77")
    monkeypatch.setenv("MPIT_CHAOS_DUP", "0.3")
    monkeypatch.setenv("MPIT_CHAOS_TAGS", f"{TAG_PUSH_EASGD}")
    trainer = _trainer(None)
    _, stats = trainer.train(x, y, steps=16, batch_size=32)
    assert trainer.fault_log is not None
    assert stats["chaos_faults"].get("duplicate", 0) > 0
    _assert_exactly_once(stats)
    assert stats["server_counts"][0]["dup_dropped"] == stats["chaos_faults"]["duplicate"]
