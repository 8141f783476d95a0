"""The port's runtime sanitizers (RT101-RT104) against the reference's.

``mpit_tpu_torch/analysis/runtime.py`` is a copy of
``mpit_tpu/analysis/runtime.py``. The reference's seeded scenarios
(``tests/test_analysis.py`` RT101/RT102, ``tests/test_threads.py`` RT103,
``tests/test_numerics.py`` RT104) run here once on each package's modules,
from the same lines of this file, and must find the same rule at the same
site: the lock names of a cycle, the tag and rank of a collision, the
structure of a race, the call site of a numerics finding. RT104 also takes
torch tensors on the port, copied to the host only while it is armed.
"""

import os
import re
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

import mpit_tpu.analysis.runtime as ref_rt
import mpit_tpu.parallel.pserver as ref_pserver
import mpit_tpu.quant as ref_quant
import mpit_tpu.transport as ref_transport
import mpit_tpu_torch.analysis.runtime as port_rt
import mpit_tpu_torch.parallel.pserver as port_pserver
import mpit_tpu_torch.quant as port_quant
import mpit_tpu_torch.transport as port_transport

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {
    "ref": types.SimpleNamespace(rt=ref_rt, quant=ref_quant, tp=ref_transport,
                                 ps=ref_pserver),
    "port": types.SimpleNamespace(rt=port_rt, quant=port_quant, tp=port_transport,
                                  ps=port_pserver),
}


def _site(f):
    """What a finding says happened and where, without the parts that
    name a package's own files or an object's id."""
    if f.rule == "RT101":
        return f.message.split(" — ")[0]
    if f.rule == "RT102":
        return re.match(r"tag \d+ on rank \d+", f.message).group(0)
    if f.rule == "RT103":
        head = re.match(r"[a-z-]+ race on \S+", f.message).group(0)
        return re.sub(r"#\d+", "#", head) + f" stacks={f.message.count('File ')}"
    return re.search(r" at (\S+:\d+):", f.message).group(1)


def _both(scenario):
    out = {}
    for name, pkg in PKGS.items():
        findings = scenario(pkg)
        out[name] = [(f.rule, _site(f)) for f in findings]
    assert out["port"] == out["ref"]
    return out["port"]


def _spin_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached")
        time.sleep(0.005)


# ------------------------------------------------------------------ RT101


def _rt101_inversion(pkg):
    with pkg.rt.checking() as checker:
        a, b = pkg.rt.make_lock("A"), pkg.rt.make_lock("B")

        def ab():
            with a:
                with b:
                    pass

        def ba():
            with b:
                with a:
                    pass

        for fn in (ab, ba):
            t = threading.Thread(target=fn)
            t.start()
            t.join()
    return checker.findings


def _rt101_consistent(pkg):
    with pkg.rt.checking() as checker:
        a, b = pkg.rt.make_lock("A"), pkg.rt.make_lock("B")
        for _ in range(3):
            with a:
                with b:
                    pass
            with b:
                pass
    return checker.findings


def test_rt101_finds_the_seeded_inversion_as_the_reference():
    assert _both(_rt101_inversion) == [("RT101", "lock-order cycle (potential deadlock): "
                                                 "A -> B -> A")]


def test_rt101_is_silent_on_a_consistent_order():
    assert _both(_rt101_consistent) == []


def test_locks_are_plain_until_a_checker_is_armed():
    assert not isinstance(port_rt.make_lock("x"), port_rt._TrackedLock)
    assert not isinstance(port_rt.make_condition("x"), port_rt._TrackedCondition)
    with port_rt.checking():
        assert isinstance(port_rt.make_lock("x"), port_rt._TrackedLock)
        assert isinstance(port_rt.make_condition("x"), port_rt._TrackedCondition)


# ------------------------------------------------------------------ RT102


def _rt102_collision(pkg):
    with pkg.rt.checking() as checker:
        broker = pkg.tp.Broker(2)
        t = broker.transports()[0]
        results = []

        def role():
            results.append(t.recv(src=1, tag=7, timeout=10).payload)

        th1, th2 = threading.Thread(target=role), threading.Thread(target=role)
        th1.start()
        _spin_until(lambda: len(checker._waiters) >= 1)
        th2.start()
        _spin_until(lambda: len(checker._waiters) >= 2)
        broker.transports()[1].send(0, 7, "x")
        broker.transports()[1].send(0, 7, "y")
        th1.join(10)
        th2.join(10)
    assert sorted(results) == ["x", "y"]
    return checker.findings


def _rt102_wildcard(pkg):
    with pkg.rt.checking() as checker:
        broker = pkg.tp.Broker(2)
        t = broker.transports()[0]
        th1 = threading.Thread(target=lambda: t.recv(src=pkg.tp.ANY_SOURCE,
                                                     tag=pkg.tp.ANY_TAG, timeout=10))
        th2 = threading.Thread(target=lambda: t.recv(src=1, tag=3, timeout=10))
        th1.start()
        _spin_until(lambda: len(checker._waiters) >= 1)
        th2.start()
        _spin_until(lambda: len(checker._waiters) >= 2)
        src = broker.transports()[1]
        src.send(0, 9, "disp")
        th1.join(10)
        src.send(0, 3, "role")
        th2.join(10)
    return checker.findings


def test_rt102_finds_the_seeded_tag_collision_as_the_reference():
    assert _both(_rt102_collision) == [("RT102", "tag 7 on rank 0")]


def test_rt102_exempts_the_wildcard_dispatcher():
    assert _both(_rt102_wildcard) == []


# ------------------------------------------------------------------ RT103


def _pserver_world(pkg, n_clients):
    broker = pkg.tp.Broker(n_clients + 1)
    tps = broker.transports()
    server = pkg.ps.PServer(tps[0], np.zeros(16, np.float32), num_clients=n_clients,
                            alpha=0.3)
    return server, pkg.ps.spawn_server_thread(server), tps


def _rt103_rogue(pkg):
    with pkg.rt.checking(race=True) as ck:
        server, th, tps = _pserver_world(pkg, 1)

        def rogue():
            for _ in range(100):
                server._note("counts")  # the bug: no server._lock held
                server.counts["heartbeat"] += 1

        rg = threading.Thread(target=rogue, name="rogue-mutator")
        rg.start()
        for _ in range(30):
            tps[1].send(0, pkg.ps.TAG_HEARTBEAT, None)
        rg.join()
        tps[1].send(0, pkg.ps.TAG_STOP, None)
        th.join(timeout=5)
        assert not th.is_alive() and server.error is None
    return [f for f in ck.findings if f.rule == "RT103"][:1]


def _rt103_swarm(pkg):
    n = 8
    with pkg.rt.checking(race=True) as ck:
        server, th, tps = _pserver_world(pkg, n)

        def client(r):
            tp = tps[r]
            for _ in range(5):
                tp.send(0, pkg.ps.TAG_FETCH, None)
                center = tp.recv(src=0, tag=pkg.ps.TAG_PARAM, timeout=10).payload
                tp.send(0, pkg.ps.TAG_PUSH_EASGD, center + 0.01 * r)
                tp.send(0, pkg.ps.TAG_HEARTBEAT, None)
            tp.send(0, pkg.ps.TAG_STOP, None)

        ts = [threading.Thread(target=client, args=(r,)) for r in range(1, n + 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        th.join(timeout=10)
        assert not th.is_alive() and server.error is None
        assert server.counts["push_easgd"] == n * 5
    return [f for f in ck.findings if f.rule == "RT103"]


def _rt103_condition(pkg):
    rt = pkg.rt
    with rt.checking(race=True) as ck:
        cv = rt.make_condition("t.cv")
        box = []

        def producer():
            with cv:
                rt.note("t.box", True)
                box.append(1)
                cv.notify()

        def consumer():
            with cv:
                while not box:
                    cv.wait(5.0)
                rt.note("t.box", False)

        tc = threading.Thread(target=consumer)
        tc.start()
        tp_ = threading.Thread(target=producer)
        tp_.start()
        tc.join(5)
        tp_.join(5)
    return ck.findings


def test_rt103_finds_the_seeded_pserver_race_with_both_stacks():
    (rule, site), = _both(_rt103_rogue)
    assert rule == "RT103" and "race on PServer#.counts" in site
    assert int(site.rsplit("=", 1)[1]) >= 2


def test_rt103_is_silent_on_a_multi_client_swarm():
    assert _both(_rt103_swarm) == []


def test_rt103_orders_a_condition_handoff():
    assert _both(_rt103_condition) == []


# ------------------------------------------------------------------ RT104


def _poisoned(n=8, at=3, value=np.nan):
    a = np.ones(n, np.float32)
    a[at] = value
    return a


def _rt104_clean(pkg):
    with pkg.rt.checking(numerics=True) as ck:
        clean = np.arange(12, dtype=np.float32).reshape(3, 4)
        clean[1] = 0.0  # a legitimate zero-absmax row
        codes, scales = pkg.quant.quantize_rows(clean, "int8")
        pkg.quant.dequantize_rows(codes, scales, "int8")
        pkg.quant.dequantize(pkg.quant.quantize(clean.ravel(), "int8"))
        pkg.quant.quantize(np.zeros(0, np.float32), "int8")
    return ck.findings


def _rt104_nan_once_per_site(pkg):
    with pkg.rt.checking(numerics=True) as ck:
        for _ in range(3):
            pkg.quant.quantize(_poisoned(), "int8")
        pkg.quant.quantize_rows(_poisoned().reshape(2, 4), "int8")
    return ck.findings


def _rt104_bad_dequant_scale(pkg):
    with pkg.rt.checking(numerics=True) as ck:
        pkg.quant.dequantize(pkg.quant.QuantArray("int8", float("inf"),
                                                  np.array([1, 2, 3], np.int8)))
    return ck.findings


def _rt104_zero_absmax(pkg):
    with pkg.rt.checking(numerics=True) as ck:
        ck.on_quantize("quantize_rows", np.zeros((2, 4), np.float32), "int8",
                       np.ones((2, 1), np.float32),
                       np.array([[0, 0, 0, 0], [7, 0, 0, 0]], np.int8))
    return ck.findings


def _rt104_residuals(pkg):
    rt = pkg.rt
    with rt.checking(numerics=True) as ck:
        for _ in range(rt.RuntimeChecker._RESID_WARMUP):
            rt.note_residual_norm("t.ef", 0.5)
        rt.note_residual_norm("t.ef", 0.6)
        rt.note_residual_norm("t.ef", rt.RuntimeChecker.RESIDUAL_GROWTH_BOUND)
        rt.note_residual_norm("t.ef2", float("nan"))
    return ck.findings


def _rt104_server_boundary(pkg):
    with pkg.rt.checking(numerics=True) as ck:
        pkg.rt.note_numeric_array("pserver.apply", np.ones(16, np.float32))
        pkg.rt.note_numeric_array("pserver.apply", _poisoned(16, 5, np.inf))
    return ck.findings


def _rt104_off(pkg):
    with pkg.rt.checking(race=True) as ck:
        pkg.quant.quantize(_poisoned(4, 0), "int8")
        pkg.rt.note_residual_norm("t.off", float("nan"))
        pkg.rt.note_numeric_array("t.off", _poisoned(4, 0))
    return [f for f in ck.findings if f.rule == "RT104"]


RT104_CASES = {
    "clean": (_rt104_clean, 0),
    "nan-once-per-site": (_rt104_nan_once_per_site, 2),
    "bad-dequant-scale": (_rt104_bad_dequant_scale, 1),
    "zero-absmax": (_rt104_zero_absmax, 1),
    "residuals": (_rt104_residuals, 2),
    "server-boundary": (_rt104_server_boundary, 1),
    "off": (_rt104_off, 0),
}


@pytest.mark.parametrize("case", list(RT104_CASES))
def test_rt104_finds_what_the_reference_finds_at_the_same_site(case):
    scenario, n = RT104_CASES[case]
    found = _both(scenario)
    assert len(found) == n and all(rule == "RT104" for rule, _ in found)
    assert all(site.startswith(__file__) for _, site in found)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rt104_reads_a_tensor_by_copying_it_to_the_host(dtype):
    """Armed, a tensor (on the card in a real run, here on the CPU) is
    copied to the host and checked as its array would be."""
    poisoned = torch.ones(16, dtype=dtype)
    poisoned[5] = float("nan")
    with port_rt.checking(numerics=True) as ck:
        port_rt.note_numeric_array("sync.grads", torch.ones(16, dtype=dtype))
        port_rt.note_numeric_array("sync.grads", poisoned)
        ck.on_quantize("quantize_rows_torch", poisoned.reshape(2, 8), "int8",
                       torch.ones(2, 1), torch.zeros(2, 8, dtype=torch.int8))
    assert [f.rule for f in ck.findings] == ["RT104", "RT104"]
    assert "1 non-finite value(s) in sync.grads" in ck.findings[0].message


def test_unarmed_notes_never_touch_a_tensor():
    """With no checker armed a note returns at once: a tensor that cannot
    be read on the host (as a CUDA tensor cannot through numpy) is never
    copied."""

    class Unreadable:
        def detach(self):
            raise AssertionError("copied while unarmed")

        cpu = detach

    port_rt.note_numeric_array("x", Unreadable())
    port_rt.note_residual_norm("x", float("nan"))
    with port_rt.checking(race=True):
        port_rt.note_numeric_array("x", Unreadable())


@pytest.mark.parametrize("knob", ["MPIT_RT_RACE", "MPIT_RT_NUMERICS"])
def test_the_knobs_arm_at_import_and_report_at_exit_as_the_reference(knob):
    outs = []
    for mod in ("mpit_tpu.analysis.runtime", "mpit_tpu_torch.analysis.runtime"):
        env = {k: v for k, v in os.environ.items() if not k.startswith("MPIT_RT_")}
        p = subprocess.run(
            [sys.executable, "-c",
             f"import {mod} as rt; assert rt.active_checker() is not None"],
            capture_output=True, text=True, cwd=REPO, env={**env, knob: "1",
                                                           "JAX_PLATFORMS": "cpu"},
            timeout=120)
        assert p.returncode == 0, p.stderr
        outs.append(re.sub(r"pid \d+", "pid N", p.stderr))
    assert outs[1] == outs[0] and "0 finding(s)" in outs[1]


def test_a_threaded_ps_run_is_clean_under_both_sanitizers():
    """A short thread-mode PS run (2 clients, 1 server, the in-process
    broker) with race and numerics armed finds nothing; one NaN planted
    into the numpy quant face afterwards is exactly one RT104."""
    from mpit_tpu_torch.models import MLP
    from mpit_tpu_torch.optim import SGD
    from mpit_tpu_torch.parallel import AsyncPSTrainer

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (256, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, 256).astype(np.int32)
    with port_rt.checking(race=True, numerics=True) as ck:
        trainer = AsyncPSTrainer(MLP(device="cpu"), SGD(0.1), transport="inproc", tau=4,
                                 device="cpu")
        _, stats = trainer.train(x, y, steps=8, batch_size=32)
        assert stats["server_counts"][0]["push_easgd"] == 4
        assert ck.findings == [], [f.format() for f in ck.findings]
        port_quant.quantize_rows(_poisoned().reshape(2, 4), "int8")
    assert [f.rule for f in ck.findings] == ["RT104"]
