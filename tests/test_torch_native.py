"""The port's native C++ broker, held to the reference's tests.

``mpit_tpu_torch/native`` is a copy of ``mpit_tpu/native`` (its own copy of
``tagged_broker.cpp``, built with the host C++ compiler into
``build/mpit_tpu_torch/``). The cases of ``tests/test_native.py`` run here
against the port's broker, unchanged but for the imports: the Transport
contract, GIL-free blocking and safe shutdown. A 1-client PS run on it
ends bit-equal to the same run on the Python broker, and
``transport="auto"`` picks it wherever it builds, as in the reference."""

import threading
import time

import numpy as np
import pytest

import torch

import mpit_tpu_torch.native as native
from mpit_tpu_torch.data import load_mnist
from mpit_tpu_torch.models import MLP
from mpit_tpu_torch.optim import SGD
from mpit_tpu_torch.parallel import AsyncPSTrainer
from mpit_tpu_torch.transport import ANY_SOURCE, ANY_TAG, RecvTimeout


@pytest.fixture
def b3():
    broker = native.NativeBroker(3)
    yield broker
    broker.close()


class TestNativeBrokerParity:
    def test_send_recv_roundtrip(self, b3):
        tps = b3.transports()
        payload = np.arange(5.0)
        tps[0].send(1, tag=7, payload=payload)
        msg = tps[1].recv(src=0, tag=7, timeout=1)
        np.testing.assert_array_equal(msg.payload, payload)
        assert msg.src == 0 and msg.tag == 7 and msg.dst == 1

    def test_per_src_tag_fifo_order(self, b3):
        tps = b3.transports()
        for i in range(50):
            tps[0].send(1, tag=3, payload=i)
        got = [tps[1].recv(0, 3, timeout=1).payload for _ in range(50)]
        assert got == list(range(50))

    def test_any_source_any_tag(self, b3):
        tps = b3.transports()
        tps[0].send(2, tag=1, payload="from0")
        tps[1].send(2, tag=9, payload="from1")
        first = tps[2].recv(ANY_SOURCE, ANY_TAG, timeout=1)
        second = tps[2].recv(ANY_SOURCE, ANY_TAG, timeout=1)
        assert {first.payload, second.payload} == {"from0", "from1"}

    def test_tag_selective_recv_leaves_others_queued(self, b3):
        tps = b3.transports()
        tps[0].send(1, tag=1, payload="a")
        tps[0].send(1, tag=2, payload="b")
        assert tps[1].recv(ANY_SOURCE, 2, timeout=1).payload == "b"
        assert tps[1].recv(ANY_SOURCE, 1, timeout=1).payload == "a"

    def test_probe(self, b3):
        tps = b3.transports()
        assert not tps[1].probe()
        tps[0].send(1, tag=4, payload=None)
        assert tps[1].probe(src=0, tag=4)
        assert not tps[1].probe(src=0, tag=5)

    def test_recv_timeout_raises(self, b3):
        with pytest.raises(RecvTimeout):
            b3.transports()[1].recv(timeout=0.05)

    def test_blocking_recv_wakes_on_send(self, b3):
        tps = b3.transports()
        out = {}

        def receiver():
            out["msg"] = tps[1].recv(timeout=5)

        t = threading.Thread(target=receiver)
        t.start()
        time.sleep(0.05)
        tps[0].send(1, tag=0, payload="wake")
        t.join(timeout=5)
        assert out["msg"].payload == "wake"

    def test_isend_irecv_wait(self, b3):
        tps = b3.transports()
        h = tps[0].isend(1, tag=1, payload=123)
        h.wait(timeout=1)
        r = tps[1].irecv(src=0, tag=1)
        assert r.wait(timeout=1).payload == 123

    def test_bad_dst_raises(self, b3):
        with pytest.raises(ValueError, match="out of range"):
            b3.transports()[0].send(5, tag=0, payload=None)

    def test_none_payload(self, b3):
        tps = b3.transports()
        tps[0].send(1, tag=2, payload=None)
        assert tps[1].recv(0, 2, timeout=1).payload is None

    def test_large_payload(self, b3):
        tps = b3.transports()
        payload = np.random.default_rng(0).random(1_000_000)
        tps[0].send(1, tag=1, payload=payload)
        np.testing.assert_array_equal(
            tps[1].recv(0, 1, timeout=5).payload, payload
        )


class TestNativeConcurrency:
    def test_selective_recvs_dont_steal(self, b3):
        """Two receivers blocked on different tags; a send must wake the
        matching one only (the C side uses notify_all + per-filter match)."""
        tps = b3.transports()
        out = {}

        def rx(tag):
            out[tag] = tps[2].recv(ANY_SOURCE, tag, timeout=5).payload

        t1 = threading.Thread(target=rx, args=(1,))
        t2 = threading.Thread(target=rx, args=(2,))
        t1.start(), t2.start()
        time.sleep(0.05)
        tps[0].send(2, tag=2, payload="two")
        tps[0].send(2, tag=1, payload="one")
        t1.join(5), t2.join(5)
        assert out == {1: "one", 2: "two"}

    def test_blocking_recv_releases_gil(self, b3):
        """A thread parked in native recv must not stall Python threads —
        the whole point of the C++ broker (ctypes drops the GIL)."""
        tps = b3.transports()
        done = threading.Event()

        def blocked():
            try:
                tps[1].recv(timeout=2)
            except RecvTimeout:
                pass
            done.set()

        t = threading.Thread(target=blocked)
        t.start()
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < 0.3:
            n += 1  # pure-Python progress while the other thread blocks
        assert n > 10_000  # would be ~0 if recv held the GIL
        tps[0].send(1, tag=0, payload="unblock")
        t.join(5)
        assert done.is_set()


class TestNativeShutdown:
    def test_close_with_blocked_receiver_is_safe(self):
        """close() while a thread is parked in recv must wake it with an
        error — not delete the condvar under the waiter (use-after-free
        regression)."""
        broker = native.NativeBroker(2)
        tps = broker.transports()
        outcome = {}

        def blocked():
            try:
                tps[1].recv(timeout=30)
                outcome["r"] = "message"
            except RuntimeError as e:
                outcome["r"] = str(e)
            except RecvTimeout:
                outcome["r"] = "timeout"

        t = threading.Thread(target=blocked)
        t.start()
        time.sleep(0.1)
        broker.close()
        t.join(timeout=5)
        assert not t.is_alive()
        assert "closed" in outcome["r"]

    def test_send_after_close_raises(self):
        broker = native.NativeBroker(2)
        tps = broker.transports()
        broker.close()
        with pytest.raises(RuntimeError):
            tps[0].send(1, tag=0, payload="x")


class TestNativePSTrainer:
    def _train(self, transport):
        x, y, xt, yt = load_mnist(synthetic_train=512, synthetic_test=128)
        tr = AsyncPSTrainer(
            MLP(hidden=(16,), compute_dtype=torch.float32, device="cpu"),
            SGD(0.1), num_clients=1, num_servers=2, tau=4, transport=transport,
            device="cpu",
        )
        center, stats = tr.train(x, y, steps=16, batch_size=32)
        return tr, center, stats, tr.evaluate(center, xt, yt)

    def test_one_client_run_on_native_equals_inproc_bit_for_bit(self):
        tr, center, stats, acc = self._train("native")
        assert tr.transport_used == "native"
        assert stats["server_counts"][0]["push_easgd"] == 16 // 4
        _, want, want_stats, want_acc = self._train("inproc")
        for k in center:
            for leaf in center[k]:
                assert torch.equal(center[k][leaf], want[k][leaf])
        assert stats["losses"] == want_stats["losses"] and acc == want_acc

    def test_auto_takes_the_native_broker_where_it_builds(self):
        tr = AsyncPSTrainer(MLP(hidden=(16,), device="cpu"), SGD(0.1), device="cpu")
        tr._make_broker(2).close()
        assert tr.transport_used == "native"


def test_native_blocking_probe(b3):
    """C-side probe_wait: parks off-GIL until a match arrives, without
    consuming it; times out to False."""
    import threading
    import time

    tps = b3.transports()
    assert tps[1].probe(timeout=0.05) is False

    def later():
        time.sleep(0.15)
        tps[0].send(1, tag=5, payload=b"x")

    threading.Thread(target=later, daemon=True).start()
    t0 = time.monotonic()
    assert tps[1].probe(src=0, tag=5, timeout=5) is True
    assert time.monotonic() - t0 < 4
    assert tps[1].recv(0, 5, timeout=1).payload == b"x"
