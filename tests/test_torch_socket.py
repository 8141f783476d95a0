"""The port's socket transport against the reference's, over loopback TCP.

A port rank and a reference rank must speak one wire: they negotiate,
exchange framed messages and fall back to pickle with each other as two
ranks of one package do. The PS roles of one package serve the clients of
the other over real sockets, for 1 and 2 servers, in both directions and
in every quantization mode, and end where a same-package world ends. The
reference's FIFO-under-duplication-and-reconnect check runs across the
packages, and pickled markers (the chaos ``CorruptedPayload``, a
``QuantArray``) arrive as the reader's own classes on either side.
"""

import socket

import numpy as np
import pytest

from mpit_tpu.parallel import pclient as ref_pclient
from mpit_tpu.parallel import pserver as ref_pserver
from mpit_tpu.quant import QuantArray as RefQuantArray
from mpit_tpu.transport import chaos as ref_chaos
from mpit_tpu.transport.socket_transport import SocketTransport as RefSocket
from mpit_tpu_torch.parallel import pclient as port_pclient
from mpit_tpu_torch.parallel import pserver as port_pserver
from mpit_tpu_torch.quant import QuantArray
from mpit_tpu_torch.transport import chaos
from mpit_tpu_torch.transport.base import CorruptedPayload
from mpit_tpu_torch.transport.socket_transport import SocketTransport

DIM = 37
WAIT_S = 20
REF = (ref_pserver, ref_pclient, RefSocket)
PORT = (port_pserver, port_pclient, SocketTransport)


def _addrs(n):
    """n free loopback ports (bind 0, read, release)."""
    socks = [socket.socket(socket.AF_INET, socket.SOCK_STREAM) for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [("127.0.0.1", s.getsockname()[1]) for s in socks]
    finally:
        for s in socks:
            s.close()


def _vec(seed, n=DIM):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _client_script(client):
    """A client's exchanges: fetch, EASGD and Downpour pushes, a join."""
    got = [client.fetch()]
    client.push_easgd(_vec(41))
    got.append(client.fetch())
    client.push_delta(_vec(42))
    got.append(client.join())
    client.push_easgd(_vec(43))
    got.append(client.fetch())
    client.stop()
    return got


def _world(server_pkg, client_pkg, num_servers, quant):
    """Servers of one package, a client of the other (or the same), each
    rank on its package's SocketTransport; returns what the run ends
    with and each transport's byte counts."""
    pserver, _, server_socket = server_pkg
    _, pclient, client_socket = client_pkg
    n = num_servers + 1
    addrs = _addrs(n)
    tps = [server_socket(r, n, addresses=addrs, connect_retry_s=WAIT_S)
           for r in range(num_servers)]
    tps.append(client_socket(num_servers, n, addresses=addrs, connect_retry_s=WAIT_S))
    try:
        bounds = pserver.partition_bounds(DIM, num_servers)
        servers = [pserver.PServer(tps[r], _vec(0)[s:e], num_clients=1, alpha=0.5,
                                   server_lr=0.5, client_ranks=[num_servers], quant=quant)
                   for r, (s, e) in enumerate(bounds)]
        threads = [pserver.spawn_server_thread(s) for s in servers]
        client = pclient.PClient(tps[num_servers], list(range(num_servers)), DIM,
                                 timeout=WAIT_S, quant=quant)
        fetched = _client_script(client)
        for t in threads:
            t.join(timeout=WAIT_S)
            assert not t.is_alive()
        assert all(s.error is None for s in servers)
        result = (np.concatenate([s.snapshot() for s in servers]).tobytes(),
                  [s.counts for s in servers], [s.version for s in servers],
                  [s.staleness_by_src for s in servers], [f.tobytes() for f in fetched],
                  dict(client.push_sent), client.server_version)
        return result, [t.wire_byte_counts() for t in tps]
    finally:
        for t in tps:
            t.close()


@pytest.mark.parametrize("quant", ["off", "bf16", "int8"])
@pytest.mark.parametrize("num_servers", [1, 2])
@pytest.mark.parametrize("server,client", [("ref", "port"), ("port", "ref")])
def test_ps_roles_interoperate_over_sockets(server, client, num_servers, quant):
    """A port PClient against reference PServers over real sockets, and
    the reverse: the same centers, fetches and counts as the server's own
    package's client, every frame framed (no corruption dropped)."""
    srv = REF if server == "ref" else PORT
    other = PORT if client == "port" else REF
    got, got_bytes = _world(srv, other, num_servers, quant)
    want, _ = _world(srv, srv, num_servers, quant)
    assert got == want
    assert all(b["tx"] > 0 and b["rx"] > 0 and b["rx_corrupt_dropped"] == 0
               for b in got_bytes)


@pytest.mark.parametrize("sender", ["port", "ref"])
def test_fifo_under_duplication_and_reconnect_across_packages(sender):
    """The reference's check (tests/test_chaos.py:148) with the sender of
    one package and the receiver of the other: per-(src, tag) order holds
    across a duplicated stream and a broken cached connection, and nothing
    is lost. The receiver's accept-order fence drops, by design, frames
    still unread on a connection older than one it has heard from, so the
    receiver reads the first half before the sender breaks its socket."""
    addrs = _addrs(2)
    tx_cls, rx_cls, pkg = ((SocketTransport, RefSocket, chaos) if sender == "port"
                           else (RefSocket, SocketTransport, ref_chaos))
    rx = rx_cls(0, 2, addresses=addrs, connect_retry_s=WAIT_S)
    tx = tx_cls(1, 2, addresses=addrs, connect_retry_s=WAIT_S)
    wrapped = pkg.ChaosTransport(tx, pkg.ChaosConfig(seed=7, duplicate=0.5))
    try:
        order = []
        for i in range(30):
            wrapped.send(0, 7, i)
            if i == 14:  # break the cached socket: evict + reconnect
                ndup = wrapped.log.counts().get("duplicate", 0)
                order += [rx.recv(1, 7, timeout=WAIT_S).payload for _ in range(15 + ndup)]
                tx._out[0].close()
        ndup = wrapped.log.counts().get("duplicate", 0)
        assert ndup > 0
        order += [rx.recv(1, 7, timeout=WAIT_S).payload
                  for _ in range(30 + ndup - len(order))]
        assert order == sorted(order)
        assert sorted(set(order)) == list(range(30))
    finally:
        wrapped.close()
        rx.close()


@pytest.mark.parametrize("wire_format", ["framed", "pickle"])
@pytest.mark.parametrize("sender", ["port", "ref"])
def test_markers_arrive_as_the_readers_own_classes(sender, wire_format):
    """A chaos ``corrupt`` fault and a quantized chunk, sent by one
    package: the ``CorruptedPayload`` marker can only be pickled, the
    chunk is framed or (``wire_format="pickle"``) pickled; the receiver of
    the other package gets its own classes with the same fields."""
    addrs = _addrs(2)
    tx_cls, rx_cls, pkg, q_cls = (
        (SocketTransport, RefSocket, chaos, QuantArray) if sender == "port"
        else (RefSocket, SocketTransport, ref_chaos, RefQuantArray))
    want_corrupt, want_quant = ((ref_chaos.CorruptedPayload, RefQuantArray) if sender == "port"
                                else (CorruptedPayload, QuantArray))
    rx = rx_cls(0, 2, addresses=addrs, connect_retry_s=WAIT_S)
    tx = tx_cls(1, 2, addresses=addrs, connect_retry_s=WAIT_S, wire_format=wire_format)
    wrapped = pkg.ChaosTransport(tx, pkg.ChaosConfig(scripted={(1, 0, 4, 0): "corrupt"}))
    try:
        wrapped.send(0, 4, (9, np.ones(3, np.float32)))
        wrapped.send(0, 5, (9, 2, q_cls("int8", 0.25, np.arange(4, dtype=np.int8))))
        corrupt = rx.recv(1, 4, timeout=WAIT_S).payload
        quant = rx.recv(1, 5, timeout=WAIT_S).payload
    finally:
        wrapped.close()
        rx.close()
    assert type(corrupt) is want_corrupt
    assert (corrupt.src, corrupt.dst, corrupt.tag, corrupt.n) == (1, 0, 4, 0)
    assert quant[:2] == (9, 2) and type(quant[2]) is want_quant
    assert quant[2].mode == "int8" and quant[2].scale == 0.25
    np.testing.assert_array_equal(quant[2].data, np.arange(4, dtype=np.int8))


@pytest.mark.parametrize("negotiating", ["port", "ref"])
def test_a_peer_without_negotiation_gets_pickles(negotiating, monkeypatch):
    """``MPIT_WIRE_NEGOTIATE=0`` on one side: that side behaves like a
    pickle-only peer, and a rank of the other package still reaches it."""
    addrs = _addrs(2)
    legacy_cls, new_cls = ((RefSocket, SocketTransport) if negotiating == "port"
                           else (SocketTransport, RefSocket))
    monkeypatch.setenv("MPIT_WIRE_NEGOTIATE", "0")
    rx = legacy_cls(0, 2, addresses=addrs, connect_retry_s=WAIT_S)
    monkeypatch.delenv("MPIT_WIRE_NEGOTIATE")
    monkeypatch.setenv("MPIT_WIRE_NEGOTIATE_TIMEOUT_S", "0.3")
    tx = new_cls(1, 2, addresses=addrs, connect_retry_s=WAIT_S)
    try:
        tx.send(0, 3, (1, np.arange(5, dtype=np.float32)))
        got = rx.recv(1, 3, timeout=WAIT_S).payload
        assert tx._peer_framed[0] is False
    finally:
        tx.close()
        rx.close()
    assert got[0] == 1
    np.testing.assert_array_equal(got[1], np.arange(5, dtype=np.float32))
